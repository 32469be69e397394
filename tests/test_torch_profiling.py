"""The port's profiling hooks (`utils/profiling.py`, torch.profiler) on the
CPU: `profile_call` returns its wall seconds and the trace files it wrote,
a span opened by `annotate` appears in the trace by name, `trace` writes a
Chrome trace, and `phase_timer` fills its key."""

import json
import os

import torch

from ba_pathtracing_fur_torch.utils import profiling

torch.set_num_threads(2)


def _work(n=64):
    with profiling.annotate("fur_span"):
        a = torch.rand(n, n)
        return (a @ a).sum()


def test_profile_call_returns_wall_seconds_and_trace_files(tmp_path):
    logdir = str(tmp_path / "prof")
    calls = []
    res = profiling.profile_call(lambda n: calls.append(n) or _work(n), 32, logdir=logdir)
    assert calls == [32, 32]  # the warm-up call, then the traced one
    assert res["logdir"] == logdir and res["wall_s"] >= 0.0
    assert len(res["files"]) == 1 and res["files"][0]["file"].endswith(".json")
    assert res["files"][0]["bytes"] == os.path.getsize(os.path.join(logdir,
                                                                   res["files"][0]["file"]))
    cold = profiling.profile_call(_work, logdir=str(tmp_path / "cold"), warm=False)
    assert len(cold["files"]) == 1


def test_annotate_names_a_span_in_the_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        _work()
    assert any(e.key == "fur_span" for e in prof.key_averages())
    (path,) = logdir.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "fur_span" for e in events)


def test_phase_timer_fills_its_key():
    stats = {}
    with profiling.phase_timer(stats, "build"):
        _work()
    assert set(stats) == {"build"} and stats["build"] >= 0.0
    try:
        with profiling.phase_timer(stats, "failed"):
            raise RuntimeError("inside the phase")
    except RuntimeError:
        pass
    assert "failed" in stats
