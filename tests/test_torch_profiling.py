"""The port's tracing (`utils/profiling.py`) on the CPU: `trace` writes a
Chrome trace; a span is a named `bapt.*` span in it and a record in the log
only while a profiler records; counters sum when read; the render's spans
nest pass > bounce > stage on the fused, joint and unfused paths, in the
trace and in the log; `live` and `shadow_live` equal recounts from the
render's own state; with no profiler the log stays empty, nothing is
recorded or counted, and the image is bit-identical to a traced one."""

import json

import pytest
import torch

from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
from ba_pathtracing_fur_torch.scene import builtins
from ba_pathtracing_fur_torch.utils import profiling

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _empty_log():
    profiling.clear()
    yield
    profiling.clear()


def _work(n=64):
    with profiling.span("fur_span"):
        a = torch.rand(n, n)
        return (a @ a).sum()


def _events(logdir):
    (path,) = logdir.iterdir()
    return json.loads(path.read_text())["traceEvents"]


def test_span_names_a_span_in_the_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        _work()
    assert any(e.key == "bapt.fur_span" for e in prof.key_averages())
    assert any(e.get("name") == "bapt.fur_span" for e in _events(logdir))
    (rec,) = profiling.spans()
    assert rec.name == "fur_span" and rec.parent is None and rec.index == 0
    assert rec.t1 >= rec.t0 and rec.host_ms() >= 0.0


def test_a_cpu_span_carries_no_events(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", pass_index=3):
            with profiling.span("inner", bounce=1) as inner:
                pass
    outer, rec = profiling.spans()
    assert rec is inner and rec.parent == outer.index == 0
    assert (rec.pass_index, rec.bounce) == (3, 1)  # the pass index inherited
    for r in (outer, rec):
        assert r.events is None and r.device_ms() is None


def test_counters_sum_when_read_and_only_while_on(tmp_path):
    profiling.count("n", 5)  # off: nowhere to go
    with profiling.trace(str(tmp_path)):
        profiling.count("n", 7)  # on, but no span is open
        with profiling.span("outer"):
            profiling.count("n", 2)
            profiling.count("n", torch.tensor([1, 2, 3]))
            profiling.count_nonzero("nz", torch.tensor([0.0, 2.0, float("inf"), 0.0]))
            with profiling.span("inner"):
                profiling.count("n", 100)  # the innermost span's
    outer, inner = profiling.spans()
    assert outer.count("n") == 8 and outer.count("nz") == 2 and outer.count("x") is None
    assert inner.count("n") == 100


def test_the_log_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.trace(str(tmp_path)):
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3 and profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_off_a_span_is_one_shared_no_op(monkeypatch):
    assert profiling.span("a") is profiling.span("b", pass_index=1, bounce=2) is profiling._OFF
    monkeypatch.setattr(profiling, "_Open", None)  # never reached while off
    with profiling.span("a"):
        profiling.count("n", 1)
        profiling.count_nonzero("n", torch.ones(3))
    assert profiling.spans() == []


def _ball(n_fibers=300):
    """A tiny hair ball on the streaming kernel's two-level BVH (K3), its
    scalp on K5 (threshold patched down by the callers that need it)."""
    scene, cam = builtins.hair_ball(resolution=(8, 8), n_fibers=n_fibers, device=CPU)
    scene = traverse.attach_bvh(scene, leaf_size=16, fanout=8)
    assert traverse._two_level(scene.cone_bvh) and scene.tri_bvh is None
    return scene, cam


def _render(scene, cam, cfg, seed=3):
    return [acc.clone() for _, acc in pt.render_progressive(scene, cam, rng.key(seed, CPU), cfg)]


PATHS = {
    "fused": dict(fused_shading=True, compact=False),
    "joint": dict(fused_shading=True, joint_shadows=True, compact=False),
    "unfused_compact": dict(fused_shading=False, compact=True),
}
#: the stages each path's bounce holds in the log (K5 on the scalp)
STAGES = {
    "fused": ["sort", "k5", "k3", "hit", "shade", "sort", "k5", "k3", "nee"],
    "joint": ["sort", "k3", "k5", "k5", "hit", "nee", "shade"],
    "unfused_compact": ["sort", "k5", "k3", "hit", "sort", "k5", "k3"],
}
#: the joint path traces its last shadow rays after the bounce loop
AFTER_LOOP = {"joint": ["sort", "k5", "k3", "nee"]}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_traced_pass_nests_its_stages(path, tmp_path, monkeypatch):
    """pass > bounce > sort / k3 / hit in the Chrome trace (by time) and in
    the log (by parent), with the pass ids and bounces carried down; camera
    and mean under the pass."""
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)
    scene, cam = _ball()
    cfg = pt.RenderConfig(depth=2, spp=2, **PATHS[path])
    with profiling.trace(str(tmp_path)):
        _render(scene, cam, cfg)

    ev = [(e["name"][5:], e["ts"], e["ts"] + e["dur"]) for e in _events(tmp_path)
          if e.get("ph") == "X" and e["name"].startswith("bapt.")]

    def within(name, outer):
        return [x for x in ev if x[0] == name and outer[1] <= x[1] and x[2] <= outer[2]]

    passes = [x for x in ev if x[0] == "pass"]
    assert len(passes) == 2
    for p in passes:
        bounces = within("bounce", p)
        assert len(bounces) == 2 and len(within("camera", p)) == len(within("mean", p)) == 1
        for b in bounces:
            assert all(within(stage, b) for stage in ("sort", "k3", "hit"))

    log = profiling.spans()
    heads = [s for s in log if s.name == "pass"]
    assert [h.pass_index for h in heads] == [0, 1]
    for h in heads:
        top = [s for s in log if s.parent == h.index]
        assert [s.name for s in top] == ["camera", "bounce", "bounce",
                                         *AFTER_LOOP.get(path, []), "mean"]
        for b, bounce in enumerate(s for s in top if s.name == "bounce"):
            assert bounce.bounce == b and bounce.count("rays") == 64
            inner = [s for s in log if s.parent == bounce.index]
            assert [s.name for s in inner] == STAGES[path]
            assert all((s.pass_index, s.bounce) == (h.pass_index, b) for s in inner)
    assert all(s.events is None for s in log)  # the CPU


def test_live_and_shadow_live_equal_recounts(tmp_path, monkeypatch):
    """Each bounce's `live` equals the live lanes recounted from the state
    the bounce starts from, and `shadow_live` the shade stage's shadow rays
    with t_max > 0, recounted from its output."""
    scene, cam = _ball()
    cfg = pt.RenderConfig(depth=3, spp=1, fused_shading=True, compact=False)
    shadow = []
    shade = cshade.shade_bounce

    def recording(**kw):
        out = shade(**kw)
        shadow.append(int((out["shadow_tmax"] > 0.0).sum()))
        return out

    monkeypatch.setattr(cshade, "shade_bounce", recording)
    with profiling.trace(str(tmp_path)):
        _render(scene, cam, cfg)
    counted = [(s.count("live"), s.count("shadow_live")) for s in profiling.spans()
               if s.name == "bounce"]

    # the same sample, bounce by bounce, with no profiler
    shadow.clear()
    pixels = torch.arange(64)
    state, keys = pt.camera_wavefront(cam, pixels, rng.key(3, CPU), [0], cfg)
    live = []
    for b in range(cfg.depth):
        live.append(int(((state.radiance != 0).any(-1) & (state.direction != 0).any(-1)).sum()))
        state = pt.trace_bounce_fused(state, scene, keys, b, cfg)
    assert counted == list(zip(live, shadow))
    assert live[0] == 64 and live[-1] < 64 and shadow[0] > 0


def test_untraced_render_records_nothing_and_matches_a_traced_one(tmp_path, monkeypatch):
    """No profiler: the log stays empty, no CUDA event and no record_function
    is made, no count reduction runs, and the image is bit-identical to the
    same render's under the profiler."""
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)
    scene, cam = _ball()
    cfg = pt.RenderConfig(depth=2, spp=2, fused_shading=True, compact=False)
    with profiling.trace(str(tmp_path)):
        traced = _render(scene, cam, cfg)
    assert len(profiling.spans()) > 0
    profiling.clear()

    made = []

    def forbidden(name):
        def call(*a, **k):
            made.append(name)
            raise AssertionError(f"{name} while tracing is off")
        return call

    monkeypatch.setattr(torch.cuda, "Event", forbidden("Event"))
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        forbidden("record_function"))
    monkeypatch.setattr(profiling.torch.linalg, "vector_norm", forbidden("vector_norm"))
    untraced = _render(scene, cam, cfg)
    assert profiling.spans() == [] and made == []
    for a, b in zip(traced, untraced):
        assert torch.equal(a, b)
