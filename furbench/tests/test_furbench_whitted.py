"""The Whitted cell (`hairball.whitted`, `drivers/whitted.py`) on a tiny
version of its configuration on the CPU (the port's plain versions): the
reference agrees with the port, pixel by pixel and shadow ray by shadow
ray, the control and the planted faults read off, a broken timed path
fails the check, the shadow-ray comparison counts what it should; and the
cell's per-layer readers (`whitted_shadow_ms`, `whitted_lobe_ms` on
synthetic span logs, `k3_roofline` on the driver's kept K3 calls), each
None where it finds nothing to read."""

import time

import pytest
import torch

from ba_pathtracing_fur_torch.utils import profiling
from furbench import harness
from furbench.drivers import whitted as driver

CELL = "hairball.whitted"
SEED = 2**31 + 13
#: the tiny ball: 2,000 fibers at 24x24, every pixel checked
TINY = {"params": {"n_fibers": 2000, "resolution": [24, 24]},
        "traffic": {"check_pixels": 576, "warmup_renders": 1, "profile_renders": 1,
                    "check_block": 200}}
READERS = ("whitted_shadow_ms", "whitted_lobe_ms")


def run(seconds=0.2, trace=False):
    return harness.run(CELL, SEED, seconds, trace, time.perf_counter(), device="cpu",
                       overrides=TINY)


def test_the_reference_agrees_with_the_port():
    res, rec = run()
    assert res["correct"], res["check"]
    r = rec["readings"]["program"]
    assert r["off_share_pct"] == 0.0 and r["err_max"] == 0.0 and r["pixels"] == 576
    assert r["shadow_off"] == 0 and r["shadow_rays"] > 0
    assert set(res["check"]) == {"off_share_pct", "shadow_off_share_pct"}
    assert set(res["metrics"]) == {"setup_s", "rays_per_s", "pass_p90_ms"}
    # a render's work is its camera rays, whatever the recursion traces
    assert res["metrics"]["rays_per_s"]["value"] == pytest.approx(
        576 * rec["units"] / rec["window_s"])
    assert list(res)[-1] == "check"


def test_the_control_and_the_planted_faults_read_off():
    from furbench import control

    out = control.readings(CELL, SEED, 0.0, True, device="cpu", overrides=TINY)
    limit = harness.load_json(harness.ROOT / "workloads" / f"{CELL}.json")["limits"]
    for k in ("off_share_pct", "shadow_off_share_pct"):
        assert out["program"][k] <= limit[k]
    for side in ("control", "no_tt", "altered"):
        assert out[side]["off_share_pct"] > limit["off_share_pct"], side
    # every shadow ray of the reference is missing, or every live answer wrong
    for side in ("no_shadows", "wrong_any"):
        assert out[side]["shadow_off_share_pct"] == 100.0, side
    # the tiny ball shows its scalp, so skipping the shadow rays shows in
    # its pixels too
    assert out["no_shadows"]["off"] > 0


def _altered(render_whitted):
    def fault(*a, **k):
        return render_whitted(*a, **k) * 1.01
    return fault


def _tt_dropped(marschner_closed_form):
    def fault(*a, **k):
        lobes = marschner_closed_form(*a, **k)
        return lobes._replace(scat_tt=torch.zeros_like(lobes.scat_tt))
    return fault


def _no_shadows(light_shading):
    def fault(*a, **k):
        return light_shading(*a[:7], a[7]._replace(shadows=False), *a[8:], **k)
    return fault


def _answers_no(any_hit):
    def fault(*a, **k):
        return torch.zeros_like(any_hit(*a, **k))
    return fault


@pytest.mark.parametrize("module,attr,fault,check", [
    ("models.whitted", "render_whitted", _altered, "off_share_pct"),
    ("models.fur", "marschner_closed_form", _tt_dropped, "off_share_pct"),
    ("models.whitted", "light_shading", _no_shadows, "shadow_off_share_pct"),
    ("ops.traverse", "any_hit", _answers_no, "shadow_off_share_pct")])
def test_a_broken_timed_path_fails_the_check(module, attr, fault, check, monkeypatch):
    import importlib

    mod = importlib.import_module(f"ba_pathtracing_fur_torch.{module}")
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    res, _ = run()
    assert not res["correct"], res["check"]
    got = res["check"][check]
    assert got["value"] > got["limit"], res["check"]


def _rays(n, live, blocked=None, shift=0.0):
    o = torch.arange(3.0 * n).reshape(n, 3) + shift
    return dict(o=o, d=-o, t_max=torch.where(torch.tensor(live), 1.0, 0.0),
                blocked=torch.tensor(blocked or [False] * n))


def test_shadow_errors_count_missing_other_and_wrongly_answered_rays():
    cpu = torch.device("cpu")
    want = [[_rays(3, [True, True, False]), _rays(3, [True, False, False])]]

    def no_hit(o, d, t_max):
        return torch.zeros(o.shape[0], dtype=torch.bool)

    assert driver.shadow_errors(want, want, no_hit, 3, cpu) == (0, 3)
    # no call at all: every fired ray is missing
    assert driver.shadow_errors([], want, no_hit, 3, cpu) == (3, 3)
    assert driver.shadow_errors([[want[0][0]]], want, no_hit, 3, cpu) == (1, 3)
    # a ray fired that the reference does not fire, one moved, one answered
    # otherwise than the reference's search answers the same ray
    extra = [[_rays(3, [True, True, True]), want[0][1]]]
    assert driver.shadow_errors(extra, want, no_hit, 3, cpu) == (1, 4)
    moved = [[_rays(3, [True, True, False], shift=1e-2), want[0][1]]]
    assert driver.shadow_errors(moved, want, no_hit, 3, cpu) == (2, 3)
    wrong = [[_rays(3, [True, True, False], [False, True, True]), want[0][1]]]
    assert driver.shadow_errors(wrong, want, no_hit, 3, cpu) == (1, 3)
    # within TOL x (1 + |want|), and a walk the reference did not make that
    # fires nothing
    near = [[_rays(3, [True, True, False], shift=1e-5), want[0][1]], [_rays(3, [False] * 3)]]
    assert driver.shadow_errors(near, want, no_hit, 3, cpu) == (0, 3)


def test_blocks_merge_in_lane_order_dead_where_a_block_stopped():
    cpu = torch.device("cpu")
    a = [[_rays(2, [True, True]), _rays(2, [True, False])]]
    b = [[_rays(1, [True], shift=9.0)]]
    (walk,) = driver.merge_blocks([a, b], [2, 1], cpu)
    assert [c["t_max"].tolist() for c in walk] == [[1.0, 1.0, 1.0], [1.0, 0.0, 0.0]]
    assert torch.equal(walk[0]["o"][2], b[0][0]["o"][0])


def test_a_traced_run_reports_and_checks():
    res, rec = run(trace=True)
    assert res["correct"], res["check"]
    assert rec["unit"] == "render" and rec["trace"]["units"] == 1
    per_layer = {m["name"] for m in harness.cell_spec(CELL, harness.load_json(
        harness.CHECKOUT / "BENCHMARK.json"))["per_layer"]}
    assert per_layer == {"whitted_shadow_ms", "whitted_lobe_ms", "k3_roofline", "bvh_build_s"}
    # the CPU: no events, no K3 kernel; the set-up's BVH build is read
    assert "bvh_build_s" in res["metrics"] and set(res["metrics"]) <= per_layer
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_nan_pixel_is_off():
    want = torch.full((3, 3), 0.5)
    got = torch.tensor([[0.5] * 3, [float("nan")] * 3, [0.51] * 3])
    assert driver.errors(got, want)[1].tolist() == [False, True, True]


class Events:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _span(log, name, parent, device_ms=None, bounce=None):
    s = profiling.Span(name, parent, None, bounce,
                       events=None if device_ms is None else (Events(0.0), Events(device_ms)))
    s.index = len(log)
    log.append(s)
    return s


def _log(renders, events=True, first=0):
    """Renders of two DFS iterations: render r's light spans 100 + r and 5
    ms, its lobes spans 10 + r and 1 ms."""
    log = []
    for r in range(first, first + renders):
        head = _span(log, "whitted", None, 1000.0 if events else None)
        for it, (light, lobes) in enumerate(((100.0 + r, 10.0 + r), (5.0, 1.0))):
            node = _span(log, "node", head.index, 200.0 if events else None, bounce=it)
            _span(log, "k3", node.index, 1.0 if events else None, bounce=it)
            _span(log, "light", node.index, light if events else None, bounce=it)
            _span(log, "lobes", node.index, lobes if events else None, bounce=it)
    return log


def _read(name, log, monkeypatch, units=2, unit="render"):
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    return harness.reader_of(name).read({"trace": {"units": units}, "unit": unit})


def test_span_readers_read_the_first_traced_render(monkeypatch):
    log = _log(1, first=0) + _log(2, first=7)  # another render before the traced two
    for i, s in enumerate(log):
        s.index = i
    assert _read("whitted_shadow_ms", log, monkeypatch) == 112.0
    assert _read("whitted_lobe_ms", log, monkeypatch) == 18.0


@pytest.mark.parametrize("name", READERS)
def test_span_readers_none_where_there_is_nothing_to_read(name, monkeypatch):
    assert _read(name, _log(2, events=False), monkeypatch) is None  # a CPU run
    assert _read(name, [], monkeypatch) is None  # an empty log
    assert _read(name, _log(1), monkeypatch) is None  # fewer renders than traced
    assert _read(name, _log(2), monkeypatch, unit="pass") is None  # not by renders
    # a port without the Whitted spans: the traversal's spans alone
    assert _read(name, [s for s in _log(2) if s.name in ("k3",)], monkeypatch) is None
    assert harness.reader_of(name).read({}) is None  # not traced
    monkeypatch.delattr(profiling, "spans")  # a port without the span log
    assert harness.reader_of(name).read({"trace": {"units": 2}, "unit": "render"}) is None


def test_k3_roofline_reads_the_renders_kept_k3_calls():
    """`k3_roofline` reads the Whitted driver's record (K3 calls kept from
    the first traced render, benchmark spans named "render") as it reads a
    pass's; None without calls or K3 kernels."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import stream
    from ba_pathtracing_fur_torch.scene import builtins

    scene, _ = builtins.hair_ball(resolution=(8, 8), n_fibers=300, device="cpu")
    scene = traverse.attach_bvh(scene, leaf_size=16, fanout=8)
    o = torch.tensor([[0.0, 0.3, 2.2]]).repeat(64, 1)
    d = torch.nn.functional.normalize(torch.randn(64, 3, generator=torch.Generator()
                                                  .manual_seed(1)) * 0.2
                                      + torch.tensor([0.0, -0.15, -1.0]), dim=-1)
    t_max = torch.full((64,), traverse.INF)
    out = stream.traverse_stream(o, d, t_max, scene.cone_bvh, "cone")
    rec = {"trace": {"spans": [("render", 0.0, 1.0), ("render", 1.0, 2.0)],
                     "ops": [("stream_kernel<true>", 0.1, 0.1 + 1e-6)]},
           "k3_calls": [dict(o=o, d=d, t_max=t_max, bvh=scene.cone_bvh, kind="cone",
                             any_hit=False, out=out)],
           "unit": "render", "seed": 5}
    reader = harness.reader_of("k3_roofline")
    got = reader.read(rec)
    assert got is not None and got > 0.0
    # the same calls read alike under a pass's span names
    as_pass = {**rec, "unit": "pass", "trace": {**rec["trace"], "spans": [
        ("pass", s, e) for _, s, e in rec["trace"]["spans"]]}}
    assert reader.read(as_pass) == got
    assert reader.read({**rec, "k3_calls": []}) is None
    no_k3 = {**rec, "trace": {**rec["trace"], "ops": [("brute_kernel", 0.1, 0.2)]}}
    assert reader.read(no_k3) is None
    assert reader.read({}) is None
