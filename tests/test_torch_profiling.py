"""The port's tracing (`utils/profiling.py`) on the CPU: `trace` writes a
Chrome trace; a span is a named `bapt.*` span in it and a record in the log
only while a profiler records; counters sum when read; the render's spans
nest pass > bounce > stage on the fused, joint and unfused paths, in the
trace and in the log; `live` and `shadow_live` equal recounts from the
render's own state; with no profiler the log stays empty, nothing is
recorded or counted, and the image is bit-identical to a traced one. The
Whitted render's spans nest whitted > node > {light, lobes} > k3 / hit, its
counters `live`, `miss`, `shadow_live` and `lobe_live` equal recounts, and
untraced it records nothing and matches a traced render bit for bit;
`k3_far_skipped` counts its far shadow lanes while traced and makes
nothing untraced."""

import dataclasses
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt, whitted
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


def test_count_nonzero_makes_its_tensor_only_while_on(tmp_path):
    """A function handed to `count_nonzero` is called only while a profiler
    records and a span is open; its tensor is counted as a tensor is."""
    made = []

    def mask():
        made.append(1)
        return torch.tensor([1.0, 0.0, -2.0])

    profiling.count_nonzero("nz", mask)  # off
    with profiling.trace(str(tmp_path)):
        profiling.count_nonzero("nz", mask)  # on, but no span is open
        assert made == []
        with profiling.span("outer"):
            profiling.count_nonzero("nz", mask)
            profiling.count_nonzero("nz", lambda: mask() * 0.0 + 1.0)
    (outer,) = profiling.spans()
    assert made == [1, 1] and outer.count("nz") == 5


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


def _whitted_ball(reflective=False):
    """The tiny two-level ball with the scalp on K5's twin; `reflective`
    gives the scalp a mirror term, so that the DFS runs more than one
    iteration."""
    scene, cam = _ball()
    if reflective:
        mats = scene.materials
        refl = mats.reflectivity.clone()
        refl[0] = 0.6
        scene = dataclasses.replace(scene, materials=dataclasses.replace(mats,
                                                                         reflectivity=refl))
    return scene, cam


WHITTED_CFG = whitted.WhittedConfig(depth=3, hair_lobes="all")


def test_a_traced_whitted_render_nests_its_stages(tmp_path, monkeypatch):
    """whitted > node > {light, lobes} > k3 / hit in the Chrome trace (by
    time) and in the log (by parent); each node carries its DFS iteration as
    its bounce."""
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)
    scene, cam = _whitted_ball(reflective=True)
    with profiling.trace(str(tmp_path)):
        whitted.render_whitted(scene, cam, WHITTED_CFG)
    iterations = len(whitted.LAST_QUEUE_LIVE[0])
    assert iterations > 1

    ev = [(e["name"][5:], e["ts"], e["ts"] + e["dur"]) for e in _events(tmp_path)
          if e.get("ph") == "X" and e["name"].startswith("bapt.")]

    def within(name, outer):
        return [x for x in ev if x[0] == name and outer[1] <= x[1] and x[2] <= outer[2]]

    (top,) = [x for x in ev if x[0] == "whitted"]
    nodes = within("node", top)
    assert len(nodes) == iterations
    for n in nodes:
        (light,) = within("light", n)
        (lobes,) = within("lobes", n)
        assert within("k3", light) and within("k5", light)
        assert within("k3", lobes) and len(within("hit", lobes)) == 2

    log = profiling.spans()
    (head,) = [s for s in log if s.name == "whitted"]
    assert head.parent is None and head.index == 0
    node_spans = [s for s in log if s.parent == head.index]
    assert [s.name for s in node_spans] == ["node"] * iterations
    for it, node in enumerate(node_spans):
        assert node.bounce == it
        inner = [s for s in log if s.parent == node.index]
        assert [s.name for s in inner] == ["sort", "k5", "k3", "hit", "light", "lobes"]
        for stage in inner[-2:]:
            kids = [s.name for s in log if s.parent == stage.index]
            assert "k3" in kids and all(s.bounce == it for s in log if s.parent == stage.index)
        lobe_kids = [s.name for s in log if s.parent == inner[-1].index]
        assert lobe_kids.count("hit") == 2
    assert all(s.events is None for s in log)


def test_whitted_counters_equal_recounts(tmp_path, monkeypatch):
    """Each node's `live` equals the DFS's live lanes, `miss` its live
    nodes whose closest hit found nothing, `shadow_live` its shadow rays
    with t_max > 0 and `lobe_live` its TT and TRT rays with t_max > 0, all
    recounted from the traversal calls of the same render untraced."""
    scene, cam = _whitted_ball(reflective=True)
    with profiling.trace(str(tmp_path)):
        whitted.render_whitted(scene, cam, WHITTED_CFG)
    log = profiling.spans()

    def counted(name, key):
        return [sum(s.count(key) or 0 for s in log if s.parent == n.index or s is n)
                for n in log if n.name == "node"]

    live = [s.count("live") for s in log if s.name == "node"]
    miss = [s.count("miss") for s in log if s.name == "node"]
    shadow = counted("light", "shadow_live")
    lobe = counted("lobes", "lobe_live")

    profiling.clear()
    calls = []
    closest, any_hit = traverse.closest_hit, traverse.any_hit

    def closest_spy(o, d, scene, t_min=1e-4, t_max=traverse.INF, **k):
        hit = closest(o, d, scene, t_min=t_min, t_max=t_max, **k)
        tm = traverse._t_max_of(t_max, o.shape[0], o)
        # a node traces once, then its TT and its TRT rays
        kind = "lobe" if sum(c[0] != "shadow" for c in calls) % 3 else "node"
        calls.append((kind, int((tm > 0).sum()),
                      int(((tm > 0) & (hit.t == traverse.INF)).sum())))
        return hit

    def any_spy(o, d, scene, t_max, **k):
        calls.append(("shadow", int((traverse._t_max_of(t_max, o.shape[0], o) > 0).sum()), 0))
        return any_hit(o, d, scene, t_max, **k)

    monkeypatch.setattr(traverse, "closest_hit", closest_spy)
    monkeypatch.setattr(traverse, "any_hit", any_spy)
    whitted.render_whitted(scene, cam, WHITTED_CFG)
    assert profiling.spans() == []

    per_node, cur = [], None
    for kind, n, m in calls:
        if kind == "node":
            cur = dict(live=n, miss=m, shadow=0, lobe=0)
            per_node.append(cur)
        else:
            cur[kind] += n
    assert live == whitted.LAST_QUEUE_LIVE[0]
    assert [p["live"] for p in per_node] == live  # no W = 0 lane at these depths
    assert miss == [p["miss"] for p in per_node] and miss[0] > 0
    assert shadow == [p["shadow"] for p in per_node] and shadow[0] > 0
    assert lobe == [p["lobe"] for p in per_node] and lobe[0] > 0


def test_untraced_whitted_render_records_nothing_and_matches_a_traced_one(tmp_path,
                                                                          monkeypatch):
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)
    scene, cam = _whitted_ball(reflective=True)
    with profiling.trace(str(tmp_path)):
        traced = whitted.render_whitted(scene, cam, WHITTED_CFG)
    assert len(profiling.spans()) > 0
    profiling.clear()

    def forbidden(name):
        def call(*a, **k):
            raise AssertionError(f"{name} while tracing is off")
        return call

    monkeypatch.setattr(torch.cuda, "Event", forbidden("Event"))
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        forbidden("record_function"))
    monkeypatch.setattr(profiling.torch.linalg, "vector_norm", forbidden("vector_norm"))
    ops = _OpInputs()
    _spy_on_counts(monkeypatch, ops)
    with ops:
        untraced = whitted.render_whitted(scene, cam, WHITTED_CFG)
    assert profiling.spans() == []
    assert torch.equal(traced, untraced)
    # a counter off reads only tensors the render computes anyway: each one
    # handed to `count_nonzero` is an input of a later operation of the
    # render; a function that would make one is never called
    assert ops.counted and all(ops.used_after(i, x) for i, x in ops.counted)


def test_k3_far_skipped_counts_the_far_lanes_and_makes_nothing_untraced(tmp_path,
                                                                         monkeypatch):
    """`k3_far_skipped` (in the `light` spans) equals the shadow lanes with
    |d|inf >= 2^127 recounted from the render's own any-hit calls, and the
    `miss` count (each miss fires one such ray at the quad light, all of
    them live); untraced, the mask it is handed is the one the skip reads
    anyway, so counting makes nothing and launches nothing."""
    scene, cam = _whitted_ball()
    assert scene.cone_bvh.far_inert
    with profiling.trace(str(tmp_path)):
        traced = whitted.render_whitted(scene, cam, WHITTED_CFG)
    log = profiling.spans()
    skipped = sum(s.count("k3_far_skipped") or 0 for s in log if s.name == "light")
    assert skipped == sum(s.count("k3_far_skipped") or 0 for s in log)
    miss = sum(s.count("miss") for s in log if s.name == "node")
    profiling.clear()

    far, handed = [], []
    any_hit, count = traverse.any_hit, profiling.count

    def any_spy(o, d, scene, t_max, **k):
        tm = traverse._t_max_of(t_max, o.shape[0], o)
        far.append((int((d.abs().amax(1) >= 2.0 ** 127).sum()),
                    int(((d.abs().amax(1) >= 2.0 ** 127) & (tm > 0)).sum())))
        return any_hit(o, d, scene, t_max, **k)

    def count_spy(name, x):
        if name == "k3_far_skipped":
            handed.append((len(ops.inputs), x))
        return count(name, x)

    ops = _OpInputs()
    monkeypatch.setattr(traverse, "any_hit", any_spy)
    monkeypatch.setattr(profiling, "count", count_spy)
    with ops:
        untraced = whitted.render_whitted(scene, cam, WHITTED_CFG)
    assert profiling.spans() == [] and torch.equal(traced, untraced)
    assert len(handed) == len(far) > 0 and all(ops.used_after(i, x) for i, x in handed)
    assert skipped == sum(n for n, _ in far) == sum(n for _, n in far) == miss > 0


class _OpInputs(TorchDispatchMode):
    """The ids of every operation's tensor inputs, in order; `counted` the
    tensors handed to `count_nonzero` (kept alive, so no id is reused) with
    the number of operations before them."""

    def __init__(self):
        super().__init__()
        self.inputs, self.counted = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.inputs.append({id(a) for a in (*args, *kwargs.values())
                            if isinstance(a, torch.Tensor)})
        return func(*args, **kwargs)

    def used_after(self, i, x) -> bool:
        return any(id(x) in ids for ids in self.inputs[i:])


def _spy_on_counts(monkeypatch, ops):
    """`count_nonzero` spied on: its tensor arguments go to `ops.counted`;
    a function argument is handed on as one that fails when called."""
    real = profiling.count_nonzero

    def spy(name, x):
        if callable(x):
            return real(name, lambda: pytest.fail(f"{name} made its tensor while off"))
        assert isinstance(x, torch.Tensor), name
        ops.counted.append((len(ops.inputs), x))
        return real(name, x)

    monkeypatch.setattr(profiling, "count_nonzero", spy)
