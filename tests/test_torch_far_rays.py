"""The far-ray fact of the cone traversal (`ops/bvh.far_rays_inert`, proved
in `ops/traverse.py` beside `any_hit`'s dispatch): no cone row test accepts
a ray with |d|inf >= 2^127 where the row meets the fact, so `any_hit` hands
such lanes to K2/K3 dead (t_max = 0).

On the CPU: cone rows of the tiny hair ball and the fur patch, exact
cylinders (slope 0), slopes near 2^-60, axes along x, y and z, rows with
their slab ends at 2^64, and padding rows, against far rays (a Whitted
miss's shadow ray d = target - o, d along each row's axis and along the
axes, |d|inf at 2^127 and an ulp either side, infinite components), through
every form of the row test (`ops/bvh._cone_core`, the tensor-core test's
`_cone_core_mxu`, K2's and K3's twins on f32 and bf16 packs) at t_max 1 and
INF and several t_min: no row that meets the fact accepts; the same rows
accept ordinary rays. Which lanes are far; what `attach_bvh` and
`pack_prim_hbm` record; a pack with one row whose slab holds 0 skips
nothing.

On the card (`cuda`-marked, skipped elsewhere): `any_hit` through K3 and K5
on a small hair ball's Whitted shadow rays and NEE rays, against K3 called
on the unmodified t_max and the scalp's answer, and Whitted renders with
and without the pack fact, bit for bit. No jax import, so on the card:
`python -m pytest tests/test_torch_far_rays.py -m cuda --noconftest -p no:cacheprovider`.
"""

import dataclasses

import pytest
import torch

from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt, whitted
from ba_pathtracing_fur_torch.ops import bvh as bvh_mod, traverse
from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, stream as cstream, \
    traverse as ctraverse
from ba_pathtracing_fur_torch.scene import builtins
from ba_pathtracing_fur_torch.utils import profiling

torch.set_num_threads(2)

CPU = torch.device("cpu")
INF = traverse.INF
F32_MAX = torch.finfo(torch.float32).max
BIG = 2.0 ** 127
#: the tiny ball of the Whitted tests: the cells' groom at 2,000 fibers
BALL = dict(resolution=(24, 24), n_fibers=2000, fiber_verts=10, fiber_radius=0.004,
            sphere_radius=0.5, on_device=True, seed=0)


def _rows_of(packed: torch.Tensor) -> torch.Tensor:
    """[C, 16, K] -> [C*K, 16] rows."""
    return packed.permute(0, 2, 1).reshape(-1, packed.shape[1])


def _pack_of(rows: torch.Tensor) -> torch.Tensor:
    """[N, 16] rows -> a one-leaf [1, 16, N] pack."""
    return rows.T.contiguous()[None]


def _frames(n: int, g) -> torch.Tensor:
    """[n, 3, 3] random orthonormal frames (rows u, v, w), rounded to f32."""
    q, _ = torch.linalg.qr(torch.randn((n, 3, 3), generator=g, dtype=torch.float64))
    return q.transpose(1, 2).float()


def _synthetic(frames, slope, g, r_base=0.004, side=1.0) -> torch.Tensor:
    """Rows on `frames` with bases in the unit cube and an axial slab of
    height 0.1 on the `side` of 0 (a base on the other side is moved)."""
    n = frames.shape[0]
    base = torch.rand((n, 3), generator=g) * 2.0 - 1.0
    v = frames[:, 1]
    bv = (base * v).sum(-1)
    shift = torch.where(bv * side < 0.05, side * (0.05 + bv.abs() + 0.1), 0.0)
    base = base + shift[:, None] * v
    min_d = (base * v).sum(-1)
    lo, hi = torch.minimum(min_d, min_d + 0.1 * side), torch.maximum(min_d, min_d + 0.1 * side)
    cols = [base, frames[:, 0], frames[:, 1], frames[:, 2],
            torch.stack([slope, torch.full((n,), r_base), lo, hi], 1)]
    return torch.cat(cols, 1).float()


def _row_set(name: str) -> torch.Tensor:
    """[N, 16] cone rows of one kind."""
    g = torch.Generator().manual_seed(7)
    if name == "ball":
        scene, _ = builtins.hair_ball(**BALL, device=CPU)
        return _rows_of(traverse.attach_bvh(scene).cone_bvh.packed)
    if name == "fur_patch":
        scene, _ = builtins.fur_patch(resolution=(8, 8), fibers_per_face=40, device=CPU)
        return _rows_of(traverse.attach_bvh(scene, min_prims=1).cone_bvh.packed)
    if name == "cylinders":
        fr = _frames(600, g)
        return torch.cat([_synthetic(fr[:300], torch.zeros(300), g),
                          _synthetic(fr[300:], torch.zeros(300), g, side=-1.0)])
    if name == "tiny_slopes":
        s = torch.where(torch.rand(400, generator=g) < 0.5, -1.0, 1.0) * 2.0 ** -60
        s = s * (1.0 + torch.rand(400, generator=g))
        return _synthetic(_frames(400, g), s, g)
    if name == "axes":
        eye = torch.eye(3)
        perms = [[1, 0, 2], [0, 1, 2], [0, 2, 1]]  # v along x, y, z
        fr = torch.stack([sg * eye[p] for p in perms for sg in (1.0, -1.0)])
        fr = fr.repeat(40, 1, 1)
        slope = torch.rand(fr.shape[0], generator=g) * 0.01
        return torch.cat([_synthetic(fr, slope, g), _synthetic(fr, slope, g, side=-1.0)])
    if name == "slab_edge":
        rows = _synthetic(_frames(64, g), torch.zeros(64), g)
        rows[:32, 14], rows[:32, 15] = 2.0 ** 63, 2.0 ** 64
        rows[32:, 14], rows[32:, 15] = -2.0 ** 64, -2.0 ** 63
        return rows
    if name == "padding":
        rows = torch.zeros((64, 16))
        rows[:, 14], rows[:, 15] = 1.0, -1.0
        return rows
    raise ValueError(name)


ROW_SETS = ["ball", "fur_patch", "cylinders", "tiny_slopes", "axes", "slab_edge", "padding"]


def _far_rays(rows: torch.Tensor):
    """(o [R, 3], d [R, 3]) rays with |d|inf at or about 2^127."""
    g = torch.Generator().manual_seed(11)
    dirs = torch.nn.functional.normalize(torch.randn((64, 3), generator=g), dim=-1)
    near = torch.rand((64, 3), generator=g) * 2.0 - 1.0
    # a Whitted miss: its point at o + 3.4e38 d, its shadow ray toward a light
    miss = torch.tensor([0.0, 0.5, 2.5]) + INF * dirs
    os_, ds = [miss, miss], [torch.tensor([0.0, 2.0, 1.0]) - miss,
                             torch.tensor([-1.5, 1.0, 0.3]) - miss]
    # along the rows' axes, from points on and beside them
    pick = torch.randperm(rows.shape[0], generator=g)[:64]
    v = rows[pick, 6:9]
    v = torch.where(v.abs().sum(-1, keepdim=True) > 0, v, dirs)  # padding rows
    for s in (BIG, -F32_MAX):
        os_ += [rows[pick, 0:3], rows[pick, 0:3] + 1e-3 * rows[pick, 3:6]]
        ds += [s * (v / v.abs().amax(-1, keepdim=True))] * 2
    # along the axes, and |d|inf at 2^127 and an ulp either side
    axes = torch.cat([torch.eye(3), -torch.eye(3)])
    for s in (BIG, 1.5 * BIG, F32_MAX):
        os_.append(near[:6])
        ds.append(s * axes)
    for m in (BIG, float(torch.nextafter(torch.tensor(BIG), torch.tensor(0.0))),
              float(torch.nextafter(torch.tensor(BIG), torch.tensor(INF)))):
        d = dirs / dirs.abs().amax(-1, keepdim=True)
        os_.append(near)
        ds.append(d * m)
    # infinite components
    d = dirs * BIG
    d[::2, 0] = float("inf")
    d[1::2, 2] = -float("inf")
    os_ += [near, torch.zeros_like(near)]
    ds += [d, d]
    return torch.cat(os_).float(), torch.cat(ds).float()


def _one_leaf_bvh(rows: torch.Tensor) -> bvh_mod.BVH:
    """A one-leaf BVH over `rows` for the twins (their brute force reads only
    the pack)."""
    n = rows.shape[0]
    return bvh_mod.BVH(bmin=torch.zeros((1, 3)), bmax=torch.zeros((1, 3)),
                       perm=torch.arange(n, dtype=torch.int32), packed=_pack_of(rows),
                       n_leaves=1, leaf_size=n)


def _forms(rows):
    """Every form of the cone row test -> name: f(o, d, t_max, t_min) ->
    accepted [R, N] or found [R] (the twins)."""
    comp = [rows[None, :, i] for i in range(16)]
    f32 = _one_leaf_bvh(rows)
    bf16 = dataclasses.replace(f32, packed=f32.packed.bfloat16())
    return {
        "cone_core": lambda o, d, tm, t0: bvh_mod._cone_core(o, d, comp, t0, tm) < INF,
        "cone_core_mxu": lambda o, d, tm, t0: ctraverse._cone_core_mxu(o, d, comp, t0, tm) < INF,
        "k2_twin_any": lambda o, d, tm, t0: ctraverse.traverse_ref(
            o, d, tm, f32, "cone", any_hit=True, t_min=t0)[2],
        "k3_twin_closest": lambda o, d, tm, t0: cstream.traverse_stream_ref(
            o, d, tm, f32, "cone", t_min=t0)[2],
        "k3_twin_mxu_any": lambda o, d, tm, t0: cstream.traverse_stream_ref(
            o, d, tm, f32, "cone", any_hit=True, t_min=t0, mxu=True)[2],
        "k3_twin_bf16_any": lambda o, d, tm, t0: cstream.traverse_stream_ref(
            o, d, tm, bf16, "cone", any_hit=True, t_min=t0)[2],
    }


@pytest.mark.parametrize("rows_name", ROW_SETS)
def test_no_row_that_meets_the_fact_accepts_a_far_ray(rows_name):
    rows = _row_set(rows_name)
    fact = bvh_mod.far_inert_rows(_pack_of(rows))[0]
    fact_bf16 = bvh_mod.far_inert_rows(_pack_of(rows.bfloat16().float()))[0]
    if rows_name != "fur_patch":
        assert fact.all(), (rows_name, int((~fact).sum()))
    assert fact.sum() > 0.4 * rows.shape[0]
    o, d = _far_rays(rows)
    assert (d.abs().amax(-1) >= BIG).float().mean() > 0.85
    # each form on the rows that meet the fact as it reads them
    forms, forms_bf16 = _forms(rows[fact]), _forms(rows[fact_bf16])
    for name in forms:
        form = (forms_bf16 if "bf16" in name else forms)[name]
        for t_max in (1.0, INF):
            for t_min in (1e-4, 0.0, -1.0):
                got = form(o, d, torch.full((o.shape[0],), t_max), t_min)
                assert not got.any(), (rows_name, name, t_max, t_min,
                                       int(got.sum()))


def test_a_slab_that_holds_0_accepts_a_far_ray():
    """Why the fact asks for a slab without 0: the unit cylinder about the y
    axis and the ray from (-2, 2^125, 0) along (4, -2^127, 0). Every form
    finds the wall at t = 0.25, exactly, where the axial coordinate is
    2^125 - 0.25 * 2^127 = 0: a slab [-1, 1] accepts the ray (at t_max 1
    and INF), and the slab [0.5, 1] does not."""
    row = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0,
                        0.0, 1.0, -1.0, 1.0])
    o = torch.tensor([[-2.0, 2.0 ** 125, 0.0]])
    d = torch.tensor([[4.0, -BIG, 0.0]])
    holds, leaves = row[None].clone(), row[None].clone()
    leaves[0, 14] = 0.5
    assert not bvh_mod.far_rays_inert(_pack_of(holds)) and bvh_mod.far_rays_inert(
        _pack_of(leaves))
    for t_max in (1.0, INF):
        tm = torch.full((1,), t_max)
        for name, form in _forms(holds).items():
            assert form(o, d, tm, 1e-4).all(), (name, t_max)
        for name, form in _forms(leaves).items():
            assert not form(o, d, tm, 1e-4).any(), (name, t_max)


@pytest.mark.parametrize("rows_name", ["ball", "cylinders", "axes"])
def test_the_same_rows_accept_ordinary_rays(rows_name):
    """The control: rays of |d| 1 aimed at the rows' own points are
    accepted by every form, so the far rays' silence is the proof's."""
    rows = _row_set(rows_name)
    g = torch.Generator().manual_seed(3)
    pick = torch.randperm(rows.shape[0], generator=g)[:256]
    pick = pick[rows[pick, 14] < rows[pick, 15]]
    r = rows[pick]
    # a point on each row's surface: base + (mid slab - b.v) v + radius u
    v, u = r[:, 6:9], r[:, 3:6]
    y = 0.5 * (r[:, 14] + r[:, 15]) - (r[:, 0:3] * v).sum(-1)
    p = r[:, 0:3] + y[:, None] * v + (r[:, 13] - r[:, 12] * y)[:, None] * u
    o = p + 0.5 * u + 0.1 * v
    d = torch.nn.functional.normalize(p - o, dim=-1)
    for name, form in _forms(rows).items():
        got = form(o, d, torch.full((o.shape[0],), INF), 1e-4)
        found = got.any(-1) if got.dim() == 2 else got
        assert found.float().mean() > 0.5, (rows_name, name)


def test_far_lanes_are_those_with_a_component_of_2_127():
    d = torch.tensor([[BIG, 0.0, 0.0],
                      [float(torch.nextafter(torch.tensor(BIG), torch.tensor(0.0))), 1.0, 1.0],
                      [0.0, -BIG, 0.0],
                      [0.0, 0.0, float("inf")],
                      [1.0, float("-inf"), 2.0],
                      [float("nan"), 1.0, 1.0],
                      [1e38, -1e38, 1e38],
                      [0.0, 0.0, 0.0]])
    t_max = torch.tensor([1.0, 1.0, INF, 1.0, 0.0, 1.0, 1.0, 1.0])
    got = traverse._far_dead(d, t_max)
    want = torch.tensor([0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    assert torch.equal(got, want)


def _ball(**attach):
    scene, cam = builtins.hair_ball(**BALL, device=CPU)
    return traverse.attach_bvh(scene, method="median", **attach), cam


def test_attach_records_the_fact_on_the_rows_the_kernels_test():
    for attach in ({}, dict(leaf_size=16, fanout=8)):
        scene, _ = _ball(**attach)
        assert scene.cone_bvh.far_inert and not getattr(scene.tri_bvh, "far_inert", False)
        assert scene.cone_bvh.far_inert == bvh_mod.far_rays_inert(scene.cone_bvh.packed)
    bf = cstream.pack_prim_hbm(scene.cone_bvh, "cone", torch.bfloat16)
    assert bf.far_inert == bvh_mod.far_rays_inert(bf.packed)
    assert cstream.pack_prim_hbm(scene.cone_bvh, "cone").far_inert
    # per-shard BVHs stacked: the fact holds where every shard's does
    from ba_pathtracing_fur_torch.parallel.render import shard_scene_bvh

    bare, _ = builtins.hair_ball(**BALL, device=CPU)
    stacked = shard_scene_bvh(bare, 2).cone_bvh
    assert stacked.geo_stacked and stacked.far_inert
    assert stacked.far_inert == all(bvh_mod.far_rays_inert(p) for p in stacked.packed)


def test_a_pack_with_a_row_whose_slab_holds_0_skips_nothing(tmp_path, monkeypatch):
    """One real row's slab moved to hold 0: the fact is false, `any_hit`
    never makes a lane dead, and its answers stand."""
    scene, _ = _ball()
    bvh = scene.cone_bvh
    packed = bvh.packed.clone()
    c, k = torch.nonzero(packed[:, 14] < packed[:, 15])[0].tolist()
    packed[c, 14, k] = -1e-3
    assert packed[c, 15, k] > 0.0
    odd = traverse.kernel_layouts(dataclasses.replace(bvh, packed=packed), "cone", scene.cones)
    assert not odd.far_inert and not bvh_mod.far_inert_rows(packed)[c, k]
    assert int((~bvh_mod.far_inert_rows(packed)).sum()) == 1
    o, d = _far_rays(_rows_of(bvh.packed))
    t_max = torch.ones(o.shape[0])
    seen = []
    two_level = traverse.route(scene.cones, bvh, o.shape[0]) == "k3"
    mod, name = (cstream, "traverse_stream") if two_level else (ctraverse, "traverse")
    walk = getattr(mod, name)

    def spy(o_, d_, t_, bvh_, kind, **k):
        seen.append(t_.clone())
        return walk(o_, d_, t_, bvh_, kind, **k)

    monkeypatch.setattr(mod, name, spy)
    with profiling.trace(str(tmp_path)), profiling.span("light"):
        traverse.any_hit(o, d, dataclasses.replace(scene, cone_bvh=odd), t_max)
    assert len(seen) == 1 and torch.equal(seen[0], t_max)
    assert profiling.spans()[0].count("k3_far_skipped") is None
    profiling.clear()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _shadow_traffic(scene, cam, cfg, monkeypatch):
    """The `any_hit` calls (o, d, t_max) of a render of `cfg` (a
    WhittedConfig or a RenderConfig), and its image."""
    calls, any_hit = [], traverse.any_hit

    def spy(o, d, scene_, t_max, *a, **k):
        calls.append((o, d, traverse._t_max_of(t_max, o.shape[0], o)))
        return any_hit(o, d, scene_, t_max, *a, **k)

    monkeypatch.setattr(traverse, "any_hit", spy)
    if isinstance(cfg, whitted.WhittedConfig):
        img = whitted.render_whitted(scene, cam, cfg)
    else:
        img = pt.render_image(scene, cam, rng.key(5, scene.cones.base.device), cfg)
    monkeypatch.setattr(traverse, "any_hit", any_hit)
    return calls, img


def _walked(o, d, t_max, scene):
    """The cone traversal on the unmodified t_max, or'ed with the scalp's
    answer (K5 at these sizes), on the entry-morton sorted rays as any_hit
    runs them -> (blocked, blocked by a cone) in the callers' order."""
    o_s, d_s, t_s, inv = traverse._sorted_rays(o, d, t_max, scene)
    cone = cstream.traverse_stream(o_s, d_s, t_s, scene.cone_bvh, "cone", any_hit=True)[2]
    tri = cisect.closest(o_s, d_s, t_s, cisect.tables_of(scene.tris, "tri"), "tri", 1e-4)[1] >= 0
    return (cone | tri)[inv], cone[inv]


@pytest.mark.cuda
def test_any_hit_and_whitted_through_k3_equal_the_walk_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)  # K5 on the scalp
    scene, cam = builtins.hair_ball(resolution=(64, 64), n_fibers=20000, on_device=True,
                                    device=dev)
    scene = traverse.attach_bvh(scene, method="median", leaf_size=16, fanout=8)
    assert traverse._two_level(scene.cone_bvh) and scene.cone_bvh.far_inert
    cfg_w = whitted.WhittedConfig(depth=8, hair_lobes="all")
    cfg_p = pt.RenderConfig(depth=4, spp=1, fused_shading=True, compact=False)
    launches = cstream.KERNEL_LAUNCHES
    far = cone_blocked = 0
    for cfg in (cfg_w, cfg_p):
        calls, img = _shadow_traffic(scene, cam, cfg, monkeypatch)
        for o, d, t_max in calls:
            want, by_cone = _walked(o, d, t_max, scene)
            assert torch.equal(traverse.any_hit(o, d, scene, t_max), want)
            far += int(((d.abs().amax(1) >= BIG) & (t_max > 0)).sum())
            cone_blocked += int(by_cone.sum())
        off = dataclasses.replace(scene, cone_bvh=dataclasses.replace(scene.cone_bvh,
                                                                      far_inert=False))
        if isinstance(cfg, whitted.WhittedConfig):
            assert torch.equal(img, whitted.render_whitted(off, cam, cfg))
        else:
            assert torch.equal(img, pt.render_image(off, cam, rng.key(5, dev), cfg))
    assert far > 0 and cone_blocked > 0 and cstream.KERNEL_LAUNCHES > launches
