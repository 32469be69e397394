"""The two last variants of the streaming traversal (K3), their plain
versions against the JAX package's, on the CPU.

* `traverse_stream(..., mxu=True)` (CPU tensors: `brute_force(mxu=True)`,
  the cone test of the JAX package's `_cone_block_mxu`) against JAX
  `traverse_stream(..., mxu=True)` in interpret mode, closest, any and mixed,
  on the two-level fur patch of tests/test_torch_stream.py (leaf 16, fanout
  8, 512 rays from a numpy seed): the same found and closest-hit rows on all
  rays but at most 2% (compiled JAX contracts the quadratic's multiply-adds,
  as the f32 kernel's test allows), and on those rays JAX's
  `_cone_block_mxu` run op by op gives the port's found and rows.
* `pack_prim_hbm(..., torch.bfloat16)`: the pack equals JAX's bf16 pack bit
  for bit (cones and triangles); the bf16 plain version equals JAX's leaf
  test run op by op over the upcast pack on every ray; JAX's bf16 kernel
  differs on a few rays, each either a box quirk (JAX keeps the f32 boxes,
  which can cull a rounded row's hit: the ray agrees once JAX is given the
  port's refitted boxes, and its winner's rounded box pokes out of JAX's f32
  child box) or the contraction of the f32 test (at most 2%); the refitted
  boxes bound every hit of the rounded rows and contain the f32 boxes.
* `mxu=True` on triangles is the f32 test; `work_ref` counts both variants
  (the mxu test's TF32 terms by pack and its fewest unit-major mma tiles).
* The mxu kernel's TF32 split, emulated in torch (cvt.rna.tf32): its passes
  summed in f64 stay within 2^-20 sum |x_k f_k| of the f64 projection, and a
  bf16 row needs no lo term; the smoke's mutants of the kernel patch lines
  that occur once in csrc.
* The slice as a whole: a render through `render_sample_ids`' hooks with
  the mxu test against the render through `closest_hit` (the image gate of
  tests/test_fused_shade.py), with the f32 test bit for bit equal to it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.ops import bvh as jbvh, traverse as jtraverse
from ba_pathtracing_fur_tpu.ops.pallas import stream as jstream
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.ops import bvh as bvh_mod, traverse
from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse
from ba_pathtracing_fur_torch.scene import types

torch.set_num_threads(2)

CPU = "cpu"
N_RAYS = 512
INF = 3.4e38
MODES = ["closest", "any", "mixed"]


def _rays(n, seed, aim):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = (rs.uniform(aim[0], aim[1], (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.fixture(scope="module")
def two_level():
    """A JAX fur patch with a two-level cone BVH, the port's copy of it and
    rays aimed into it (tests/test_torch_stream.py's scene)."""
    js, _ = jbuiltins.fur_patch(resolution=(16, 16), fibers_per_face=120, fiber_verts=6)
    js = jtraverse.attach_bvh(js, method="median", min_prims=1, leaf_size=16, fanout=8)
    assert js.cone_bvh.fanout == 8 and js.cone_bvh.n_leaves == 128
    o, d = _rays(N_RAYS, 5, ((-0.4, 0.0, -0.4), (0.4, 0.12, 0.4)))
    return js, types.scene_from_numpy(js, device=CPU), o, d


@pytest.fixture(scope="module")
def tri_level():
    """The small hair ball's 768 scalp triangles on a two-level triangle BVH
    (leaf 16, fanout 8), the port's copy, and rays aimed at the scalp."""
    js, _ = jbuiltins.hair_ball(resolution=(8, 8), n_fibers=20)
    js = jtraverse.attach_bvh(js, method="median", min_prims=1, leaf_size=16, fanout=8)
    assert js.tri_bvh.fanout == 8 and js.tri_bvh.n_leaves == 64
    o, d = _rays(N_RAYS, 0, ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)))
    return js, types.scene_from_numpy(js, device=CPU), o, d


def _case(mode, n=N_RAYS):
    """(t_max [R], is_any [R] bool or None) of one mode: closest rays trace
    to INF, shadow rays to 2.5, every 19th ray is dead; a mixed wavefront
    makes every other ray a shadow ray."""
    is_any = np.zeros(n, bool) if mode == "closest" else np.ones(n, bool)
    if mode == "mixed":
        is_any[::2] = False
    t_max = np.where(is_any, 2.5, INF).astype(np.float32)
    t_max[::19] = 0.0
    return t_max, (is_any if mode == "mixed" else None)


def _port(o, d, t_max, bvh, kind, mode, is_any, mxu=False):
    refs = cstream.REF_CALLS
    out = cstream.traverse_stream(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), bvh, kind,
        any_hit=mode == "any", is_any=None if is_any is None else torch.from_numpy(is_any),
        mxu=mxu)
    assert cstream.REF_CALLS == refs + 1
    return tuple(x.numpy() for x in out)


def _jax_kernel(o, d, t_max, jb, kind, mode, is_any, mxu=False, dtype=jnp.float32,
                boxes=None):
    sboxes, cboxes = boxes or (jstream.pack_super_boxes(jb), jstream.pack_child_boxes(jb))
    return tuple(np.asarray(x) for x in jstream.traverse_stream(
        jnp.asarray(o), jnp.asarray(d), sboxes, cboxes, jstream.pack_prim_hbm(jb, kind, dtype)[0],
        jnp.asarray(t_max), kind=kind, fanout=jb.fanout, leaf_k=jb.leaf_size,
        any_hit=mode == "any", ray_tile=128, mxu=mxu,
        is_any=None if is_any is None else jnp.asarray(is_any, jnp.float32)))


def _jax_op_by_op(o, d, t_max, bvh, kind, mxu=False):
    """JAX's leaf test run op by op over every row of the port's reordered
    pack (a bf16 pack upcast) -> (found, row of the nearest hit): the cone
    test of `_cone_block_mxu` (mxu), `ops/bvh._cone_core` or `_tri_core`."""
    comp = [jnp.asarray(c.numpy()) for c in ctraverse._rows_cm(bvh)]
    if mxu:
        t = np.asarray(jstream._cone_block_mxu(jnp.asarray(o), jnp.asarray(d),
                                               jnp.concatenate(comp, 0), 1e-4))
        t = np.where(t < t_max[:, None], t, INF)
    else:
        fn = jbvh._cone_core if kind == "cone" else jbvh._tri_core
        t = np.asarray(fn(jnp.asarray(o), jnp.asarray(d), comp, 1e-4, jnp.asarray(t_max)))
    return t.min(-1) < INF, t.argmin(-1)


def _closest_rays(mode, is_any):
    n = N_RAYS
    if mode == "any":
        return np.zeros(n, bool)
    return np.ones(n, bool) if is_any is None else ~is_any


@pytest.mark.parametrize("mode", MODES)
def test_mxu_twin_matches_jax_traverse_stream(two_level, mode):
    """mxu=True: the port's plain version against JAX's kernel in interpret
    mode (found, and rows on closest rays, equal on all but <= 2% of rays;
    t of the agreeing closest rays to rtol 2e-3, as the f32 test's), and
    JAX's mxu test run op by op gives the port's found and rows on the rays
    where they differ."""
    js, ts, o, d = two_level
    t_max, is_any = _case(mode)
    t, row, found = _port(o, d, t_max, ts.cone_bvh, "cone", mode, is_any, mxu=True)
    assert 0.05 < found.mean() < 0.95
    t1, r1, f1 = _jax_kernel(o, d, t_max, js.cone_bvh, "cone", mode, is_any, mxu=True)
    closest = _closest_rays(mode, is_any)
    np.testing.assert_array_equal(row < 0, ~found)
    np.testing.assert_array_equal(t[~found], t_max[~found])
    differ = (found != f1) | (closest & found & (row != r1))
    assert differ.mean() <= 0.02
    if differ.any():
        f_op, r_op = _jax_op_by_op(o[differ], d[differ], t_max[differ], ts.cone_bvh, "cone",
                                   mxu=True)
        np.testing.assert_array_equal(found[differ], f_op)
        keep = closest[differ] & f_op
        np.testing.assert_array_equal(row[differ][keep], r_op[keep])
    same = found & ~differ
    assert (t[same & ~closest] == 0.0).all() and (t1[same & ~closest] == 0.0).all()
    np.testing.assert_allclose(t[same & closest], t1[same & closest], rtol=2e-3)


@pytest.mark.parametrize("kind", ["cone", "tri"])
def test_bf16_pack_matches_jax_pack_prim_hbm(two_level, tri_level, kind):
    """The bf16 pack is JAX's (round to nearest even) bit for bit, without
    its 128-lane padding; f32 leaves the BVH's pack as it is."""
    js, ts, _, _ = two_level if kind == "cone" else tri_level
    jb, tb = (js.cone_bvh, ts.cone_bvh) if kind == "cone" else (js.tri_bvh, ts.tri_bvh)
    b16 = cstream.pack_prim_hbm(tb, kind, torch.bfloat16)
    want = np.asarray(jstream.pack_prim_hbm(jb, kind, jnp.bfloat16)[0])[:, :, :tb.leaf_size]
    assert b16.packed.dtype == torch.bfloat16 and b16.packed.is_contiguous()
    np.testing.assert_array_equal(b16.packed.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
    assert torch.equal(cstream.pack_prim_hbm(tb, kind).packed, tb.packed)
    # the Hit is built from the rounded rows: the winner-row table follows the pack
    c, w, k = b16.packed.shape
    rows = b16.packed.float().permute(0, 2, 1).reshape(c * k, w)[:tb.aos_rows.shape[0]]
    if kind == "cone":
        assert torch.equal(b16.aos_rows[:, :16], rows)
        assert torch.equal(b16.aos_rows[:, 16], (rows[:, 0:3] * rows[:, 6:9]).sum(-1))
        assert torch.equal(b16.aos_rows[:, 17:], tb.aos_rows[:, 17:])
    else:
        assert torch.equal(b16.aos_rows[:, 0:3], rows[:, 0:3])
        assert torch.equal(b16.aos_rows[:, 3:9], torch.cat([rows[:, 0:3] + rows[:, 3:6],
                                                            rows[:, 0:3] + rows[:, 6:9]], 1))
        assert torch.equal(b16.aos_rows[:, 9:], tb.aos_rows[:, 9:])
    with pytest.raises(ValueError, match="dtype"):
        cstream.pack_prim_hbm(tb, kind, torch.float16)


def _outside(lo, hi, box_lo, box_hi):
    return ((lo < box_lo) | (hi > box_hi)).any(-1)


@pytest.mark.parametrize("kind,mode", [("cone", "closest"), ("cone", "any"),
                                       ("tri", "closest"), ("tri", "any")])
def test_bf16_twin_matches_jax_op_by_op(two_level, tri_level, kind, mode):
    """The bf16 plain version equals JAX's leaf test run op by op over the
    upcast pack on every ray (found, and closest rows). JAX's bf16 kernel
    differs on a few rays: each one either agrees once JAX is given the
    port's refitted boxes (the box quirk: its winner's rounded box pokes out
    of JAX's f32 child box, which culls it) or is a contraction flip (JAX's
    compiled test against its own op-by-op one), at most 2%."""
    js, ts, o, d = two_level if kind == "cone" else tri_level
    jb, tb = (js.cone_bvh, ts.cone_bvh) if kind == "cone" else (js.tri_bvh, ts.tri_bvh)
    b16 = cstream.pack_prim_hbm(tb, kind, torch.bfloat16)
    t_max, is_any = _case(mode)
    t, row, found = _port(o, d, t_max, b16, kind, mode, is_any)
    assert 0.05 < found.mean() < 0.95
    f_op, r_op = _jax_op_by_op(o, d, t_max, b16, kind)
    np.testing.assert_array_equal(found, f_op)
    if mode == "closest":
        np.testing.assert_array_equal(row[found], r_op[found])
    closest = _closest_rays(mode, is_any)
    _, r1, f1 = _jax_kernel(o, d, t_max, jb, kind, mode, is_any, dtype=jnp.bfloat16)
    _, r2, f2 = _jax_kernel(o, d, t_max, jb, kind, mode, is_any, dtype=jnp.bfloat16,
                            boxes=(jnp.asarray(b16.sboxes.numpy()),
                                   jnp.asarray(b16.cboxes.numpy())))
    differ = (found != f1) | (closest & found & (row != r1))
    contraction = (found != f2) | (closest & found & (row != r2))
    quirk = differ & ~contraction
    assert contraction.mean() <= 0.02
    rows = np.where(quirk, row, 0)
    lo, hi = cstream._row_boxes(torch.stack(ctraverse._rows_cm(b16))[:, 0].T[rows], kind)
    node = tb.n_leaves - 1 + rows // tb.leaf_size
    out = _outside(lo.numpy(), hi.numpy(), tb.bmin[node].numpy(), tb.bmax[node].numpy())
    assert out[quirk].all()
    print(f"bf16 {kind} {mode}: JAX's kernel differs on {int(differ.sum())} of {N_RAYS} rays: "
          f"{int(quirk.sum())} box quirks (kept out of the port), "
          f"{int((differ & contraction).sum())} contraction flips")


@pytest.mark.parametrize("kind", ["cone", "tri"])
def test_bf16_boxes_bound_the_rounded_rows(two_level, tri_level, kind):
    """Every hit the leaf test accepts on a rounded row (every (ray, row)
    pair, not only the winners) lies in the row's unit box, its leaf's box
    and its super's box; each box contains the f32 box it replaces, and the
    heap's parents contain their children."""
    _, ts, o, d = two_level if kind == "cone" else tri_level
    tb = ts.cone_bvh if kind == "cone" else ts.tri_bvh
    b16 = cstream.pack_prim_hbm(tb, kind, torch.bfloat16)
    comp = ctraverse._rows_cm(b16)
    fn = bvh_mod._cone_core if kind == "cone" else bvh_mod._tri_core
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t = fn(o, d, comp, 1e-4, torch.full((N_RAYS,), INF))
    ri, rows = (t < INF).nonzero(as_tuple=True)
    assert ri.numel() > 100
    p = o[ri] + t[ri, rows][:, None] * d[ri]
    k, c, f = tb.leaf_size, tb.n_leaves, tb.fanout
    leaf, unit = rows // k, (rows % k) // bvh_mod.UNIT
    ub = b16.uboxes[leaf, :, unit]
    assert ((p >= ub[:, :3]) & (p <= ub[:, 3:])).all()
    assert ((p >= b16.bmin[c - 1 + leaf]) & (p <= b16.bmax[c - 1 + leaf])).all()
    sup = b16.sboxes[:, leaf // f].T
    assert ((p >= sup[:, :3]) & (p <= sup[:, 3:])).all()
    assert (b16.uboxes[:, :3] <= tb.uboxes[:, :3]).all()
    assert (b16.uboxes[:, 3:] >= tb.uboxes[:, 3:]).all()
    assert (b16.bmin <= tb.bmin).all() and (b16.bmax >= tb.bmax).all()
    kids = torch.arange(1, 2 * c - 1)
    assert (b16.bmin[(kids - 1) // 2] <= b16.bmin[kids]).all()
    assert (b16.bmax[(kids - 1) // 2] >= b16.bmax[kids]).all()
    assert torch.equal(b16.cboxes, cstream.pack_child_boxes(b16))
    # the refit is needed: some rounded rows poke out of their f32 leaf box
    lo, hi = cstream._row_boxes(torch.stack(comp)[:, 0].T, kind)
    real = tb.perm >= 0
    node = c - 1 + torch.arange(c * k) // k
    poke = _outside(lo, hi, tb.bmin[node], tb.bmax[node]) & real
    print(f"bf16 {kind}: {int(poke.sum())} of {int(real.sum())} rounded rows leave their "
          f"f32 leaf box")
    assert poke.any()


def test_mxu_on_triangles_is_the_f32_test(tri_level):
    """The JAX rule: mxu applies to cones only; triangle rows take the f32
    test, on the CPU as on the card (where the launch counts as the f32
    instance's)."""
    _, ts, o, d = tri_level
    t_max, _ = _case("closest")
    a = _port(o, d, t_max, ts.tri_bvh, "tri", "closest", None, mxu=True)
    b = _port(o, d, t_max, ts.tri_bvh, "tri", "closest", None)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[2].any()


def _mma_cells(o, d, t_max, bvh, hit, is_any, tile):
    """{(ray tile, leaf, unit): rays} entered by the rays, each ray tested
    on its own (the reference count of `work_ref`'s mma tiles): every unit
    of every leaf whose box the ray enters at or before its final t, and a
    closest hit's own unit; for an occluded any-hit ray its row's unit."""
    t, row, found = hit
    cells = {}
    ub = bvh.uboxes
    n_units, c = ub.shape[2], bvh.n_leaves
    for i in range(o.shape[0]):
        if not t_max[i] > 0:
            continue
        if is_any[i] and found[i]:
            r = int(row[i])
            key = (i // tile, r // bvh.leaf_size, r % bvh.leaf_size // bvh_mod.UNIT)
            cells[key] = cells.get(key, 0) + 1
            continue
        t_fin = t_max[i] if is_any[i] else t[i]
        e = ctraverse._slab_entry(o[i:i + 1], d[i:i + 1], bvh.bmin[c - 1:], bvh.bmax[c - 1:],
                                  t_fin[None])[0]
        mine = set()
        for leaf in (e < INF).nonzero()[:, 0].tolist():
            units = ctraverse._units_entered(o[i:i + 1], d[i:i + 1], ub[leaf:leaf + 1],
                                             t_fin[None])[0]
            mine |= {(i // tile, leaf, u) for u in units.nonzero()[:, 0].tolist()}
        if not is_any[i] and found[i]:
            r = int(row[i])
            mine.add((i // tile, r // bvh.leaf_size, r % bvh.leaf_size // bvh_mod.UNIT))
        for key in mine:
            cells[key] = cells.get(key, 0) + 1
    return cells


@pytest.mark.parametrize("variant", ["bf16", "mxu", "mxu_bf16", "mxu_tri", "mxu_any"])
def test_work_ref_counts_the_variants(two_level, tri_level, variant):
    """The bounds' counts: a bf16 pack's leaves at 2 bytes a value (at least
    the f32 pack's tests on the same hits: its boxes hold the f32 ones); mxu
    moves the six projections of each cone row to `tf32_flops` (30 flops x 3
    TF32 terms on an f32 pack, x 2 on a bf16 pack, whose rows have no lo
    half) and leaves 63 in `flops`, and counts the fewest unit-major mma
    tiles (ceil(rays / 8) for each (ray tile of 128, leaf, unit) its rays
    enter; an occluded any-hit ray holds its row's unit) against a count
    ray by ray; triangles have no mxu test."""
    kind = "tri" if variant == "mxu_tri" else "cone"
    _, ts, o, d = two_level if kind == "cone" else tri_level
    tb = ts.cone_bvh if kind == "cone" else ts.tri_bvh
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = torch.full((N_RAYS,), INF)
    any_hit = variant == "mxu_any"
    if any_hit:
        t_max = torch.full((N_RAYS,), 2.5)
        t_max[::19] = 0.0
    hit = ctraverse.brute_force(o, d, t_max, tb, kind)
    if any_hit:
        _, arow, afound = ctraverse.brute_force(o, d, t_max, tb, kind, any_hit=True)
        hit = (hit[0], torch.where(afound, arow, hit[1]), afound)
    base = ctraverse.work_ref(o, d, t_max, tb, kind, any_hit=any_hit, hit=hit)
    assert base["mma_tiles"] == base["mma_rays"] == 0
    b16 = cstream.pack_prim_hbm(tb, kind, torch.bfloat16)
    if variant == "bf16":
        got = ctraverse.work_ref(o, d, t_max, b16, kind, hit=hit)
        units = tb.uboxes.shape[2]
        assert got["leaf_bytes"] == got["leaves_entered"] * (16 * tb.leaf_size * 2 + 6 * units * 4)
        assert base["leaf_bytes"] == base["leaves_entered"] * (16 * tb.leaf_size * 4
                                                               + 6 * units * 4)
        assert got["tf32_flops"] == 0
    else:
        bvh = b16 if variant == "mxu_bf16" else tb
        got = ctraverse.work_ref(o, d, t_max, bvh, kind, any_hit=any_hit, hit=hit, mxu=True)
        base = ctraverse.work_ref(o, d, t_max, bvh, kind, any_hit=any_hit, hit=hit)
    if variant == "bf16":  # the refitted boxes hold the f32 ones: no fewer tests
        assert got["box_tests"] >= base["box_tests"]
        assert got["leaf_row_tests"] >= base["leaf_row_tests"]
    else:
        assert (got["box_tests"], got["leaf_row_tests"]) == (base["box_tests"],
                                                             base["leaf_row_tests"])
        assert got["leaf_bytes"] == base["leaf_bytes"]
    rows = base["leaf_row_tests"]
    if variant.startswith("mxu") and kind == "cone":
        terms = 2 if variant == "mxu_bf16" else 3
        assert ctraverse.MXU_TERMS[bvh.packed.element_size()] == terms
        assert got["tf32_flops"] == rows * 30 * terms
        assert got["flops"] == base["flops"] - rows * 30
        is_any = torch.full((N_RAYS,), any_hit)
        cells = _mma_cells(o, d, t_max, bvh, hit, is_any, ctraverse.TILE_RAYS)
        assert got["mma_rays"] == sum(cells.values()) > 0
        assert got["mma_tiles"] == sum(-(-n // ctraverse.UNIT_RAYS) for n in cells.values())
        # a unit's rays fill its tiles but for the last: fill in (0, 1]
        assert got["mma_rays"] <= ctraverse.UNIT_RAYS * got["mma_tiles"] < \
            got["mma_rays"] + ctraverse.UNIT_RAYS * len(cells)
        if not any_hit:  # every (ray, unit) entry tests the unit's rows
            assert got["mma_rays"] * bvh_mod.UNIT >= rows
    elif variant == "mxu_tri":
        assert got["tf32_flops"] == 0 and got["flops"] == base["flops"]
        assert got["mma_tiles"] == 0


def _tf32(x):
    """cvt.rna.tf32.f32 in torch: x rounded to TF32 (10 mantissa bits) to
    nearest, ties away from zero, its low 13 bits cleared. IEEE floats are
    sign and magnitude, so adding half the dropped step to the bits rounds
    the magnitude (a carry into the exponent is the right result)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_split_error_model(two_level):
    """The mxu kernel's arithmetic (csrc/leaf_tiles.cuh mxu_a, mxu_proj),
    emulated: each operand split as hi = rna(x), lo = rna(x - hi); a
    projection x . f sums x_hi.f_hi + x_lo.f_hi (one pass, the ray's halves
    in the depth) and, on an f32 row, x_hi.f_lo (a second pass). On the test
    scene's rays (o and d) and rows (u, v, w), those products summed in f64
    lie within 2^-20 sum_k |x_k f_k| of the f64 projection (the dropped
    x_lo.f_lo and the halves' rounding, 2^-22 each), while one TF32 pass
    (x_hi.f_hi, the smoke's `tf32` mutant) does not; a bf16 row is exact in
    TF32, so its lo half is 0 and the one pass holds the same bound."""
    _, ts, o, d = two_level
    bvh = ts.cone_bvh
    # the emulation: a tie rounds away from zero, the low bits are cleared
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    assert torch.equal(_tf32(x), torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]))
    assert (_tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF == 0).all()
    rays = torch.cat([torch.from_numpy(o), torch.from_numpy(d)])  # [2R, 3]
    comp = torch.stack(ctraverse._rows_cm(bvh))[:, 0]  # [16, C*K]
    real = bvh.perm >= 0
    frames = [comp[3 + 3 * f:6 + 3 * f][:, real].T for f in range(3)]  # u, v, w: [N, 3]
    b16 = cstream.pack_prim_hbm(bvh, "cone", torch.bfloat16)
    comp16 = torch.stack(ctraverse._rows_cm(b16))[:, 0]
    frames16 = [comp16[3 + 3 * f:6 + 3 * f][:, real].T for f in range(3)]
    x_hi = _tf32(rays)
    x_lo = _tf32(rays - x_hi)
    for rows, exact in ((frames, False), (frames16, True)):
        for f in rows:
            f_hi = _tf32(f)
            f_lo = _tf32(f - f_hi)
            if exact:  # a bf16 row needs no lo term
                assert torch.equal(f_hi, f) and (f_lo == 0).all()
            ref = rays.double() @ f.double().T
            scale = rays.double().abs() @ f.double().abs().T
            got = (x_hi.double() @ f_hi.double().T + x_lo.double() @ f_hi.double().T
                   + x_hi.double() @ f_lo.double().T)
            err = ((got - ref).abs() / scale.clamp(min=1e-30)).max()
            assert err <= 2.0 ** -20
            one = x_hi.double() @ f_hi.double().T
            assert ((one - ref).abs() / scale.clamp(min=1e-30)).max() > 2.0 ** -14


def test_mxu_mutants_patch_lines_that_occur_once():
    """`chip_smoke.MXU_MUTANTS`: each control's lines occur exactly once in
    the port's csrc (in its file and nowhere else), so the mutated copy
    differs from the kernel there alone, and `start_k3_controls` finds them."""
    import chip_smoke
    from ba_pathtracing_fur_torch import kernels

    texts = {p.name: p.read_text() for p in kernels.SRC_DIR.glob("*.cu*")}
    assert set(chip_smoke.MXU_MUTANTS) == {"tf32", "row"}
    for name, (file, old, new) in chip_smoke.MXU_MUTANTS.items():
        assert old != new and old.endswith("\n")
        assert {f: t.count(old) for f, t in texts.items() if old in t} == {file: 1}, name


def test_near_ties_explain_the_mxu_test_against_the_f32_test(two_level):
    """`chip_smoke.near_ties` (in the smoke's row gate): where the mxu and f32 plain
    versions disagree, each ray is a near tie (a decision within TIE_REL of
    its f32 error scale from flipping, in f64), and rows that are no ties
    are mostly not explained away."""
    import chip_smoke

    _, ts, o, d = two_level
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = torch.full((N_RAYS,), INF)
    _, ra, fa = ctraverse.brute_force(o, d, t_max, ts.cone_bvh, "cone")
    _, rb, fb = ctraverse.brute_force(o, d, t_max, ts.cone_bvh, "cone", mxu=True)
    res = chip_smoke.near_ties(o, d, ts.cone_bvh, (ra, fa), (rb, fb))
    assert res["tie"].all() and (res["margin"][res["agree"]] == 0).all()
    # a row elsewhere in the pack, as if hit: at these rays' distance (|p| ~
    # 2) the f32 test's own error admits fibers within ~4.5 radii of a ray,
    # so some of the dense patch's other rows pass for ties (0.087 of them
    # here; a neighbouring row, one or seven on, passes about half the
    # time): the classifier alone does not catch a wrong row, which is why
    # the smoke's row gate has floors on the agreement itself
    n_rows = ts.cone_bvh.n_leaves * ts.cone_bvh.leaf_size
    wrong = torch.where(fa, (ra + n_rows // 2) % n_rows, ra)
    res = chip_smoke.near_ties(o, d, ts.cone_bvh, (ra, fa), (wrong, fa))
    assert not res["agree"][fa].any() and res["tie"][fa].float().mean() < 0.1


def test_render_through_the_hooks(two_level):
    """The slice as a whole on the CPU: `render_sample_ids` with the smoke's
    hooks (chip_smoke.variant_hooks: sorted as closest_hit sorts, K3's
    variant on the cone BVH, the Hit from the port's helpers) gives the
    render_image image bit for bit with the f32 test, within the image gate
    with the mxu test, and a finite image with the bf16 pack; the variant
    runs twice a bounce (closest and shadow)."""
    import chip_smoke
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.scene import builtins

    scene, cam = builtins.fur_patch(resolution=(12, 12), fibers_per_face=120, device=CPU)
    scene = traverse.attach_bvh(scene, leaf_size=16, fanout=8, min_prims=1)
    assert scene.cone_bvh.fanout == 8
    cfg = pt.RenderConfig(depth=2, spp=1, compact=False, fused_shading=True)
    key = rng.key(0, CPU)
    want = pt.render_image(scene, cam, key, cfg)
    imgs = {}
    for variant in ("f32", "mxu", "bf16"):
        calls = []
        imgs[variant] = chip_smoke.hook_render(scene, cam, key, cfg, variant, calls)
        assert len(calls) == 2 * cfg.spp * cfg.depth
    assert torch.equal(imgs["f32"], want)
    d = (imgs["mxu"].double() - want.double()).abs()
    assert d.mean() < 5e-3 and (d.amax(-1) > 1e-3).double().mean() <= 0.02
    assert torch.isfinite(imgs["bf16"]).all() and imgs["bf16"].max() > 0.01
