# Frozen copy of `work_ref` (with its constants and box tests) of
# ba_pathtracing_fur_torch/ops/cuda/traverse.py at commit 24f22d1: the tests
# any near-to-far walk of a BVH must make, the yardstick of K3's roofline.
# Changed: the rays' hits must be given (no brute force), and the BVH's
# UNIT (ops/bvh.py) is a constant here.
"""The work a near-to-far BVH walk must do for given rays (K3's bound)."""

from __future__ import annotations

import torch

INF = 3.4e38
#: rows of a leaf's unit box (ops/bvh.UNIT)
UNIT = 32
KINDS = {"cone": 16, "tri": 9}  # leaf width W of `bvh.packed` per kind
#: bound on the elements of one [rays, rows] chunk of the plain version
_REF_ELEMS = 1 << 25
#: flops of one test, counted on the kernel's arithmetic (csrc/traverse.cu,
#: compares and min/max included): the slab test of one box (3 axes of 2
#: sub, 2 mul, min, max and the running max/min, then 3 compares and the
#: entry clamp: 28), one KIRK cone row (origin offset 3, six frame
#: projections 30, a/b/c 24, discriminant 4, roots 10, o.v 5, axis slab
#: 4, acceptance 10: 93) and one Möller-Trumbore row (55)
BOX_TEST_FLOPS = 28
LEAF_TEST_FLOPS = {"cone": 93, "tri": 55}
#: the tensor-core cone row (mxu): the six projections (30 flops) on the
#: tensor cores and the rest of the row on the FP32 pipe (p = o.u - b.u in
#: place of the origin offset: 63; b.u, b.v, b.w are a row's, once a leaf).
#: A projection sums MXU_TERMS products of TF32 halves, keyed by the pack's
#: bytes a value: x_hi.f_hi, x_lo.f_hi and, on an f32 row, x_hi.f_lo (a bf16
#: row is exact in TF32); the kernel issues them in MXU_PASSES mma.sync a
#: frame vector (x_hi.f_hi + x_lo.f_hi folded into one pass's depth).
MXU_PROJ_FLOPS = 30
MXU_TERMS = {4: 3, 2: 2}
MXU_PASSES = {4: 2, 2: 1}
MXU_ROW_FLOPS = LEAF_TEST_FLOPS["cone"] - MXU_PROJ_FLOPS
#: rays of one of the kernel's unit-major tiles, and of its ray tiles
#: (csrc/leaf_tiles.cuh UNIT_RAYS, TILE)
UNIT_RAYS, TILE_RAYS = 8, 128


def _slab_entry(o, d, bmin, bmax, t_best):
    """Entry distance of every ray into every box ([R,N], INF where the slab
    test fails or the entry lies beyond t_best): the kernel's box test
    (leaf_tests.cuh::slab), which enters no inverted (padding) box."""
    eps = 1e-20
    inv = 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)
    tnear = torch.full((o.shape[0], bmin.shape[0]), -INF, device=o.device)
    tfar = torch.full_like(tnear, INF)
    for a in range(3):
        t0 = (bmin[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t1 = (bmax[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        tnear = torch.maximum(tnear, torch.minimum(t0, t1))
        tfar = torch.minimum(tfar, torch.maximum(t0, t1))
    hit = (bmin[None, :, 0] <= bmax[None, :, 0]) & (tnear <= tfar) & (tfar >= 0.0) \
        & (tnear <= t_best[:, None])
    return torch.where(hit, torch.clamp(tnear, min=0.0), INF)


def _units_entered(o, d, ub, t_best):
    """Which unit boxes ub [P, 6, U] the rays o, d [P, 3] enter at or before
    t_best [P] (the slab test of `_slab_entry`) -> [P, U] bool."""
    eps = 1e-20
    inv = (1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d))[:, :, None]
    t0 = (ub[:, 0:3] - o[:, :, None]) * inv
    t1 = (ub[:, 3:6] - o[:, :, None]) * inv
    tnear = torch.minimum(t0, t1).amax(1)
    tfar = torch.maximum(t0, t1).amin(1)
    return (ub[:, 0] <= ub[:, 3]) & (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_best[:, None])


def work_ref(o, d, t_max, bvh, kind: str, any_hit: bool = False,
             t_min: float = 1e-4, hit=None, is_any=None, mxu: bool = False) -> dict:
    """The tests that any near-to-far walk of this BVH, pruning a node when
    its entry lies beyond the best hit, must make for these rays: for each
    live ray (t_max > 0; a dead one tests nothing) the root box, both child
    boxes of every inner node entered at or before the ray's final t (a hit
    on a box's face enters it at its t), the unit boxes (`bvh.uboxes`, UNIT
    rows each) of every such leaf, every row of every such unit, and a
    closest hit's own leaf and unit. For an any-hit ray that finds a hit the
    need is one root-to-leaf path (2 depth + 1 boxes), the leaf's unit boxes
    and one row test. Returns totals over the rays (lower bounds of the kernel's
    work) with their flops, and the distinct leaves those tests read (for an
    occluded any-hit ray, the leaf of its row) with their bytes (rows and
    unit boxes). `hit` = (t, row, found) of these rays, where already known
    (the closest hits; for any hit, t of the closest and the accepted row),
    saves the brute force. `is_any` [R] bool (a mixed launch's rays) counts
    each ray as a closest-hit or an any-hit ray by its own flag, in place
    of `any_hit`. A leaf's bytes are its pack's (2 a value for a bf16 pack).
    `mxu` (cone rows by the tensor-core test) splits a row's flops: the
    projections' MXU_PROJ_FLOPS x MXU_TERMS (by the pack's bytes a value)
    as `tf32_flops`, the other MXU_ROW_FLOPS in `flops`; and counts the
    kernel's unit-major mma tiles at their fewest: for each tile of
    TILE_RAYS consecutive rays (the kernel's ray tiles, in the order given)
    and each (leaf, unit) its rays enter, ceil(rays / UNIT_RAYS)
    (`mma_tiles`), and the (ray, unit) entries they hold (`mma_rays`; an
    occluded any-hit ray holds its row's unit)."""
    if is_any is None:
        is_any = torch.full((o.shape[0],), bool(any_hit), device=o.device)
    if hit is None:
        raise ValueError("work_ref: give the rays' hits (the frozen copy has no brute force)")
    t, row, found = hit
    n_inner = bvh.n_leaves - 1
    n_units = bvh.uboxes.shape[2]
    unit_rows = torch.full((n_units,), UNIT, device=o.device)
    unit_rows[-1] = bvh.leaf_size - UNIT * (n_units - 1)
    step = max(1, _REF_ELEMS // bvh.bmin.shape[0])
    inner = leaves = rows = 0
    entered = torch.zeros((bvh.n_leaves,), dtype=torch.bool, device=o.device)
    mxu = mxu and kind == "cone"
    cells = []  # (ray tile, leaf, unit) of every (ray, unit) entry, for the mma tiles
    for s in range(0, o.shape[0], step):
        # an occluded any-hit ray is counted below as one path
        t_fin = torch.where(is_any[s:s + step],
                            torch.where(found[s:s + step], -INF, t_max[s:s + step]), t[s:s + step])
        t_fin = torch.where(t_max[s:s + step] > 0.0, t_fin, -INF)
        e = _slab_entry(o[s:s + step], d[s:s + step], bvh.bmin, bvh.bmax, t_fin)
        opened = e < INF
        # a closest hit's own leaf and unit, whose entry can round an ulp past
        # the row test's t (on a flat leaf the two are equal)
        win = found[s:s + step] & ~is_any[s:s + step] & (t_fin > -INF)
        w_row = row[s:s + step].long()
        wr = win.nonzero()[:, 0]
        opened[wr, n_inner + w_row[wr] // bvh.leaf_size] = True
        inner += int(opened[:, :n_inner].sum())
        leaves += int(opened[:, n_inner:].sum())
        entered |= opened[:, n_inner:].any(0)
        ri, li = opened[:, n_inner:].nonzero(as_tuple=True)
        units = _units_entered(o[s:s + step][ri], d[s:s + step][ri], bvh.uboxes[li], t_fin[ri])
        pw = (win[ri] & (li == w_row[ri] // bvh.leaf_size)).nonzero()[:, 0]
        units[pw, w_row[ri[pw]] % bvh.leaf_size // UNIT] = True
        rows += int((units * unit_rows).sum())
        if mxu:
            pi, ui = units.nonzero(as_tuple=True)
            cells.append(((s + ri[pi]) // TILE_RAYS * bvh.n_leaves + li[pi]) * n_units + ui)
    n_rays = o.shape[0]
    box_tests = int((t_max > 0.0).sum()) + 2 * inner + leaves * n_units
    occluded = found & is_any
    n_found = int(occluded.sum())
    box_tests += n_found * (2 * bvh.depth + n_units)
    rows += n_found
    entered[row[occluded].long() // bvh.leaf_size] = True
    n_entered = int(entered.sum())
    row_flops = MXU_ROW_FLOPS if mxu else LEAF_TEST_FLOPS[kind]
    elem = bvh.packed.element_size()
    mma_tiles = mma_rays = 0
    if mxu:
        occ = occluded.nonzero()[:, 0]
        r_occ = row[occ].long()
        cells.append((occ // TILE_RAYS * bvh.n_leaves + r_occ // bvh.leaf_size) * n_units
                     + r_occ % bvh.leaf_size // UNIT)
        _, n_in = torch.cat(cells).unique(return_counts=True)
        mma_tiles, mma_rays = int((-(-n_in // UNIT_RAYS)).sum()), int(n_in.sum())
    return dict(rays=n_rays, box_tests=box_tests, leaf_row_tests=rows,
                flops=box_tests * BOX_TEST_FLOPS + rows * row_flops,
                tf32_flops=rows * MXU_PROJ_FLOPS * MXU_TERMS[elem] if mxu else 0,
                mma_tiles=mma_tiles, mma_rays=mma_rays,
                leaves_entered=n_entered,
                leaf_bytes=n_entered * (KINDS[kind] * bvh.leaf_size * elem + 6 * n_units * 4))
