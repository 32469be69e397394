"""BVH traversal: one CUDA kernel (closest or any hit, cone or triangle
leaves), with its plain torch twin.

Counterpart of `ba_pathtracing_fur_tpu/ops/pallas/traverse.py::
traverse_vmem`. For each ray (o, d, t_max) it finds the nearest row of the
BVH's reordered pack with t in (t_min, t_max) and returns `(t, row, found)`:
t is t_max on a miss, row = cluster * leaf_size + within (-1 on a miss).
The any-hit mode stops at the first acceptance and returns t = 0 there.

`traverse` dispatches on the device of its tensors: CPU tensors go to
`traverse_ref` (`brute_force` over every row of the reordered pack with the
leaf tests of `ops/bvh.py`: argmin of t with the lowest row on ties, any
hit as t < t_max), CUDA tensors launch `csrc/traverse.cu` or raise.
`KERNEL_LAUNCHES` and `REF_CALLS` count which of the two ran. `brute_force`
is the plain twin of the streaming traversal (`ops/cuda/stream.py`) too.

Rows: the kernel (the leaf-tile core of `csrc/leaf_tiles.cuh` on the flat
heap: a tile of 128 consecutive rays reads each leaf it enters once into
shared memory) returns the lexicographic minimum (t, row), so its rows
equal the twin's on every ray, exact t ties across clusters included.
`work_ref` counts the box and leaf tests any near-to-far walk of the BVH
must make for given rays: the measure of the kernel's bound.

The streaming kernel's two variants (`ops/cuda/stream.py`) have their
plain versions here too: `brute_force(mxu=True)` tests cone rows by
`_cone_core_mxu`, the JAX package's `_cone_block_mxu` (the six ray.frame
projections as f32 matrix products), and a bf16 pack is tested as its f32
upcast, which is exact.
"""

from __future__ import annotations

import ctypes

import torch

from .. import bvh as bvh_mod
from ..intersect import INF

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

KERNEL_LAUNCHES = 0
REF_CALLS = 0


def _cone_core_mxu(o, d, comp, t_min, t_best):
    """The cone test of the JAX package's `_cone_block_mxu` -> t [R, K], INF
    where invalid: the six ray.frame projections o.u, o.v, o.w, d.u, d.v,
    d.w as f32 matrix products [R, 3] x [3, K], b.u, b.v, b.w as
    bx*ux + by*uy + bz*uz, p = o.u - b.u, then `_cone_core`'s quadratic, its
    axis slab from o.v."""
    (bx, by, bz, ux, uy, uz, vx, vy, vz, wx, wy, wz,
     slope, r_base, min_d, max_d) = comp
    u, v, w = torch.cat([ux, uy, uz]), torch.cat([vx, vy, vz]), torch.cat([wx, wy, wz])
    ou, ov, ow = o @ u, o @ v, o @ w
    dx, dy, dz = d @ u, d @ v, d @ w
    px = ou - (bx * ux + by * uy + bz * uz)
    py = ov - (bx * vx + by * vy + bz * vz)
    pz = ow - (bx * wx + by * wy + bz * wz)

    a = dx * dx + dz * dz - slope * slope * dy * dy
    b = px * dx + pz * dz + r_base * slope * dy - slope * slope * py * dy
    c_lin = r_base - slope * py
    c = px * px + pz * pz - c_lin * c_lin
    disc = b * b - a * c
    has_roots = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    a_safe = torch.where(a.abs() < 1e-12, 1e-12, a)
    t1 = (-b - sq) / a_safe
    t2 = (-b + sq) / a_safe
    t1, t2 = torch.minimum(t1, t2), torch.maximum(t1, t2)

    def axis_ok(t):
        dax = ov + t * dy
        return (dax >= min_d) & (dax <= max_d)

    tb = t_best[:, None]
    t1_ok = (t1 >= 1e-4) & (t1 > t_min) & (t1 < tb) & axis_ok(t1)
    t2_ok = (t2 >= 1e-4) & (t2 > t_min) & (t2 < tb) & axis_ok(t2)
    take1 = has_roots & t1_ok
    take2 = has_roots & ~t1_ok & t2_ok
    return torch.where(take1, t1, torch.where(take2, t2, INF))


def _leaf_fn(kind: str, mxu: bool = False):
    if kind == "cone":
        return _cone_core_mxu if mxu else bvh_mod._cone_core
    return bvh_mod._tri_core


def _rows_cm(bvh: bvh_mod.BVH) -> list:
    """The packed leaf geometry as W tensors of [1, C*K] (row-major), in
    f32 (a bf16 pack upcast, exactly)."""
    c, w, k = bvh.packed.shape
    flat = bvh.packed.permute(1, 0, 2).reshape(w, c * k).float()
    return [flat[i][None] for i in range(w)]


def brute_force(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
                t_min: float = 1e-4, mxu: bool = False):
    """(t, row, found) by brute force over all rows of the reordered pack,
    chunked over rays; `mxu` tests cone rows by `_cone_core_mxu`."""
    comp = _rows_cm(bvh)
    n_rows = comp[0].shape[1]
    leaf = _leaf_fn(kind, mxu)
    step = max(1, _REF_ELEMS // n_rows)
    ts, rows, founds = [], [], []
    for s in range(0, o.shape[0], step):
        tm = t_max[s:s + step]
        t = leaf(o[s:s + step], d[s:s + step], comp, t_min, tm)  # [Rc, P], INF = none
        if any_hit:
            valid = t < INF
            found = valid.any(-1)
            row = valid.to(torch.int8).argmax(-1)  # the lowest valid row
            t_out = torch.where(found, 0.0, tm)
        else:
            row = t.argmin(-1)
            t_best = t.gather(-1, row[:, None])[:, 0]
            found = t_best < INF
            t_out = torch.where(found, t_best, tm)
        ts.append(t_out)
        rows.append(torch.where(found, row, -1).to(torch.int32))
        founds.append(found)
    return torch.cat(ts), torch.cat(rows), torch.cat(founds)


def traverse_ref(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
                 t_min: float = 1e-4):
    """The kernel's plain version: `brute_force`, counted in REF_CALLS."""
    global REF_CALLS
    REF_CALLS += 1
    return brute_force(o, d, t_max, bvh, kind, any_hit, t_min)


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


def work_ref(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
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
        t, row, found = brute_force(o, d, t_max, bvh, kind, any_hit=False, t_min=t_min)
    else:
        t, row, found = hit
    n_inner = bvh.n_leaves - 1
    n_units = bvh.uboxes.shape[2]
    unit_rows = torch.full((n_units,), bvh_mod.UNIT, device=o.device)
    unit_rows[-1] = bvh.leaf_size - bvh_mod.UNIT * (n_units - 1)
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
        units[pw, w_row[ri[pw]] % bvh.leaf_size // bvh_mod.UNIT] = True
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
                     + r_occ % bvh.leaf_size // bvh_mod.UNIT)
        _, n_in = torch.cat(cells).unique(return_counts=True)
        mma_tiles, mma_rays = int((-(-n_in // UNIT_RAYS)).sum()), int(n_in.sum())
    return dict(rays=n_rays, box_tests=box_tests, leaf_row_tests=rows,
                flops=box_tests * BOX_TEST_FLOPS + rows * row_flops,
                tf32_flops=rows * MXU_PROJ_FLOPS * MXU_TERMS[elem] if mxu else 0,
                mma_tiles=mma_tiles, mma_rays=mma_rays,
                leaves_entered=n_entered,
                leaf_bytes=n_entered * (KINDS[kind] * bvh.leaf_size * elem + 6 * n_units * 4))


def require_detached(name: str, *xs) -> None:
    """Raise for rays that require grad: the traversal kernels only pick
    rows and have no backward (`ops/traverse` passes them detached rays and
    recomputes the winner's t in torch), so their outputs carry no grad."""
    if any(x.requires_grad for x in xs):
        raise ValueError(f"{name}: the rays must be detached (the kernel only picks rows "
                         "and has no backward)")


def _check(name, x, shape, dtype, device):
    if x is None:
        raise ValueError(f"traverse: the BVH has no {name} table (attach_bvh and "
                         f"scene_from_numpy make it)")
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"traverse: {name} must be a contiguous {dtype} {shape} tensor "
                         f"on {device}; got {x.dtype} {tuple(x.shape)} on {x.device}")


def _traverse_cuda(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool, t_min: float):
    from ...kernels import load_library

    global KERNEL_LAUNCHES
    dev = o.device
    r = o.shape[0]
    c, k = bvh.n_leaves, bvh.leaf_size
    f32 = torch.float32
    for name, x, shape, dt in (
            ("o", o, (r, 3), f32), ("d", d, (r, 3), f32), ("t_max", t_max, (r,), f32),
            ("bmin", bvh.bmin, (2 * c - 1, 3), f32), ("bmax", bvh.bmax, (2 * c - 1, 3), f32),
            ("packed", bvh.packed, (c, KINDS[kind], k), f32),
            ("uboxes", bvh.uboxes, (c, 6, -(-k // bvh_mod.UNIT)), f32)):
        _check(name, x, shape, dt, dev)
    t_out = torch.empty((r,), dtype=f32, device=dev)
    row_out = torch.empty((r,), dtype=torch.int32, device=dev)
    found_out = torch.empty((r,), dtype=torch.bool, device=dev)
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = load_library().traverse_launch(
        ctypes.c_int(r), p(o), p(d), p(t_max), p(bvh.bmin), p(bvh.bmax), p(bvh.packed),
        p(bvh.uboxes), ctypes.c_int(c), ctypes.c_int(k), ctypes.c_int(int(kind == "cone")),
        ctypes.c_int(int(any_hit)), ctypes.c_float(t_min), p(t_out), p(row_out),
        p(found_out), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return t_out, row_out, found_out


def traverse(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
             t_min: float = 1e-4):
    """(t [R], row [R] int32, found [R] bool) of rays against a BVH. CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if kind not in KINDS:
        raise ValueError(f"traverse: kind must be one of {sorted(KINDS)}, got {kind!r}")
    require_detached("traverse", o, d, t_max)
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    if o.device.type == "cpu":
        return traverse_ref(o, d, t_max, bvh, kind, any_hit, t_min)
    if o.device.type == "cuda":
        return _traverse_cuda(o, d, t_max, bvh, kind, any_hit, t_min)
    raise ValueError(f"traverse: no kernel for device {o.device}")
