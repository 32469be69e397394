"""The LBVH container, its median build, and the leaf tests.

Counterpart of `ba_pathtracing_fur_tpu/ops/bvh.py`. Every build targets the
same implicit complete binary tree over fixed-size leaf clusters:

  * heap layout: node 0 is the root, the children of i are 2i+1 and 2i+2,
    and the `n_leaves` leaves occupy heap indices [n_leaves-1, 2n_leaves-1);
  * leaf j owns rows [j*leaf_size, (j+1)*leaf_size) of the reordered pack,
    and `perm` maps a reordered row to its original primitive id (-1 on
    padding rows);
  * `packed` is the leaf geometry `[n_leaves, W, leaf_size]`, component-
    major within each cluster (W = 9 for triangles: v0, e1, e2; W = 16 for
    cones: base, u, v, w, slope, r_base, min_d, max_d).

`build_sah` is the JAX package's capacity-clamped binned SAH split, a copy
of its host numpy (the same numpy calls on the same float32 data, so the
same permutation), finished on the bounds' device; `build_grid`, its
uniform-grid cell binning, is the same kind of copy. `build` is its morton
clustering in torch on the bounds' device: 30-bit codes of the centroids
and a stable sort, as `jnp.argsort` sorts. `build_median` runs the
JAX package's numpy lexsort split level by level in torch on the bounds'
device (segment min/max, longest axis, stable sort by
key then by segment), so on the same bounds it is bit-identical to the
numpy build, at any size and on any device; it takes the place of the JAX
package's native C++ splitter, whose `nth_element` leaves the same leaf
membership up to ties. Padding rows are inert: zero triangles (det = 0)
and cones with an empty axis slab (min_d = 1 > max_d = -1). Padding leaves
carry inverted boxes. The morton and grid builds fill the slots in order,
so their padding collects in the last leaves, which can be wholly empty;
the median and SAH splits spread it over the leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..scene.types import ConePack, TrianglePack
from .intersect import INF, TRI_EPS

BIG = 3.0e37  # inverted-box fill of padding leaves
#: rows of a leaf under one unit box (unit_boxes): a warp's width
UNIT = 32


@dataclasses.dataclass
class BVH:
    """Implicit complete binary tree over leaf clusters (see module doc)."""

    bmin: torch.Tensor  # [2*n_leaves-1, 3]
    bmax: torch.Tensor  # [2*n_leaves-1, 3]
    perm: torch.Tensor  # [n_leaves*leaf_size] int32
    packed: Optional[torch.Tensor]  # [n_leaves, W, leaf_size] f32
    n_leaves: int  # a power of two
    leaf_size: int
    # leaf clusters per super-cluster of the two-level traversal (K3,
    # ops/cuda/stream.py); 0 = flat (K2, ops/cuda/traverse.py)
    fanout: int = 0
    # kernel layouts cached at attach time (ops/traverse.kernel_layouts):
    # the super-cluster boxes [6, S] and the leaf boxes grouped
    # per super [S, 6, F] of a two-level BVH, and the winner-row AoS table
    # of the reordered pack
    sboxes: Optional[torch.Tensor] = None
    cboxes: Optional[torch.Tensor] = None
    aos_rows: Optional[torch.Tensor] = None
    # the boxes of each leaf's runs of UNIT rows [n_leaves, 6, U] (unit_boxes),
    # which the traversal kernels test before a run's rows
    uboxes: Optional[torch.Tensor] = None
    # one BVH per geometry shard, every tensor stacked on a leading [n_geo]
    # axis (parallel/render.shard_scene_bvh); the ints are the shards' own
    geo_stacked: bool = False
    # a cone pack's `far_rays_inert` fact on the rows the kernels test, set
    # with the kernel layouts (False: not known, and nothing relies on it)
    far_inert: bool = False

    @property
    def depth(self) -> int:
        return self.n_leaves.bit_length() - 1


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# Morton codes (the JAX package's uint32 arithmetic, in int64: every mask is
# below 2^32, so `& mask` also takes the product modulo 2^32)
# ---------------------------------------------------------------------------

def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64, any shape) so they occupy every
    3rd bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


#: per device: [1024, 3] table of _expand_bits_10(i) << (2, 1, 0)
_MORTON_LUT: dict = {}


def morton_codes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit 3D morton codes [N] (int32, as the JAX package's sort keys)
    of points [N,3] normalized into [lo, hi]. The spread of each 10-bit
    coordinate comes from a table, and the three spread words, whose bits
    do not overlap, are summed: two launches where the bit arithmetic takes
    twelve. A NaN coordinate (an entry point of a ray whose direction
    overflows: the Whitted raytracer's shadow rays from a miss at 3.4e38)
    gets cell 0, as XLA converts NaN to an unsigned 0."""
    lut = _MORTON_LUT.get(points.device)
    if lut is None:
        e = _expand_bits_10(torch.arange(1024, dtype=torch.int64))
        lut = torch.stack([e << 2, e << 1, e], 1).to(device=points.device, dtype=torch.int32)
        _MORTON_LUT[points.device] = lut
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((points - lo) / extent, 0.0, 1.0 - 1e-7)
    q = torch.where(torch.isnan(q), 0.0, q)
    return lut.gather(0, (q * 1024.0).to(torch.int64)).sum(1, dtype=torch.int32)


def _seg_ids(bounds: torch.Tensor, n: int) -> torch.Tensor:
    """The segment of each of `n` rows, for segments [bounds[i], bounds[i+1])."""
    counts = bounds[1:] - bounds[:-1]
    return torch.repeat_interleave(torch.arange(counts.shape[0], device=bounds.device),
                                   counts, output_size=n)


def median_split(cent: torch.Tensor, n_leaves: int):
    """The median split of `cent` [N,3] float32, in torch on its device ->
    (order [N] int64, bounds [n_leaves+1] int64). Each level takes
    every segment's centroid min/max (scatter_reduce), its longest axis
    (argmax: the first on ties, as numpy) and a stable sort by the key then
    by the segment: numpy's lexsort((key, seg_of)). The key is
    canonicalised (key + 0.0) first, since a radix sort orders -0.0 before
    +0.0 where numpy keeps index order."""
    n = cent.shape[0]
    dev = cent.device
    order = torch.arange(n, device=dev)
    bounds = torch.tensor([0, n], device=dev)
    for _ in range(n_leaves.bit_length() - 1):
        n_seg = bounds.shape[0] - 1
        seg_of = _seg_ids(bounds, n)
        c = cent[order]
        idx3 = seg_of[:, None].expand(n, 3)
        lo = torch.full((n_seg, 3), BIG, device=dev).scatter_reduce(0, idx3, c, "amin")
        hi = torch.full((n_seg, 3), -BIG, device=dev).scatter_reduce(0, idx3, c, "amax")
        axis = torch.argmax(hi - lo, dim=1)
        key = c.gather(1, axis[seg_of][:, None])[:, 0] + 0.0
        by_key = torch.sort(key, stable=True).indices
        idx = by_key[torch.sort(seg_of[by_key], stable=True).indices]
        order = order[idx]
        mids = bounds[:-1] + (bounds[1:] - bounds[:-1] + 1) // 2
        bounds = torch.cat([torch.stack([bounds[:-1], mids], 1).reshape(-1), bounds[-1:]])
    return order, bounds


def _ranges_to_perm(order, bounds, n_leaves, leaf_size):
    """Scatter per-leaf index ranges into padded leaf slots: row i of
    `order` goes to slot leaf*leaf_size + (i - leaf_start)."""
    counts = bounds[1:] - bounds[:-1]
    if int(counts.max()) > leaf_size:
        raise AssertionError("median split produced oversized leaf")
    n = order.shape[0]
    leaf_of = _seg_ids(bounds, n)
    within = torch.arange(n, device=order.device) - bounds[leaf_of]
    perm = torch.full((n_leaves * leaf_size,), -1, dtype=torch.int64, device=order.device)
    perm[leaf_of * leaf_size + within] = order
    return perm


def _finalize(perm, bmin, bmax, n_leaves, leaf_size):
    """Leaf AABBs over the slot permutation (padding rows take inverted
    boxes), reduced bottom-up into heap order -> (heap bmin, heap bmax)."""
    keep = (perm >= 0)[:, None]
    safe = torch.clamp(perm, min=0)
    sbmin = torch.where(keep, bmin[safe], BIG)
    sbmax = torch.where(keep, bmax[safe], -BIG)
    levels_min = [sbmin.reshape(n_leaves, leaf_size, 3).amin(1)]
    levels_max = [sbmax.reshape(n_leaves, leaf_size, 3).amax(1)]
    while levels_min[0].shape[0] > 1:
        levels_min.insert(0, levels_min[0].reshape(-1, 2, 3).amin(1))
        levels_max.insert(0, levels_max[0].reshape(-1, 2, 3).amax(1))
    return torch.cat(levels_min), torch.cat(levels_max)


def build_median(prim_bmin: torch.Tensor, prim_bmax: torch.Tensor,
                 leaf_size: int = 256) -> BVH:
    """Median-split build on the bounds' device: split prim ranges at the
    centroid median of their longest axis, level by level. prim_bmin /
    prim_bmax: [N,3] float32 tensors."""
    n = prim_bmin.shape[0]
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))
    order, bounds = median_split(0.5 * (prim_bmin + prim_bmax), n_leaves)
    return from_perm(_ranges_to_perm(order, bounds, n_leaves, leaf_size), prim_bmin,
                     prim_bmax, n_leaves, leaf_size)


def from_perm(perm: torch.Tensor, prim_bmin: torch.Tensor, prim_bmax: torch.Tensor,
              n_leaves: int, leaf_size: int) -> BVH:
    """The BVH of a slot permutation (slot -> primitive id, -1 on padding):
    its heap boxes over the primitives' AABBs, on the bounds' device."""
    perm = perm.to(prim_bmin.device)
    hmin, hmax = _finalize(perm.long(), prim_bmin, prim_bmax, n_leaves, leaf_size)
    return BVH(bmin=hmin, bmax=hmax, perm=perm.to(torch.int32), packed=None,
               n_leaves=n_leaves, leaf_size=leaf_size)


def _sah_order(bmin: np.ndarray, bmax: np.ndarray, n_leaves: int, leaf_size: int,
               n_bins: int):
    """The JAX package's binned SAH split (16-bin centroid bins a segment
    and axis, prefix and suffix AABB sweeps, cost SA_L N_L + SA_R N_R, each
    side clamped to its subtree's slot capacity; the median plane when no
    binned plane fits the clamp or the extent is degenerate), in the same
    numpy calls -> (order [N] int64, leaf bounds)."""
    n = bmin.shape[0]
    cent = 0.5 * (bmin + bmax)
    order = np.arange(n)
    bounds = [0, n]
    for level in range(n_leaves.bit_length() - 1):
        cap = (n_leaves >> (level + 1)) * leaf_size  # slots per child subtree
        new_bounds = [0]
        for s, e in zip(bounds[:-1], bounds[1:]):
            seg = order[s:e]
            cnt = e - s
            if cnt <= 1:
                new_bounds.extend([s + (cnt + 1) // 2, e])
                continue
            c = cent[seg]
            k_lo, k_hi = max(cnt - cap, 0), min(cnt, cap)
            k = best = side = None
            clo, chi = c.min(axis=0), c.max(axis=0)
            for axis in range(3):
                ext = chi[axis] - clo[axis]
                if ext <= 0.0:
                    continue
                b = np.minimum((c[:, axis] - clo[axis]) / ext * n_bins,
                               n_bins - 1).astype(np.int64)
                counts = np.bincount(b, minlength=n_bins)
                bb_lo = np.full((n_bins, 3), np.float32(BIG))
                bb_hi = np.full((n_bins, 3), np.float32(-BIG))
                np.minimum.at(bb_lo, b, bmin[seg])
                np.maximum.at(bb_hi, b, bmax[seg])
                lmin = np.minimum.accumulate(bb_lo, axis=0)
                lmax = np.maximum.accumulate(bb_hi, axis=0)
                rmin = np.minimum.accumulate(bb_lo[::-1], axis=0)[::-1]
                rmax = np.maximum.accumulate(bb_hi[::-1], axis=0)[::-1]
                n_l = np.cumsum(counts)[:-1]  # the plane after bin i
                n_r = cnt - n_l

                def area(lo, hi):
                    d = np.maximum(hi - lo, 0.0)
                    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

                cost = area(lmin[:-1], lmax[:-1]) * n_l + area(rmin[1:], rmax[1:]) * n_r
                ok = (n_l >= k_lo) & (n_l <= k_hi)
                if not ok.any():
                    continue
                cost = np.where(ok, cost, np.inf)
                i = int(np.argmin(cost))
                if best is None or cost[i] < best:
                    best = cost[i]
                    k = int(n_l[i])
                    side = (b > i).astype(np.int8)
            if k is None:  # degenerate extent or no clamped plane: the median
                axis = int(np.argmax(chi - clo))
                k = min(max((cnt + 1) // 2, k_lo), k_hi)
                order[s:e] = seg[np.argpartition(c[:, axis], min(k, cnt - 1))]
            else:
                order[s:e] = seg[np.argsort(side, kind="stable")]
            new_bounds.extend([s + k, e])
        bounds = new_bounds
    return order, bounds


def build_sah(prim_bmin: torch.Tensor, prim_bmax: torch.Tensor, leaf_size: int = 256,
              n_bins: int = 16) -> BVH:
    """Binned-SAH build (KIRK's CPU_BVH.cpp:357-461 split family): the
    split on the host in numpy, bit-identical to the JAX package's
    `build_sah`; the slot permutation and the heap boxes on the bounds'
    device. prim_bmin / prim_bmax: [N,3] float32 tensors."""
    n = prim_bmin.shape[0]
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))
    order, bounds = _sah_order(prim_bmin.cpu().numpy(), prim_bmax.cpu().numpy(), n_leaves,
                               leaf_size, n_bins)
    perm = np.full((n_leaves * leaf_size,), -1, np.int64)
    for li, (s, e) in enumerate(zip(bounds[:-1], bounds[1:])):
        if e - s > leaf_size:
            raise AssertionError("SAH split produced oversized leaf")
        perm[li * leaf_size: li * leaf_size + e - s] = order[s:e]
    perm = torch.from_numpy(perm).to(prim_bmin.device)
    hmin, hmax = _finalize(perm, prim_bmin, prim_bmax, n_leaves, leaf_size)
    return BVH(bmin=hmin, bmax=hmax, perm=perm.to(torch.int32), packed=None,
               n_leaves=n_leaves, leaf_size=leaf_size)


def _in_order(order: torch.Tensor, n_leaves: int, leaf_size: int) -> torch.Tensor:
    """The slot permutation that fills the slots in `order`, padding last."""
    perm = torch.full((n_leaves * leaf_size,), -1, dtype=torch.int64, device=order.device)
    perm[:order.shape[0]] = order
    return perm


def build(prim_bmin: torch.Tensor, prim_bmax: torch.Tensor, leaf_size: int = 8) -> BVH:
    """Morton build (the JAX package's `build`, a linearized octree: each
    leaf is a run of the primitives sorted by the 30-bit morton code of
    their centroid in the scene's bounds), in torch on the bounds' device.
    Centroids of one fiber share cells, so the sort is stable, as
    `jnp.argsort` is. prim_bmin / prim_bmax: [N,3] float32 tensors."""
    n = prim_bmin.shape[0]
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))
    codes = morton_codes(0.5 * (prim_bmin + prim_bmax), prim_bmin.amin(0), prim_bmax.amax(0))
    perm = _in_order(torch.argsort(codes, stable=True), n_leaves, leaf_size)
    hmin, hmax = _finalize(perm, prim_bmin, prim_bmax, n_leaves, leaf_size)
    return BVH(bmin=hmin, bmax=hmax, perm=perm.to(torch.int32), packed=None,
               n_leaves=n_leaves, leaf_size=leaf_size)


def build_grid(prim_bmin: torch.Tensor, prim_bmax: torch.Tensor, leaf_size: int = 256,
               resolution: Optional[int] = None) -> BVH:
    """Uniform-grid clustering (UniformGrid.h:12-50): the primitives binned
    by centroid into a G^3 raster of cells (G = ceil((N / leaf_size)^(1/3))
    unless `resolution` is given) and packed into leaves in cell order,
    each leaf's box the tight bound of its contents. The binning is the JAX
    package's float32 numpy on the host; the slot permutation and the heap
    boxes are made on the bounds' device."""
    bmin = prim_bmin.cpu().numpy()
    bmax = prim_bmax.cpu().numpy()
    n = bmin.shape[0]
    cent = 0.5 * (bmin + bmax)
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))
    if resolution is None:
        resolution = max(int(np.ceil((n / max(leaf_size, 1)) ** (1.0 / 3.0))), 1)
    g = int(resolution)
    lo = cent.min(axis=0)
    extent = np.maximum(cent.max(axis=0) - lo, 1e-12)
    ijk = np.minimum((cent - lo) / extent * g, g - 1).astype(np.int64)
    cell = (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]
    order = torch.from_numpy(np.argsort(cell, kind="stable")).to(prim_bmin.device)
    perm = _in_order(order, n_leaves, leaf_size)
    hmin, hmax = _finalize(perm, prim_bmin, prim_bmax, n_leaves, leaf_size)
    return BVH(bmin=hmin, bmax=hmax, perm=perm.to(torch.int32), packed=None,
               n_leaves=n_leaves, leaf_size=leaf_size)


def debug_info(bvh: BVH) -> dict:
    """Structure statistics (TreeAccel::printDebugInfo, TreeAccel.h:80-86:
    node, leaf and depth counts) and the quality measures that predict the
    traversal's cost: the SAH cost (sum of leaf area x leaf count over the
    root's area) and the occupancy. Host numpy, as the JAX package's."""
    n_leaves, k = bvh.n_leaves, bvh.leaf_size
    leaf_base = n_leaves - 1
    lo = bvh.bmin.cpu().numpy()
    hi = bvh.bmax.cpu().numpy()
    counts = (bvh.perm.cpu().numpy().reshape(n_leaves, k) >= 0).sum(axis=1)

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    leaf_area = area(lo[leaf_base:], hi[leaf_base:])
    root_area = float(area(lo[:1], hi[:1])[0])
    return {
        "n_nodes": int(2 * n_leaves - 1),
        "n_leaves": int(n_leaves),
        "leaf_size": int(k),
        "depth": bvh.depth,
        "n_prims": int(counts.sum()),
        "occupancy": float(counts.mean() / k),
        "sah_cost": float((leaf_area * counts).sum() / max(root_area, 1e-30)),
    }


def unit_boxes(lo: torch.Tensor, hi: torch.Tensor, bvh: BVH) -> torch.Tensor:
    """The boxes of each leaf's runs of UNIT rows, [n_leaves, 6, U] (lo xyz,
    hi xyz; U = ceil(leaf_size / UNIT)), from the AABBs lo/hi [N, 3] of the
    reordered pack's rows; padding rows and the rows past leaf_size in the
    last run take inverted boxes."""
    c, k = bvh.n_leaves, bvh.leaf_size
    u = -(-k // UNIT)
    keep = (bvh.perm >= 0)[:, None]

    def runs(x, fill, reduce):
        x = torch.where(keep, x, fill).reshape(c, k, 3)
        x = torch.nn.functional.pad(x, (0, 0, 0, u * UNIT - k), value=fill)
        return reduce(x.reshape(c, u, UNIT, 3), 2)

    lo_u = runs(lo, BIG, lambda x, dim: x.amin(dim))
    hi_u = runs(hi, -BIG, lambda x, dim: x.amax(dim))
    return torch.cat([lo_u, hi_u], dim=2).permute(0, 2, 1).contiguous()


def _take_padded(x: torch.Tensor, safe, keep, pad_val) -> torch.Tensor:
    g = x[safe]
    g[~keep] = pad_val
    return g


def reorder_tris(tris: TrianglePack, bvh: BVH) -> TrianglePack:
    """The pack in leaf-slot order; padding rows are all-zero triangles."""
    safe = torch.clamp(bvh.perm.long(), min=0)
    keep = bvh.perm >= 0
    return TrianglePack(**{f.name: _take_padded(getattr(tris, f.name), safe, keep, 0)
                           for f in dataclasses.fields(TrianglePack)})


def reorder_cones(cones: ConePack, bvh: BVH) -> ConePack:
    """The pack in leaf-slot order; padding rows get an empty axis slab
    (min_d = 1 > max_d = -1), every other field 0."""
    safe = torch.clamp(bvh.perm.long(), min=0)
    keep = bvh.perm >= 0
    out = {f.name: _take_padded(getattr(cones, f.name), safe, keep, 0)
           for f in dataclasses.fields(ConePack)}
    out["min_d"] = _take_padded(cones.min_d, safe, keep, 1.0)
    out["max_d"] = _take_padded(cones.max_d, safe, keep, -1.0)
    return ConePack(**out)


def _pack_comps(comps, n_leaves: int, k: int) -> torch.Tensor:
    """[C, W, K] component-major layout from W [N]-tensors."""
    return torch.stack(comps, dim=1).reshape(n_leaves, k, len(comps)).permute(0, 2, 1) \
        .contiguous()


def pack_tris(tris: TrianglePack, bvh: BVH) -> BVH:
    """The reordered triangles as [C, 9, K] = (v0, e1, e2) per component."""
    v0 = tris.v0
    e1 = tris.v1 - v0
    e2 = tris.v2 - v0
    comps = [v0[:, 0], v0[:, 1], v0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
             e2[:, 0], e2[:, 1], e2[:, 2]]
    return dataclasses.replace(bvh, packed=_pack_comps(comps, bvh.n_leaves, bvh.leaf_size))


#: the pack fact of `far_rays_inert`: the largest |min_d| and |max_d| of a
#: row with a non-empty axial slab, and the largest departure of its frame
#: from orthonormal (a norm's from 1, a pairwise dot's from 0)
FAR_SLAB_MAX = 2.0 ** 64
FAR_FRAME_TOL = 2.0 ** -10


def far_rays_inert(packed: torch.Tensor) -> bool:
    """Does every row of the cone pack [C, 16, K] (the rows K2 and K3 test;
    a bf16 pack as its exact f32 upcast) meet the fact under which no row
    test accepts a ray with |d|inf >= 2^127 (`far_inert_rows`)? The proof
    is in `ops/traverse.py`, beside `any_hit`'s dispatch."""
    return bool(far_inert_rows(packed).all())


def far_inert_rows(packed: torch.Tensor) -> torch.Tensor:
    """[C, K] bool: which rows of the cone pack [C, 16, K] meet the fact of
    `far_rays_inert`. A row meets it when its axial slab is empty (min_d >
    max_d: the padding rows), or when
      * the slab leaves out 0 (min_d > 0 or max_d < 0),
      * |min_d| and |max_d| are at most FAR_SLAB_MAX, and
      * the frame u, v, w is orthonormal within FAR_FRAME_TOL (each norm
        within it of 1, each pairwise dot within it of 0).
    A NaN fails it. One pass over the rows in f32, whose rounding (~1e-7)
    is far inside the proof's margin (it needs the frame's smallest
    singular value above 1/2)."""
    p = packed.float()
    u, v, w = p[:, 3:6], p[:, 6:9], p[:, 9:12]  # [C, 3, K]
    lo, hi = p[:, 14], p[:, 15]
    ok = ((lo > 0.0) | (hi < 0.0)) & (lo.abs() <= FAR_SLAB_MAX) & (hi.abs() <= FAR_SLAB_MAX)
    for a in (u, v, w):
        ok &= ((a * a).sum(1).sqrt() - 1.0).abs() <= FAR_FRAME_TOL
    for a, b in ((u, v), (u, w), (v, w)):
        ok &= (a * b).sum(1).abs() <= FAR_FRAME_TOL
    return ok | (lo > hi)


def pack_cones(cones: ConePack, bvh: BVH) -> BVH:
    """The reordered cones as [C, 16, K] = (base, u, v, w per component,
    slope, r_base, min_d, max_d)."""
    comps = [cones.base[:, 0], cones.base[:, 1], cones.base[:, 2],
             cones.u[:, 0], cones.u[:, 1], cones.u[:, 2],
             cones.v[:, 0], cones.v[:, 1], cones.v[:, 2],
             cones.w[:, 0], cones.w[:, 1], cones.w[:, 2],
             cones.slope, cones.r_base, cones.min_d, cones.max_d]
    return dataclasses.replace(bvh, packed=_pack_comps(comps, bvh.n_leaves, bvh.leaf_size))


# ---------------------------------------------------------------------------
# Leaf tests: o, d [R,3]; comp a list of [R,K] (or [1,P]) tensors
# ---------------------------------------------------------------------------

def _tri_core(o, d, comp, t_min, t_best):
    """Component-wise Möller-Trumbore (the arithmetic of
    intersect.triangle_hit_grid) -> t [R,K], INF where invalid."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = comp
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    near_zero = det.abs() < TRI_EPS
    inv_det = 1.0 / torch.where(near_zero, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (~near_zero & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_best[:, None]))
    return torch.where(ok, t, INF)


def _cone_core(o, d, comp, t_min, t_best):
    """Component-wise KIRK cone quadratic (the arithmetic of
    intersect.cone_hit_grid, with o.v summed y, x, z as the JAX package's
    `_cone_core` does) -> t [R,K], INF where invalid."""
    (bx, by, bz, ux, uy, uz, vx, vy, vz, wx, wy, wz,
     slope, r_base, min_d, max_d) = comp
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    ddx, ddy, ddz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    rx, ry, rz = ox - bx, oy - by, oz - bz
    px = rx * ux + ry * uy + rz * uz
    py = rx * vx + ry * vy + rz * vz
    pz = rx * wx + ry * wy + rz * wz
    dx = ddx * ux + ddy * uy + ddz * uz
    dy = ddx * vx + ddy * vy + ddz * vz
    dz = ddx * wx + ddy * wy + ddz * wz

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
    ov = oy * vy + ox * vx + oz * vz

    def axis_ok(t):
        dax = ov + t * dy
        return (dax >= min_d) & (dax <= max_d)

    tb = t_best[:, None]
    t1_ok = (t1 >= 1e-4) & (t1 > t_min) & (t1 < tb) & axis_ok(t1)
    t2_ok = (t2 >= 1e-4) & (t2 > t_min) & (t2 < tb) & axis_ok(t2)
    take1 = has_roots & t1_ok
    take2 = has_roots & ~t1_ok & t2_ok
    return torch.where(take1, t1, torch.where(take2, t2, INF))
