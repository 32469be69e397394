"""The LBVH container, its host-side median build, and the leaf tests.

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

The median build runs on the host with the numpy lexsort splitter of the
JAX package (bit-identical partitions); its native C++ splitter is not
ported (ROADMAP M9). Padding rows are inert: zero triangles (det = 0) and
cones with an empty axis slab (min_d = 1 > max_d = -1). Padding leaves carry
inverted boxes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..scene.types import ConePack, TrianglePack
from .intersect import INF, TRI_EPS

BIG = 3.0e37  # inverted-box fill of padding leaves


@dataclasses.dataclass
class BVH:
    """Implicit complete binary tree over leaf clusters (see module doc)."""

    bmin: torch.Tensor  # [2*n_leaves-1, 3]
    bmax: torch.Tensor  # [2*n_leaves-1, 3]
    perm: torch.Tensor  # [n_leaves*leaf_size] int32
    packed: Optional[torch.Tensor]  # [n_leaves, W, leaf_size] f32
    n_leaves: int  # a power of two
    leaf_size: int
    # leaf clusters per super-cluster of the JAX two-level traversal; 0 =
    # flat. The heap walk of the port does not read it (ROADMAP K3).
    fanout: int = 0

    @property
    def depth(self) -> int:
        return self.n_leaves.bit_length() - 1


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _ranges_to_perm(order, bounds, n_leaves, leaf_size):
    """Scatter per-leaf index ranges into padded leaf slots: row i of
    `order` goes to slot leaf*leaf_size + (i - leaf_start)."""
    order = np.asarray(order, np.int64)
    bounds = np.asarray(bounds, np.int64)
    counts = np.diff(bounds)
    if counts.max(initial=0) > leaf_size:
        raise AssertionError("median split produced oversized leaf")
    n = order.shape[0]
    leaf_of = np.repeat(np.arange(n_leaves, dtype=np.int64), counts)
    within = np.arange(n, dtype=np.int64) - bounds[leaf_of]
    perm = np.full((n_leaves * leaf_size,), -1, np.int64)
    perm[leaf_of * leaf_size + within] = order
    return perm


def _finalize_host(perm, bmin, bmax, n_leaves, leaf_size) -> BVH:
    """Leaf AABBs over the slot permutation, reduced bottom-up into heap
    order (padding rows take inverted boxes)."""
    keep = perm >= 0
    safe = np.maximum(perm, 0)
    sbmin = bmin[safe]
    sbmax = bmax[safe]
    sbmin[~keep] = np.float32(BIG)
    sbmax[~keep] = np.float32(-BIG)
    lmin = sbmin.reshape(n_leaves, leaf_size, 3).min(axis=1)
    lmax = sbmax.reshape(n_leaves, leaf_size, 3).max(axis=1)
    levels_min, levels_max = [lmin], [lmax]
    while levels_min[0].shape[0] > 1:
        levels_min.insert(0, levels_min[0].reshape(-1, 2, 3).min(axis=1))
        levels_max.insert(0, levels_max[0].reshape(-1, 2, 3).max(axis=1))
    return BVH(bmin=torch.from_numpy(np.concatenate(levels_min, 0)),
               bmax=torch.from_numpy(np.concatenate(levels_max, 0)),
               perm=torch.from_numpy(perm.astype(np.int32)), packed=None,
               n_leaves=n_leaves, leaf_size=leaf_size)


def build_median(prim_bmin, prim_bmax, leaf_size: int = 256) -> BVH:
    """Host-side median-split build: split prim ranges at the centroid
    median of their longest axis, level by level (one vectorized lexsort
    pass per level). prim_bmin/prim_bmax: [N,3] float32 (numpy or CPU
    tensors)."""
    bmin = np.asarray(prim_bmin, np.float32)
    bmax = np.asarray(prim_bmax, np.float32)
    n = bmin.shape[0]
    cent = 0.5 * (bmin + bmax)
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))

    order = np.arange(n, dtype=np.int64)
    bounds = np.array([0, n], dtype=np.int64)
    for _ in range(n_leaves.bit_length() - 1):
        counts = np.diff(bounds)
        seg_of = np.repeat(np.arange(counts.shape[0]), counts)
        c = cent[order]
        n_seg = counts.shape[0]
        lo = np.full((n_seg, 3), np.float32(BIG))
        hi = np.full((n_seg, 3), np.float32(-BIG))
        np.minimum.at(lo, seg_of, c)
        np.maximum.at(hi, seg_of, c)
        axis = np.argmax(hi - lo, axis=1)
        key = c[np.arange(n), axis[seg_of]]
        idx = np.lexsort((key, seg_of))  # sorted within each segment
        order = order[idx]
        mids = bounds[:-1] + (counts + 1) // 2
        bounds = np.sort(np.concatenate([bounds, mids]))
    perm = _ranges_to_perm(order, bounds, n_leaves, leaf_size)
    return _finalize_host(perm, bmin, bmax, n_leaves, leaf_size)


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
