# Frozen copy of ba_pathtracing_fur_torch/ops/bvh.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# the morton codes and the leaf tests that the reference's own search (ops/traverse.py)
# takes; the BVH container, its builds and packs are left out.
"""Morton codes and the cone and triangle leaf tests of the port's BVH
module (`ops/bvh.py`), the counterparts of `ba_pathtracing_fur_tpu/ops/bvh.py`'s."""

from __future__ import annotations

import torch

from .intersect import INF, TRI_EPS


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
