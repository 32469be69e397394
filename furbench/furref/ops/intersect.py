# Frozen copy of ba_pathtracing_fur_torch/ops/intersect.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# what the reference's progressive sample of the hair ball calls.
"""Ray-primitive intersection on tensors: the exact tests, hit attributes
and primitive bounds.

Counterpart of `ba_pathtracing_fur_tpu/ops/intersect.py`, with the same
arithmetic in the same order:

  * triangles: Möller-Trumbore with |det| < FLT_EPSILON rejected;
  * cones: KIRK::Cylinder::closestIntersection's quadratic, slab clamp and
    root selection (Cylinder.cpp:73-156) with the corrected `a` term of
    isIntersection (Cylinder.cpp:173);
  * bounds: the closed-form cone AABB (Cylinder::computeBounds,
    Cylinder.cpp:306-336).
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm
from ..scene.types import ConePack, TrianglePack

INF = 3.4e38
TRI_EPS = 1.1920929e-7  # FLT_EPSILON, as Light::intersectTriangle uses it


def triangle_interpolate_rows(rp: TrianglePack, point, o, d):
    """Barycentrics at the winning triangle (rows already gathered per ray)
    -> (normal [R,3], uv [R,2], (u, v) [R,2])."""
    v0 = rp.v0
    e1 = rp.v1 - v0
    e2 = rp.v2 - v0
    p = vm.cross(d, e2)
    det = vm.dot(e1, p)[:, None]
    inv_det = 1.0 / torch.where(det.abs() < TRI_EPS, 1.0, det)
    tvec = o - v0
    u = vm.dot(tvec, p)[:, None] * inv_det
    q = vm.cross(tvec, e1)
    v = vm.dot(d, q)[:, None] * inv_det
    w = 1.0 - u - v
    normal = vm.normalize(w * rp.n0 + u * rp.n1 + v * rp.n2)
    uv = w * rp.uv0 + u * rp.uv1 + v * rp.uv2
    return normal, uv, torch.cat([u, v], dim=-1)


def cone_normal_rows(v_ax, base, base_d, slope, point):
    """Cylinder::calcNormal (Cylinder.cpp:230-237) on per-ray rows: the
    radial direction tilted by the slope."""
    t_axis = vm.dot(point, v_ax)[:, None] - base_d[:, None]
    q1 = point - t_axis * v_ax
    n = vm.normalize(q1 - base)
    return vm.normalize(n + slope[:, None] * v_ax)


def cone_texcoord_rows(base, u_ax, v_ax, w_ax, r_base, slope, height, point):
    """Cylinder::calcTcoord (Cylinder.cpp:239-260) on per-ray rows:
    (phi / 2pi, v / height)."""
    rel = point - base
    u = vm.dot(rel, u_ax)
    v = vm.dot(rel, v_ax)
    w = vm.dot(rel, w_ax)
    r = r_base - slope * v
    tmp = torch.clamp(w / torch.where(r.abs() < 1e-12, 1e-12, r), -1.0 + 1e-7, 1.0 - 1e-7)
    phi = torch.where(u < 0.0, 2.0 * math.pi - torch.acos(tmp), torch.acos(tmp))
    return torch.stack([phi / (2.0 * math.pi), v / height], dim=-1)


def cone_aabbs(cones: ConePack):
    """World AABBs of the cones' local bound boxes in closed form: base +
    min/max(0, h v) -/+ r (|u| + |w|) per axis -> ([F,3], [F,3])."""
    radius = (torch.maximum(cones.r_base, cones.r_apex) + 1e-6)[:, None]
    hv = cones.height[:, None] * cones.v
    r_uw = radius * (cones.u.abs() + cones.w.abs())
    lo = cones.base + torch.clamp(hv, max=0.0) - r_uw
    hi = cones.base + torch.clamp(hv, min=0.0) + r_uw
    return lo, hi


def triangle_aabbs(tris: TrianglePack):
    pts = torch.stack([tris.v0, tris.v1, tris.v2], dim=1)
    return pts.amin(dim=1), pts.amax(dim=1)


# ---------------------------------------------------------------------------
# Lights (analytic emitters outside the acceleration structure)
# ---------------------------------------------------------------------------

def tri_t(o, d, a, b, c):
    """Möller-Trumbore t against one triangle per (ray, light) pair
    (Light::intersectTriangle, Light.cpp:13-64; broadcasting) -> (t, ok)."""
    e1 = b - a
    e2 = c - a
    p = vm.cross(d, e2)
    det = vm.dot(e1, p)
    ok = det.abs() > TRI_EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tv = o - a
    u = vm.dot(tv, p) * inv_det
    q = vm.cross(tv, e1)
    v = vm.dot(d, q) * inv_det
    t = vm.dot(e2, q) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > TRI_EPS)
    return t, ok


