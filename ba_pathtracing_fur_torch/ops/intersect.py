"""Ray-primitive intersection on tensors: all-pairs grids, hit attributes
and primitive bounds.

Counterpart of `ba_pathtracing_fur_tpu/ops/intersect.py`, with the same
arithmetic in the same order:

  * triangles: Möller-Trumbore with |det| < FLT_EPSILON rejected;
  * cones: KIRK::Cylinder::closestIntersection's quadratic, slab clamp and
    root selection (Cylinder.cpp:73-156) with the corrected `a` term of
    isIntersection (Cylinder.cpp:173);
  * bounds: the closed-form cone AABB (Cylinder::computeBounds,
    Cylinder.cpp:306-336) and its centroid;
  * lights: the analytic ray x light hits of all four kinds
    (Point/Quad/Spot/SunLight::isIntersection), `light_hit_grid`.

The grids are `[R, P]`: callers bound R·P by chunking over rays.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import vecmath as vm
from ..scene.types import (
    LIGHT_POINT, LIGHT_QUAD, LIGHT_SPOT, ConePack, LightPack, TrianglePack,
)

INF = 3.4e38
TRI_EPS = 1.1920929e-7  # FLT_EPSILON, as Light::intersectTriangle uses it


def triangle_hit_grid(o, d, tris: TrianglePack, t_min, t_max):
    """All-pairs ray x triangle hits. o, d: [R,3]; t_max a float or [R,1].
    Returns (t [R,T] with INF where invalid, u, v, valid)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1 = tris.v1 - tris.v0
    e2 = tris.v2 - tris.v0
    v0x, v0y, v0z = tris.v0[None, :, 0], tris.v0[None, :, 1], tris.v0[None, :, 2]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
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
    valid = (~near_zero & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min) & (t < t_max))
    return torch.where(valid, t, INF), u, v, valid


def triangle_interpolate(tris: TrianglePack, tri_id, point, o, d):
    """`triangle_interpolate_rows` on the rows `tri_id` of `tris`."""
    tri_id = tri_id.long()
    return triangle_interpolate_rows(TrianglePack(**{
        f.name: getattr(tris, f.name)[tri_id] for f in dataclasses.fields(TrianglePack)}),
        point, o, d)


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


def cone_hit_grid(o, d, cones: ConePack, t_min, t_max, ray_eps=1e-4):
    """All-pairs ray x cone hits with KIRK root selection.
    Returns (t [R,F] with INF where invalid, enter [R,F], valid [R,F])."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    rdx, rdy, rdz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    bx, by, bz = cones.base[None, :, 0], cones.base[None, :, 1], cones.base[None, :, 2]
    uxx, uxy, uxz = cones.u[None, :, 0], cones.u[None, :, 1], cones.u[None, :, 2]
    vxx, vxy, vxz = cones.v[None, :, 0], cones.v[None, :, 1], cones.v[None, :, 2]
    wxx, wxy, wxz = cones.w[None, :, 0], cones.w[None, :, 1], cones.w[None, :, 2]
    rx, ry, rz = ox - bx, oy - by, oz - bz
    px = rx * uxx + ry * uxy + rz * uxz
    py = rx * vxx + ry * vxy + rz * vxz
    pz = rx * wxx + ry * wxy + rz * wxz
    dx = rdx * uxx + rdy * uxy + rdz * uxz
    dy = rdx * vxx + rdy * vxy + rdz * vxz
    dz = rdx * wxx + rdy * wxy + rdz * wxz

    slope = cones.slope[None]
    r_base = cones.r_base[None]
    a = dx * dx + dz * dz - slope * slope * dy * dy  # Cylinder.cpp:173
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

    # slab clamp on the axis coordinate dot(v, o + t d) in [min_d, max_d]
    o_ax = ox * vxx + oy * vxy + oz * vxz
    d_ax = rdx * vxx + rdy * vxy + rdz * vxz

    def axis_ok(t):
        dax = o_ax + t * d_ax
        return (dax >= cones.min_d[None]) & (dax <= cones.max_d[None])

    t1_ok = (t1 >= ray_eps) & (t1 > t_min) & (t1 < t_max) & axis_ok(t1)
    t2_ok = (t2 >= ray_eps) & (t2 > t_min) & (t2 < t_max) & axis_ok(t2)
    take_t1 = has_roots & t1_ok
    take_t2 = has_roots & ~t1_ok & t2_ok
    t = torch.where(take_t1, t1, torch.where(take_t2, t2, INF))
    return t, take_t1, take_t1 | take_t2


def cone_normal(cones: ConePack, cone_id, point):
    """`cone_normal_rows` on the rows `cone_id` of `cones`."""
    i = cone_id.long()
    return cone_normal_rows(cones.v[i], cones.base[i], cones.base_d[i], cones.slope[i], point)


def cone_texcoord(cones: ConePack, cone_id, point):
    """`cone_texcoord_rows` on the rows `cone_id` of `cones`."""
    i = cone_id.long()
    return cone_texcoord_rows(cones.base[i], cones.u[i], cones.v[i], cones.w[i],
                              cones.r_base[i], cones.slope[i], cones.height[i], point)


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


def ray_aabb(o, inv_d, bmin, bmax, t_max):
    """The slab test: o, inv_d [..., 3], bmin/bmax broadcastable -> (hit
    mask, t_near)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_max), tnear


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


def cone_centroids(cones: ConePack):
    """Centroids of `cone_aabbs` in closed form: base + 0.5 height v."""
    return cones.base + 0.5 * cones.height[:, None] * cones.v


def triangle_centroids(tris: TrianglePack):
    lo, hi = triangle_aabbs(tris)
    return 0.5 * (lo + hi)


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


def light_hit_grid(o, d, lights: LightPack):
    """All-pairs ray x light analytic intersections: o, d [R,3] ->
    (t [R,L] with INF where not hit, valid [R,L]). Per kind as
    Point/Quad/Spot/SunLight::isIntersection: the point light's facing
    precondition (Light.cpp:174) and chosen root -0.5*(b+sqrt(disc))/a
    (Light.cpp:186); the quad's triangles (v0,v1,v3) then (v2,v3,v1), the
    second overwriting t (Light.cpp:231); the spot's disk about its position
    across its direction; the sun never hit (Light.cpp:497-501)."""
    ro = o[:, None]  # [R,1,3]
    rd = d[:, None]
    pos = lights.position[None]  # [1,L,3]
    kind = lights.kind[None]

    # point: a sphere of the light's radius
    radius_sq = (lights.radius ** 2)[None]
    oc = ro - pos
    facing_away = vm.dot(rd, oc) > 0.0
    a = vm.dot(rd, rd)
    b = 2.0 * vm.dot(rd, oc)
    c = vm.dot(pos, pos) + vm.dot(ro, ro) - 2.0 * vm.dot(ro, pos) - radius_sq
    disc = b * b - 4.0 * a * c
    point_ok = (radius_sq > 0.0) & ~facing_away & (disc >= 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    t_point = -0.5 * (b + sq) / torch.where(a.abs() < 1e-12, 1e-12, a)

    # quad: two triangles, the second test overwriting t on success
    v = lights.verts[None]  # [1,L,4,3]
    tq1, ok1 = tri_t(ro, rd, v[..., 0, :], v[..., 1, :], v[..., 3, :])
    tq2, ok2 = tri_t(ro, rd, v[..., 2, :], v[..., 3, :], v[..., 1, :])
    t_quad = torch.where(ok2, tq2, tq1)
    quad_ok = ok1 | ok2

    # spot: a disk of the light's radius about its position, across its direction
    e1, e2 = vm.orthonormal_basis(lights.direction[None])
    p = vm.cross(rd, e2)
    det = vm.dot(e1, p)
    ok = det.abs() > TRI_EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = ro - pos
    uu = vm.dot(tvec, p) * inv_det
    q = vm.cross(tvec, e1)
    vv = vm.dot(rd, q) * inv_det
    t_spot = vm.dot(e2, q) * inv_det
    spot_ok = (ok & (uu * uu + vv * vv <= lights.radius[None] ** 2) & (t_spot > TRI_EPS)
               & (lights.radius[None] > 0.0))

    t = torch.where(kind == LIGHT_POINT, t_point,
                    torch.where(kind == LIGHT_QUAD, t_quad,
                                torch.where(kind == LIGHT_SPOT, t_spot, INF)))
    valid = torch.where(kind == LIGHT_POINT, point_ok,
                        torch.where(kind == LIGHT_QUAD, quad_ok,
                                    (kind == LIGHT_SPOT) & spot_ok))
    return torch.where(valid, t, INF), valid
