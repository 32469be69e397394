"""Brute-force nearest hit against a BVH-less pack: one CUDA kernel
(triangles or cones), with its plain torch twin.

Counterpart of `ba_pathtracing_fur_tpu/ops/pallas/intersect.py`
(`pack_tris_cm`/`pack_cones_cm`, `tri_closest`/`cone_closest`). For each ray
(o, d) it returns (t, idx): the nearest t > t_min over every primitive of a
component-major pack [W, P] (INF on a miss) and its index (the lowest on
equal t; -1 on a miss). There is no t_max in the test, as in the TPU
kernel: the caller takes t < t_max. Rays with t_max <= 0 (dead) skip the
loop and return a miss in both versions.

The arithmetic is that of `_tri_kernel` / `_cone_kernel`: Möller-Trumbore,
and the KIRK cone quadratic with o.v summed x, y, z, `sqrt(max(disc,
1e-12))` and t >= 1e-4. The twin evaluates it chunk by chunk over rays with
the same float32 ops, and the kernel is built without FMA contraction, so
the two agree bit for bit. (`ops/intersect.py`'s grids are not the twin:
their cone test caps t at t_max and takes o.v in another order.)

`closest` dispatches on the device of its tensors: CPU tensors go to
`closest_ref`, CUDA tensors launch `csrc/bruteforce.cu` or raise.
`TRI_LAUNCHES` / `CONE_LAUNCHES` and `REF_CALLS` count which ran.
"""

from __future__ import annotations

import ctypes

import torch

from .. import bvh as bvh_mod
from ..intersect import INF
from ...scene.types import ConePack, TrianglePack

KINDS = {"cone": 16, "tri": 9}  # rows W of the component-major pack per kind
#: bound on the elements of one [rays, prims] chunk of the plain version
_REF_ELEMS = 1 << 24
#: flops of one pair test, counted on csrc/bruteforce.cu (compares and
#: selects included): Möller-Trumbore 55; the cone quadratic 93 as in
#: ops/cuda/traverse.py
PAIR_FLOPS = {"tri": 55, "cone": 93}

TRI_LAUNCHES = 0
CONE_LAUNCHES = 0
REF_CALLS = 0


def pack_cm(pack, kind: str) -> torch.Tensor:
    """[W, P] component-major pack: triangles (v0, e1, e2) per component,
    cones (base, u, v, w per component, slope, r_base, min_d, max_d)."""
    if kind == "tri":
        t: TrianglePack = pack
        rows = [t.v0, t.v1 - t.v0, t.v2 - t.v0]
    else:
        c: ConePack = pack
        rows = [c.base, c.u, c.v, c.w,
                torch.stack([c.slope, c.r_base, c.min_d, c.max_d], dim=1)]
    return torch.cat(rows, dim=1).T.contiguous()


def cone_test(o, d, comp, t_min):
    """`_cone_kernel`'s arithmetic on o, d [R,3] and comp, 16 [1,P] rows ->
    t [R,P], INF where not hit."""
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
    ov = ox * vx + oy * vy + oz * vz

    def ok(t):
        dax = ov + t * dy
        return (t >= 1e-4) & (t > t_min) & (dax >= min_d) & (dax <= max_d)

    t1_ok, t2_ok = ok(t1), ok(t2)
    return torch.where(has_roots & t1_ok, t1,
                       torch.where(has_roots & ~t1_ok & t2_ok, t2, INF))


def closest_ref(o, d, t_max, packed, kind: str, t_min: float = 1e-4):
    """The kernel's plain version, chunked over rays -> (t [R], idx [R])."""
    global REF_CALLS
    REF_CALLS += 1
    comp = [packed[i][None] for i in range(packed.shape[0])]
    n_prims = packed.shape[1]
    if kind == "tri":
        inf = torch.full((1,), INF, device=o.device)
        test = lambda oc, dc: bvh_mod._tri_core(oc, dc, comp, t_min, inf)  # noqa: E731
    else:
        test = lambda oc, dc: cone_test(oc, dc, comp, t_min)  # noqa: E731
    r = o.shape[0]
    t_out = torch.full((r,), INF, device=o.device)
    idx_out = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    if n_prims == 0:
        return t_out, idx_out
    step = max(1, _REF_ELEMS // n_prims)
    for s in range(0, r, step):
        t = test(o[s:s + step], d[s:s + step])
        idx = t.argmin(-1)  # the first index of the minimum
        best = t.gather(-1, idx[:, None])[:, 0]
        found = (best < INF) & (t_max[s:s + step] > 0.0)
        t_out[s:s + step] = torch.where(found, best, INF)
        idx_out[s:s + step] = torch.where(found, idx, -1).to(torch.int32)
    return t_out, idx_out


def _closest_cuda(o, d, t_max, packed, kind: str, t_min: float):
    from ...kernels import load_library
    from .traverse import _check

    global TRI_LAUNCHES, CONE_LAUNCHES
    dev = o.device
    r, n_prims = o.shape[0], packed.shape[1]
    f32 = torch.float32
    for name, x, shape in (("o", o, (r, 3)), ("d", d, (r, 3)), ("t_max", t_max, (r,)),
                           ("packed", packed, (KINDS[kind], n_prims))):
        _check(name, x, shape, f32, dev)
    t_out = torch.empty((r,), dtype=f32, device=dev)
    idx_out = torch.empty((r,), dtype=torch.int32, device=dev)
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = load_library().bruteforce_launch(
        ctypes.c_int(r), p(o), p(d), p(t_max), p(packed), ctypes.c_int(n_prims),
        ctypes.c_int(int(kind == "cone")), ctypes.c_float(t_min), p(t_out), p(idx_out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"bruteforce kernel launch failed: CUDA error {err}")
    if kind == "cone":
        CONE_LAUNCHES += 1
    else:
        TRI_LAUNCHES += 1
    return t_out, idx_out


def closest(o, d, t_max, packed, kind: str, t_min: float = 1e-4):
    """(t [R] INF on a miss, idx [R] int32 -1 on a miss) of rays against a
    component-major pack from `pack_cm`. CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if kind not in KINDS:
        raise ValueError(f"bruteforce: kind must be one of {sorted(KINDS)}, got {kind!r}")
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    if o.device.type == "cpu":
        return closest_ref(o, d, t_max, packed, kind, t_min)
    if o.device.type == "cuda":
        return _closest_cuda(o, d, t_max, packed, kind, t_min)
    raise ValueError(f"bruteforce: no kernel for device {o.device}")
