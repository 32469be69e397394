"""Procedural fur growth (host-side numpy).

Counterpart of `ba_pathtracing_fur_tpu/scene/mesh.py`, holding what the fur
patch uses. The same `np.random.RandomState` stream and the same float32
arithmetic, so one seed gives bit-identical fibers in both packages.

  * Mesh::addFurToFaces (Mesh.cpp:82-148): N fibers per face at uniform
    random barycentric points, grown upward with log-decaying segment
    heights log(i)/90, a fixed +0.06 z lean per segment, tapering radius
    r -= r/(i+5), tip radius forced to 0.001, base sunk by 0.003 in y.
  * CPU::Scene fiber -> cone-chain conversion (CPU_Scene.cpp:104-145): base
    pulled back 0.008 segment to hide joints, base radius shrunk 5% (10%
    beyond the 4th segment).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FurFibers(NamedTuple):
    """[N, V] fiber polylines (the furFiber struct, Mesh.h:43-47) in SoA."""

    positions: np.ndarray  # [N, V, 3]
    radii: np.ndarray  # [N, V]


def random_barycentric(rs: np.random.RandomState, n: int) -> np.ndarray:
    """Uniform points in a triangle via the fold trick (Mesh.cpp:108-110)
    -> [n, 2] (r1, r2)."""
    r = rs.rand(n, 2).astype(np.float32)
    flip = r.sum(axis=1) >= 1.0
    r[flip] = 1.0 - r[flip]
    return r


def grow_fur_fibers(faces: np.ndarray, fibers_per_face: int, num_fiber_verts: int,
                    fiber_radius: float, seed: int = 0) -> FurFibers:
    """addFurToFaces parity. faces: [F, 3, 3] triangle corner positions."""
    if fiber_radius <= 0:
        raise ValueError("fiber radius must be > 0")
    rs = np.random.RandomState(seed)
    n = faces.shape[0] * fibers_per_face

    a = np.repeat(faces[:, 0], fibers_per_face, axis=0)
    b = np.repeat(faces[:, 1], fibers_per_face, axis=0)
    c = np.repeat(faces[:, 2], fibers_per_face, axis=0)
    r12 = random_barycentric(rs, n)
    pos0 = a + r12[:, :1] * (b - a) + r12[:, 1:2] * (c - a)
    pos0[:, 1] -= 0.003  # sink the base below the surface (Mesh.cpp:114)

    v = num_fiber_verts
    positions = np.zeros((n, v, 3), np.float32)
    radii = np.zeros((n, v), np.float32)
    positions[:, 0] = pos0
    radii[:, 0] = fiber_radius

    pos = pos0.copy()
    radius = np.full(n, fiber_radius, np.float32)
    k = 1
    for i in range(num_fiber_verts, 1, -1):  # Mesh.cpp:124-139
        offset_y = np.log(float(i)) / 90.0
        point = pos + np.array([0.0, offset_y, 0.06], np.float32)
        radius = radius - radius / (i + 5.0)
        positions[:, k] = point
        radii[:, k] = radius
        pos = point
        k += 1
    radii[:, -1] = 0.001  # forced tip radius (Mesh.cpp:142)
    return FurFibers(positions, radii)


def fibers_to_cone_chain(fibers: FurFibers):
    """CPU_Scene.cpp:122-143 parity: consecutive vertex pairs -> cones with
    the joint-hiding base offset and the base-radius shrink. Returns
    (base [M,3], apex [M,3], r_base [M], r_apex [M]) with M = N*(V-1)."""
    p = fibers.positions
    r = fibers.radii
    v = r.shape[1]
    base = p[:, :-1]  # [N, V-1, 3]
    apex = p[:, 1:]
    seg = apex - base
    base = base - 0.008 * seg  # hide cone joints (CPU_Scene.cpp:133)
    shrink = np.where(np.arange(v - 1) > 3, 0.1, 0.05).astype(np.float32)  # :135
    r_base = r[:, :-1] * (1.0 - shrink[None, :])
    r_apex = r[:, 1:]
    return (base.reshape(-1, 3), apex.reshape(-1, 3),
            r_base.reshape(-1), r_apex.reshape(-1))
