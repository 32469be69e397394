"""Procedural fur growth.

Counterpart of `ba_pathtracing_fur_tpu/scene/mesh.py`, holding what the fur
patch and the hair ball use. The numpy functions draw the same
`np.random.RandomState` stream with the same float32 arithmetic, so one
seed gives bit-identical fibers in both packages; `grow_fur_fibers_along_
torch` grows the hair ball on the tensors' device from supplied draws.

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
import torch


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


def grow_fur_fibers_along(base_points: np.ndarray, directions: np.ndarray,
                          num_fiber_verts: int, fiber_radius: float,
                          seed: int = 0, lean: float = 0.25) -> FurFibers:
    """Growth along per-fiber directions (the hair-ball workload): the
    log-decay segment lengths and radius taper of addFurToFaces, grown
    along `directions` with a small random lean instead of world +y/+z."""
    rs = np.random.RandomState(seed)
    n = base_points.shape[0]
    d = directions / np.maximum(np.linalg.norm(directions, axis=-1, keepdims=True), 1e-12)
    lean_vec = rs.randn(n, 3).astype(np.float32) * lean
    lean_vec -= d * np.sum(lean_vec * d, axis=-1, keepdims=True)

    v = num_fiber_verts
    positions = np.zeros((n, v, 3), np.float32)
    radii = np.zeros((n, v), np.float32)
    positions[:, 0] = base_points - 0.003 * d
    radii[:, 0] = fiber_radius

    pos = positions[:, 0].copy()
    radius = np.full(n, fiber_radius, np.float32)
    k = 1
    for i in range(num_fiber_verts, 1, -1):
        step = np.log(float(i)) / 90.0
        grow_dir = d + lean_vec * (k / max(v - 1, 1))
        grow_dir /= np.maximum(np.linalg.norm(grow_dir, axis=-1, keepdims=True), 1e-12)
        point = pos + step * grow_dir * 3.0
        radius = radius - radius / (i + 5.0)
        positions[:, k] = point
        radii[:, k] = radius
        pos = point
        k += 1
    radii[:, -1] = 0.001
    return FurFibers(positions, radii)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def grow_fur_fibers_along_torch(base_points: torch.Tensor, directions: torch.Tensor,
                                lean_raw: torch.Tensor, num_fiber_verts: int,
                                fiber_radius: float) -> FurFibers:
    """`grow_fur_fibers_along` on tensors, on their device, with the random
    lean supplied (the JAX package's `grow_fur_fibers_along_jnp`)."""
    d = directions / torch.clamp(_norm(directions), min=1e-12)
    lean_vec = lean_raw - d * (lean_raw * d).sum(-1, keepdim=True)
    v = num_fiber_verts
    pos = base_points - 0.003 * d
    radius = torch.full((base_points.shape[0],), fiber_radius, dtype=torch.float32,
                        device=base_points.device)
    positions, radii = [pos], [radius]
    k = 1
    for i in range(v, 1, -1):
        step = float(np.float32(np.log(float(i)) / 90.0))
        gd = d + lean_vec * (k / max(v - 1, 1))
        gd = gd / torch.clamp(_norm(gd), min=1e-12)
        pos = pos + step * gd * 3.0
        radius = radius - radius / (i + 5.0)
        positions.append(pos)
        radii.append(radius)
        k += 1
    radii[-1] = torch.full_like(radius, 0.001)
    return FurFibers(torch.stack(positions, dim=1), torch.stack(radii, dim=1))


def fibers_to_cone_chain(fibers: FurFibers):
    """CPU_Scene.cpp:122-143 parity: consecutive vertex pairs -> cones with
    the joint-hiding base offset and the base-radius shrink. Returns
    (base [M,3], apex [M,3], r_base [M], r_apex [M]) with M = N*(V-1), as
    numpy arrays or tensors like the fibers."""
    p = fibers.positions
    r = fibers.radii
    v = r.shape[1]
    base = p[:, :-1]  # [N, V-1, 3]
    apex = p[:, 1:]
    seg = apex - base
    base = base - 0.008 * seg  # hide cone joints (CPU_Scene.cpp:133)
    shrink = np.where(np.arange(v - 1) > 3, 0.1, 0.05).astype(np.float32)  # :135
    if isinstance(r, torch.Tensor):
        shrink = torch.from_numpy(shrink).to(r.device)
    r_base = r[:, :-1] * (1.0 - shrink[None, :])
    r_apex = r[:, 1:]
    return (base.reshape(-1, 3), apex.reshape(-1, 3),
            r_base.reshape(-1), r_apex.reshape(-1))
