# Frozen copy of ba_pathtracing_fur_torch/scene/mesh.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# what the reference's progressive sample of the hair ball calls.
"""Procedural fur growth of the hair ball.

Counterpart of `ba_pathtracing_fur_tpu/scene/mesh.py`:
`grow_fur_fibers_along_torch` grows the hair ball on the tensors' device
from supplied draws, and

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


