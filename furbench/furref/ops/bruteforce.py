# Frozen copy of ba_pathtracing_fur_torch/ops/bruteforce.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it).
"""The SoA hit record of a wavefront and the primitive-kind ids.

Counterpart of the `Hit` dataclass and the `PRIM_*` ids of
`ba_pathtracing_fur_tpu/ops/bruteforce.py` (the KIRK::Intersection analog,
Intersection.h:11-48). The brute-force all-pairs grids the port runs for
BVH-less packs live in `ops/intersect.py` and are dispatched from
`ops/traverse.py`.
"""

from __future__ import annotations

import dataclasses

import torch

PRIM_NONE = -1
PRIM_TRI = 0
PRIM_CONE = 1


@dataclasses.dataclass
class Hit:
    """Nearest scene hit per ray."""

    t: torch.Tensor  # [R], INF where there is no hit
    valid: torch.Tensor  # [R] bool: scene geometry hit
    prim_type: torch.Tensor  # [R] int32: -1 none, 0 triangle, 1 cone
    prim_id: torch.Tensor  # [R] int32: the primitive's id in the original pack
    mat_id: torch.Tensor  # [R] int32
    position: torch.Tensor  # [R,3]
    normal: torch.Tensor  # [R,3]
    uv: torch.Tensor  # [R,2]
    enter: torch.Tensor  # [R] bool: the cone's entering (nearer) root
    # fiber frame at the hit (cones: their own frame; triangles: the stamped
    # frame of fur-as-triangles mode, Object.h:33-38)
    fiber_u: torch.Tensor  # [R,3]
    fiber_v: torch.Tensor
    fiber_w: torch.Tensor
