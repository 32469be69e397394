# Frozen copy of ba_pathtracing_fur_torch/models/bsdf.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# the untextured material rows the fused path's shade stage reads.
"""Per-ray materials: the material parameters of each ray's hit, read from
the packed `[M, 20]` table (`ops/cuda/shade.pack_mats_table`) as the shade
stage's plain version reads them. Ids are read as jnp reads them
(`material_index`: a negative id counts from the end, and the index
clamps to the table).
"""

from __future__ import annotations

import torch

from .shade_core import CoreMat as MatParams


def material_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The index jnp's gather reads on an axis of length n: a negative index
    counts from the end, and the result clamps to [0, n-1]
    (`scene/texture.jnp_index`)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def material_rows(m: torch.Tensor) -> MatParams:
    """MatParams of `[R, 20]` rows of the packed table (diffuse3 specular3
    volume3 emission3 ior transparency reflectivity roughness bsdf_id
    shader_id hair_alpha hair_beta)."""
    return MatParams(diffuse=m[:, 0:3], specular=m[:, 3:6], volume=m[:, 6:9],
                     emission=m[:, 9:12], ior=m[:, 12], transparency=m[:, 13],
                     reflectivity=m[:, 14], roughness=m[:, 15],
                     bsdf_id=m[:, 16].to(torch.int32), shader_id=m[:, 17].to(torch.int32),
                     hair_alpha=m[:, 18], hair_beta=m[:, 19])


def gather_rows(mats_table: torch.Tensor, mat_id: torch.Tensor) -> MatParams:
    """The untextured material parameters of each ray's hit (mat_id [R]
    int32) from the packed `[M, 20]` table."""
    return material_rows(mats_table[material_index(mat_id, mats_table.shape[0])])


