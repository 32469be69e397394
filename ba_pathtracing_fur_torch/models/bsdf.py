"""Per-ray material gather.

Counterpart of `ba_pathtracing_fur_tpu/models/bsdf.py::gather_materials`
for untextured scenes: the material row of each ray's hit, from the packed
`[M, 20]` table (`ops/cuda/shade.pack_mats_table`), indexed as jnp indexes
it. Texture fetch (Material::fetchParameterColor / fetchParameterFloat) is
not ported yet.
"""

from __future__ import annotations

import torch

from .shade_core import CoreMat


def require_untextured(textures) -> None:
    """Raise for a textured scene: the gather cannot fetch textures yet."""
    if textures is not None:
        raise NotImplementedError("textured materials are not ported yet "
                                  "(ROADMAP Queue 1 items 4-5, M3/M5)")


def material_index(mat_id: torch.Tensor, n_mats: int) -> torch.Tensor:
    """The row jnp's gather reads for each id: a negative id counts from
    the end, and the index clamps to the table."""
    idx = mat_id.long()
    return torch.where(idx < 0, idx + n_mats, idx).clamp(0, n_mats - 1)


def material_rows(m: torch.Tensor) -> CoreMat:
    """CoreMat of `[R, 20]` rows of the packed table (diffuse3 specular3
    volume3 emission3 ior transparency reflectivity roughness bsdf_id
    shader_id hair_alpha hair_beta)."""
    return CoreMat(diffuse=m[:, 0:3], specular=m[:, 3:6], volume=m[:, 6:9],
                   emission=m[:, 9:12], ior=m[:, 12], transparency=m[:, 13],
                   reflectivity=m[:, 14], roughness=m[:, 15],
                   bsdf_id=m[:, 16].to(torch.int32), shader_id=m[:, 17].to(torch.int32),
                   hair_alpha=m[:, 18], hair_beta=m[:, 19])


def gather_materials(mats_table: torch.Tensor, mat_id: torch.Tensor) -> CoreMat:
    """The material parameters of each ray's hit (mat_id [R] int32) on an
    untextured scene (`require_untextured`)."""
    return material_rows(mats_table[material_index(mat_id, mats_table.shape[0])])
