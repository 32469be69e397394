"""Per-ray material gather.

Counterpart of `ba_pathtracing_fur_tpu/models/bsdf.py::gather_materials`
for untextured scenes: the material row of each ray's hit. Texture fetch
(Material::fetchParameterColor / fetchParameterFloat) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.types import MaterialTable
from .shade_core import CoreMat


def gather_materials(materials: MaterialTable, mat_id: torch.Tensor,
                     textures=None) -> CoreMat:
    """The material parameters of each ray's hit (mat_id [R] int32)."""
    if textures is not None:
        raise NotImplementedError("textured materials are not ported yet "
                                  "(ROADMAP Queue 1 items 4-5, M3/M5)")
    idx = mat_id.long()
    return CoreMat(**{f.name: getattr(materials, f.name)[idx].contiguous()
                      for f in dataclasses.fields(CoreMat)})
