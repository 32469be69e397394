"""Per-ray materials and the surface BSDFs.

Counterpart of `ba_pathtracing_fur_tpu/models/bsdf.py`:

  * `gather_materials`: the material parameters of each ray's hit, with
    the textured slots resolved (Material::fetchParameterColor /
    fetchParameterFloat, Material.h:153-216): a colour-slot texture replaces
    the value, a float-slot texture gives the length of the fetched RGBA
    (Material.cpp:15-23). `gather_rows` reads untextured rows from the
    packed `[M, 20]` table (`ops/cuda/shade.pack_mats_table`), and
    `fetch_textures` resolves their textured slots, as the shade stage's
    plain version does. Ids are read as jnp reads them
    (`material_index`: a negative id counts from the end, and the index
    clamps to the table).
  * `sample_surface`, `is_delta`, `eval_pdf`, `sample_pdf`,
    `evaluate_light`: the 9 surface BSDFs (Bsdf.cpp:179-456) with the JAX
    package's signatures, over the plain-torch shading body of
    `models/shade_core.py`, which the fused path's plain version runs too.

Conventions as the reference's: `wi` is the counter ray -normalize(ray
direction); the reflectance is f/|cos| style, as each BSDF returns it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..scene.texture import fetch_bilinear, jnp_index as material_index
from ..scene.types import MaterialTable
from . import shade_core as sc
from .shade_core import CoreMat as MatParams, eval_pdf, evaluate_light, is_delta, sample_pdf

__all__ = ["MatParams", "CONSUMED_TEX_SLOTS", "COLOR_TEX_SLOTS", "BsdfSample",
           "material_index", "material_rows", "gather_rows", "fetch_textures",
           "gather_materials", "sample_surface", "is_delta", "eval_pdf", "sample_pdf",
           "evaluate_light"]

#: the slots gather_materials resolves (the ones the shading consumes)
CONSUMED_TEX_SLOTS = ("diffuse", "specular", "volume", "emission", "transparency", "roughness")
#: the colour slots among them (a fetch gives RGB; the others take the
#: length of the RGBA texel)
COLOR_TEX_SLOTS = ("diffuse", "specular", "volume", "emission")


class BsdfSample(NamedTuple):
    reflectance: torch.Tensor  # [R,3]
    wo: torch.Tensor  # [R,3]
    pdf: torch.Tensor  # [R]
    flags: torch.Tensor  # [R] int32


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


def fetch_textures(mp: MatParams, tex_ids: dict, uv, textures,
                   tex_slots: tuple = CONSUMED_TEX_SLOTS) -> MatParams:
    """`mp` with its textured slots resolved by a bilinear fetch at `uv`
    [R,2] from `textures` (the scene's atlas): `tex_ids` maps each slot of
    CONSUMED_TEX_SLOTS to the rays' atlas ids [R] (-1: the slot keeps its
    value), and only the slots in `tex_slots` (the scene's) pay the fetch.
    A colour slot takes RGB, a scalar slot the length of the RGBA texel."""
    vals = {}
    for slot in CONSUMED_TEX_SLOTS:
        if slot not in tex_slots:
            continue
        tex_id = tex_ids[slot]
        textured = tex_id >= 0
        if slot in COLOR_TEX_SLOTS:
            c = fetch_bilinear(textures, torch.clamp(tex_id, min=0), uv)
            vals[slot] = torch.where(textured[:, None], c, getattr(mp, slot))
        else:
            c = fetch_bilinear(textures, torch.clamp(tex_id, min=0), uv, channels=4)
            vals[slot] = torch.where(textured, torch.sqrt((c * c).sum(-1)), getattr(mp, slot))
    return dataclasses.replace(mp, **vals)


def gather_materials(materials: MaterialTable, mat_id: torch.Tensor, uv=None, textures=None,
                     tex_slots: tuple = CONSUMED_TEX_SLOTS) -> MatParams:
    """The material row of each ray's hit with its textured slots resolved
    by a bilinear fetch at `uv` [R,2] from `textures` (the scene's atlas).
    `tex_slots` (the scene's `tex_slots`) names the slots that pay the fetch;
    normal and bump textures are not fetched (no render path reads them)."""
    idx = material_index(mat_id, materials.count)
    mp = MatParams(**{f: getattr(materials, f)[idx] for f in (
        "diffuse", "specular", "volume", "emission", "ior", "transparency", "reflectivity",
        "roughness", "bsdf_id", "shader_id", "hair_alpha", "hair_beta")})
    if textures is None:
        return mp
    return fetch_textures(mp, {slot: getattr(materials, f"{slot}_tex")[idx]
                               for slot in CONSUMED_TEX_SLOTS}, uv, textures, tex_slots)


def sample_surface(mp: MatParams, wi, n, u, flags, present: tuple = ()) -> BsdfSample:
    """Every surface BSDF's sample selected per ray by its bsdf id, u [R,2]
    (`shade_core.sample_surface`): ids outside `present` (or hair ids) fall
    through to Lambert; a grazing wi zeroes the reflectance (Bsdf.cpp:181)."""
    return BsdfSample(*sc.sample_surface(mp, wi, n, u[:, 0], u[:, 1], flags, present))
