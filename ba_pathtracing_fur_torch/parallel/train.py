"""Sharded differentiable-rendering training step.

Counterpart of `ba_pathtracing_fur_tpu/parallel/train.py` on torch
autograd: the loss is the mean squared error of `render_image_sharded`
against a target, and its gradients flow back through every dp row and
geo shard (the Hits' payloads and the `.to()` moves between the mesh's
devices are differentiable). The render must take the unfused bounce
(`fused_shading=False`, as `diff/fit.py` does): the traversal kernels only
pick rows, and every value the loss sees is computed in torch.

The trainable parameters are the material table's differentiable columns
(`PARAM_FIELDS`), the hair lobe shift/width hair_alpha/hair_beta among them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.pathtracer import RenderConfig
from ..scene.types import DeviceScene, MaterialTable
from . import render as prender


class TrainState(NamedTuple):
    materials: MaterialTable
    step: torch.Tensor  # [] int32


#: the differentiable columns of the material table (the int id columns,
#: bsdf_id/shader_id and the texture slots, are structure, not parameters)
PARAM_FIELDS = ("diffuse", "specular", "volume", "emission", "ior",
                "transparency", "reflectivity", "roughness",
                "hair_alpha", "hair_beta")


def material_params(materials: MaterialTable) -> dict:
    return {k: getattr(materials, k) for k in PARAM_FIELDS}


def with_material_params(materials: MaterialTable, params: dict) -> MaterialTable:
    return dataclasses.replace(materials, **params)


def loss_fn(params: dict, scene: DeviceScene, camera, key, target, cfg: RenderConfig,
            mesh) -> torch.Tensor:
    """Mean squared error between the sharded render and `target`."""
    mats = with_material_params(scene.materials, params)
    img = prender.render_image_sharded(dataclasses.replace(scene, materials=mats), camera,
                                       key, cfg, mesh)
    return ((img - target.to(img.device)) ** 2).mean()


def train_step(state: TrainState, scene: DeviceScene, camera, key, target, cfg: RenderConfig,
               mesh, lr: float = 1e-2):
    """One SGD step on the material table -> (new state, loss). A column the
    loss does not reach gets a zero gradient, as under jax.grad."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in material_params(state.materials).items()}
    loss = loss_fn(params, scene, camera, key, target, cfg, mesh)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    with torch.no_grad():
        new = {k: p - lr * g if g is not None else p.clone()
               for (k, p), g in zip(params.items(), grads)}
    return TrainState(materials=with_material_params(state.materials, new),
                      step=state.step + 1), loss.detach()
