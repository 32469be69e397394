"""Differentiable rendering: parameter sets, losses, fitting.

Counterpart of `ba_pathtracing_fur_tpu/diff/fit.py` on torch autograd.
Pixel gradients reach the material columns (diffuse, specular, emission,
ior, roughness, ...), the fur lobe parameters hair_alpha/hair_beta, the
lights' colour, position and radius, and the environment.

The gradient path is the unfused bounce (`fused_shading=False`, the
default): the traversal kernels only pick the winning row from detached
rays, and every value the loss sees is computed in torch from the
parameters (`ops/traverse.closest_hit` recomputes the winner's t), so no
kernel needs a backward. The fused path raises under autograd.

Sampling is attached, as in the JAX package: BSDF sample directions are
computed from the same parameters they are evaluated with, so gradients
include the sampling-path term. Visibility and geometry-edge gradients are
out of scope.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import rng
from ..models.pathtracer import RenderConfig, render_image
from ..scene.types import DeviceScene

# differentiable columns per table
MATERIAL_FIELDS = ("diffuse", "specular", "volume", "emission", "ior",
                   "transparency", "reflectivity", "roughness",
                   "hair_alpha", "hair_beta")
LIGHT_FIELDS = ("color", "position", "radius")
ENV_FIELDS = ("color", "ambient")

# the validity boxes enforced after each optimizer update: a Gaussian with
# stddev <= 0 or an ior < 1 turns the forward model NaN
PARAM_BOUNDS = {
    ("materials", "diffuse"): (0.0, None),
    ("materials", "specular"): (0.0, None),
    ("materials", "volume"): (0.0, None),
    ("materials", "emission"): (0.0, None),
    ("materials", "ior"): (1.0001, 4.0),
    ("materials", "transparency"): (0.0, 1.0),
    ("materials", "reflectivity"): (0.0, 1.0),
    ("materials", "roughness"): (1e-3, None),
    ("materials", "hair_alpha"): (-20.0, -0.5),
    ("materials", "hair_beta"): (0.5, 30.0),
    ("lights", "color"): (0.0, None),
    ("lights", "radius"): (0.0, None),
    ("env", "color"): (0.0, None),
    ("env", "ambient"): (0.0, None),
}

_GROUPS = {"materials": MATERIAL_FIELDS, "lights": LIGHT_FIELDS, "env": ENV_FIELDS}


def clamp_params(params: dict) -> dict:
    """The parameters clamped into PARAM_BOUNDS, in place (the tensors
    stay the optimizer's leaves); returns `params`."""
    with torch.no_grad():
        for group, sub in params.items():
            for k, v in sub.items():
                lo, hi = PARAM_BOUNDS.get((group, k), (None, None))
                if lo is not None or hi is not None:
                    v.clamp_(min=lo, max=hi)
    return params


def make_params(scene: DeviceScene, materials=True, lights=False, env=False) -> dict:
    """The requested parameter sets: `{group: {field: tensor}}`, each a leaf
    tensor with requires_grad, cloned from the scene's column."""
    want = {"materials": materials, "lights": lights, "env": env}
    return {group: {k: getattr(getattr(scene, group), k).detach().clone().requires_grad_()
                    for k in fields}
            for group, fields in _GROUPS.items() if want[group]}


def apply_params(scene: DeviceScene, params: dict) -> DeviceScene:
    """The scene with its parameter columns replaced by `params`."""
    return dataclasses.replace(scene, **{
        group: dataclasses.replace(getattr(scene, group), **sub)
        for group, sub in params.items()})


def l2_loss(img, target):
    return ((img - target) ** 2).mean()


def l1_loss(img, target):
    return (img - target).abs().mean()


def render_loss(params: dict, scene: DeviceScene, camera, key, target,
                cfg: RenderConfig, loss_fn: Callable = l2_loss) -> torch.Tensor:
    img = render_image(apply_params(scene, params), camera, key, cfg)
    return loss_fn(img, target)


class FitResult(NamedTuple):
    params: dict
    losses: np.ndarray  # [steps]
    scene: DeviceScene


def make_optimizer(name: str, params: dict, lr: float) -> torch.optim.Optimizer:
    """torch's counterpart of optax's `adam` (its defaults: betas 0.9 and
    0.999, eps 1e-8) or `sgd` (no momentum) over every parameter tensor."""
    leaves = [v for sub in params.values() for v in sub.values()]
    return {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}[name](leaves, lr=lr)


def fit(scene: DeviceScene, camera, target, cfg: RenderConfig,
        steps: int = 50, lr: float = 5e-2, key=None,
        param_spec: Optional[dict] = None, loss_fn: Callable = l2_loss,
        optimizer: str = "adam") -> FitResult:
    """Inverse rendering: optimise the scene's parameters so the render
    matches `target`. Each step renders with a fresh sample key (one
    `rng.split` a step), takes the gradient, applies the optimizer's update
    and clamps into PARAM_BOUNDS."""
    key = rng.key(0, scene.device) if key is None else key
    params = make_params(scene, **(param_spec or {"materials": True}))
    opt = make_optimizer(optimizer, params, lr)
    losses = []
    for _ in range(steps):
        key, sub = rng.split(key)
        opt.zero_grad(set_to_none=True)
        loss = render_loss(params, scene, camera, sub, target, cfg, loss_fn)
        loss.backward()
        opt.step()
        clamp_params(params)
        losses.append(loss.item())
    params = {g: {k: v.detach() for k, v in sub.items()} for g, sub in params.items()}
    return FitResult(params, np.asarray(losses, dtype=np.float32), apply_params(scene, params))


def finite_diff_check(params: dict, scene: DeviceScene, camera, key, target,
                      cfg: RenderConfig, path: tuple, index, eps: float = 1e-3):
    """The autograd gradient of one scalar parameter, addressed by
    (group, field) `path` and array `index`, beside its central finite
    difference -> (analytic, numeric)."""
    group, field = path
    leaf = params[group][field]
    (g,) = torch.autograd.grad(render_loss(params, scene, camera, key, target, cfg), [leaf])
    analytic = float(g[index])

    def loss_at(v):
        moved = leaf.detach().clone()
        moved[index] = v
        p = {gr: dict(sub) for gr, sub in params.items()}
        p[group][field] = moved
        with torch.no_grad():
            return float(render_loss(p, scene, camera, key, target, cfg))

    v0 = float(leaf.detach()[index])
    return analytic, (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
