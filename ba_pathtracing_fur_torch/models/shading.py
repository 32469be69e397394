"""Environment lookup.

Counterpart of `ba_pathtracing_fur_tpu/models/shading.py::
environment_color` for the constant-colour environment
(Environment::getColor, Environment.cpp:90-...). Sphere and cube maps are
not ported yet.
"""

from __future__ import annotations

import torch

from ..scene.types import ENV_COLOR, Environment


def environment_color(env: Environment, ray_dir: torch.Tensor) -> torch.Tensor:
    """The environment's radiance along each ray -> [R,3]. A constant colour
    comes back as a broadcast view of its 3 floats (row stride 0), which the
    shade kernel reads once rather than per ray."""
    if env.kind == ENV_COLOR or env.texture is None:
        return env.color.to(ray_dir.device).expand_as(ray_dir)
    raise NotImplementedError("sphere- and cube-map environments are not ported yet "
                              "(ROADMAP Queue 1 item 5, M5)")
