# Frozen copy of ba_pathtracing_fur_torch/models/shading.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# what the reference's progressive sample of the hair ball calls.
"""The environment on a miss: constant, sphere map or cube map
(EnvironmentShader.h:21-28), as `ba_pathtracing_fur_tpu/models/shading.py`
computes it. The fused path's NEE and light hits are in
`models/shade_core.py`.
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm
from ..scene.types import ENV_COLOR, ENV_SPHERE_MAP, Environment

def environment_color(env: Environment, ray_dir: torch.Tensor) -> torch.Tensor:
    """Environment::getColor (Environment.cpp:90-...) -> [R,3]: a constant
    colour (a broadcast view of its 3 floats, row stride 0, which the shade
    kernel reads once), an equirect sphere map [H,W,3] or a cube map
    [6,H,W,3] with the faces +x,+y,+z,-x,-y,-z (Environment.cpp:105-118)."""
    if env.kind == ENV_COLOR or env.texture is None:
        return env.color.to(ray_dir.device).expand_as(ray_dir)
    tex = env.texture
    d = vm.normalize(ray_dir)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    i32 = torch.int32
    if env.kind == ENV_SPHERE_MAP:
        u = 0.5 + torch.atan2(dz, dx) / (2.0 * math.pi)
        v = 0.5 - torch.asin(torch.clamp(dy, -1.0 + 1e-7, 1.0 - 1e-7)) / math.pi
        h, w = tex.shape[0], tex.shape[1]
        xi = torch.clamp((u * (w - 1)).to(i32), 0, w - 1).long()
        yi = torch.clamp((v * (h - 1)).to(i32), 0, h - 1).long()
        return tex[yi, xi]
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    sx, sy, sz = torch.sign(dx), torch.sign(dy), torch.sign(dz)
    mx = torch.maximum(torch.maximum(ax, ay), az)
    use_x = mx == ax
    use_y = ~use_x & (mx == ay)
    side = torch.where(use_x, (1.5 - 1.5 * sx).to(i32),
                       torch.where(use_y, 1 + (1.5 - 1.5 * sy).to(i32),
                                   2 + (1.5 + 1.5 * sz).to(i32)))

    def safe(a):
        return torch.where(a.abs() < 1e-9, 1e-9, a)

    u = torch.where(use_x, (dz / safe(dx) + 1) / 2,
                    torch.where(use_y, (dx / safe(ay) + 1) / 2, -(dx / safe(dz) + 1) / 2))
    v = torch.where(use_x, (dy / safe(ax) + 1) / 2,
                    torch.where(use_y, (dz / safe(dy) + 1) / 2, (dy / safe(az) + 1) / 2))
    h, w = tex.shape[1], tex.shape[2]
    xi = torch.clamp((u % 1.0 * (w - 1)).to(i32), 0, w - 1).long()
    yi = torch.clamp((v % 1.0 * (h - 1)).to(i32), 0, h - 1).long()
    return tex[side.long(), yi, xi]


