"""Yxy-space photographic (logarithmic) tone mapping.

Counterpart of `ba_pathtracing_fur_tpu/ops/tonemap.py` (KIRK::Tonemapper,
Drago et al.'s logmap): RGB to Yxy, adaptive-log luminance compression with
bias, Yxy to RGB, an optional plain or Rec.709 gamma, a white/black clamp.
Elementwise torch plus two reductions (max and mean-log luminance), so it
is differentiable: losses on the tone-mapped image backprop to the scene.
Every masked division takes a safe denominator, and a power of a zero
pixel takes no gradient, so black pixels give a zero gradient where the
JAX package's is NaN (which the global max and mean would spread over the
whole image).

Defaults mirror Tonemapping.h:25-33 (exposure 0, bias 0.85, gamma 1,
contrast 0, white 1, black 0).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

EPS = 1e-6
LOG05 = -0.693147  # Tonemapping.h:13

# RGB <-> Yxy matrices, Tonemapping.h:36-43
RGB2YXY = ((0.5141364, 0.3238786, 0.16036376),
           (0.265068, 0.67023428, 0.06409157),
           (0.0241188, 0.1228178, 0.84442666))
YXY2RGB = ((2.5651, -1.1665, -0.3986),
           (-1.0217, 1.9777, 0.0439),
           (0.0753, -0.2543, 1.1892))


class TonemapParams(NamedTuple):
    exposure: float = 0.0  # scene exposure, applied as 2^exposure
    bias: float = 0.85
    gamma: float = 1.0  # "should use 2.2" (Tonemapping.h:25)
    contrast: float = 0.0
    white: float = 1.0
    black: float = 0.0
    use_rec_gamma: bool = False


def _mat3(m, img: torch.Tensor) -> torch.Tensor:
    """`m @ v` for every RGB vector of img [..., 3], as the three weighted
    sums of the JAX package's einsum."""
    c = [img[..., j] for j in range(3)]
    return torch.stack([m[i][0] * c[0] + m[i][1] * c[1] + m[i][2] * c[2] for i in range(3)],
                       dim=-1)


def _pow0(x, e: float):
    """x ** e for x >= 0, with the zero lanes' power detached: its gradient
    there (inf for e < 1) would turn the whole image's gradient NaN."""
    pos = x > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, x, 1.0), e), torch.pow(x.detach(), e))


def _rgb_to_yxy(img):
    """RGB_to_Yxy (Tonemapping.cpp:71-95): the (Y, x, y) channels."""
    xyz = _mat3(RGB2YXY, img)
    w = xyz.sum(-1)
    ok = w > 0.0
    safe_w = torch.where(ok, w, 1.0)
    yy = torch.where(ok, xyz[..., 1], 0.0)
    cx = torch.where(ok, xyz[..., 0] / safe_w, 0.0)
    cy = torch.where(ok, xyz[..., 1] / safe_w, 0.0)
    return yy, cx, cy


def _yxy_to_rgb(yy, cx, cy):
    """Yxy_to_RGB (Tonemapping.cpp:97-120)."""
    ok = (yy > EPS) & (cx > EPS) & (cy > EPS)
    safe_cy = torch.where(ok, cy, 1.0)
    safe_cx = torch.where(ok, cx, 1.0)
    x = torch.where(ok, cx * yy / safe_cy, EPS)
    z = torch.where(ok, x / safe_cx - x - yy, EPS)
    return _mat3(YXY2RGB, torch.stack([x, yy, z], dim=-1))


def tonemap(img: torch.Tensor, params: TonemapParams = TonemapParams()) -> torch.Tensor:
    """Map a linear [H,W,3] (or [...,3]) image (Tonemapper::map,
    Tonemapping.cpp:9-46, center-weighting off)."""
    p = params
    yy, cx, cy = _rgb_to_yxy(img)

    max_lum = torch.clamp(yy.max(), min=EPS)
    world_lum = torch.log(2.3e-5 + yy).mean()  # Tumblin's contrast constant
    av_lum = torch.exp(world_lum)

    exposure = 2.0 ** p.exposure
    bias_p = math.log(max(p.bias, 1e-12)) / LOG05
    lmax = max_lum / av_lum
    divider = torch.log10(lmax + 1.0)

    y = yy
    if p.contrast:
        y = _pow0(torch.clamp(y, min=0.0), 1.0 / p.contrast)
    y = y / av_lum * exposure
    interpol = torch.log(2.0 + _pow0(torch.clamp(y / lmax, min=0.0), bias_p) * 8.0)
    y = torch.log(y + 1.0) / interpol / divider

    out = _yxy_to_rgb(y, cx, cy)

    if p.gamma != 1.0:
        if p.use_rec_gamma:
            out = _rec_gamma(out, p.gamma)
        else:
            out = _pow0(torch.clamp(out, min=0.0), 1.0 / p.gamma)
    if p.white != 1.0 or p.black != 0.0:
        out = torch.clamp(out, p.black, p.white)
    return out


def _rec_gamma(img, gamma):
    """Rec.709 transfer with the reference's gamma-dependent knee
    (Tonemapping.cpp:155-182)."""
    inv_gamma = 0.45 / gamma * 2.0
    slope, start = 4.5, 0.018
    if gamma >= 2.1:
        start = 0.018 / ((gamma - 2.0) * 7.5)
        slope = 4.5 * ((gamma - 2.0) * 7.5)
    elif gamma <= 1.9:
        start = 0.018 * ((2.0 - gamma) * 7.5)
        slope = 4.5 / ((2.0 - gamma) * 7.5)
    return torch.where(img <= start, img * slope,
                       1.099 * torch.pow(torch.clamp(img, min=start), inv_gamma) - 0.099)
