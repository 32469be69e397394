# Frozen copy of ba_pathtracing_fur_torch/core/sampling.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# what the reference's progressive sample of the hair ball calls.
"""Sampling and Fresnel helpers on tensors.

Counterpart of `ba_pathtracing_fur_tpu/core/sampling.py`, holding what the
shading body and the hair automaton use. Uniform random
numbers come in as explicit arguments.
"""

from __future__ import annotations

import math

import torch

from . import vecmath as vm

INV_SQRT_2PI = 0.3989422804014327


def normal_gauss_pdf(x, mean, stddev):
    """Gaussian pdf, matching BSDFHelper::normal_gauss_pdf (Bsdf.cpp:79-85)."""
    a = (x - mean) / stddev
    return INV_SQRT_2PI / stddev * torch.exp(-0.5 * a * a)


def dielectric_fresnel(cos_theta, eta_i, eta_t):
    """Unpolarized dielectric Fresnel (Bsdf.cpp:143-171). Negative cos_theta
    means exiting and swaps the indices; 1 on total internal reflection."""
    cos_i = torch.clamp(cos_theta, -1.0, 1.0)
    entering = cos_i > 0.0
    eta_i_ = torch.where(entering, eta_i, eta_t)
    eta_t_ = torch.where(entering, eta_t, eta_i)
    cos_i = cos_i.abs()
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=1e-12))
    sin_t = eta_i_ / eta_t_ * sin_i
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=1e-12))

    def safe(x):
        # sign-preserving zero guard (Bravais indices go negative at grazing)
        return torch.where(x.abs() < vm.EPS,
                           torch.where(x < 0, -vm.EPS, vm.EPS), x)

    rparl = (eta_t_ * cos_i - eta_i_ * cos_t) / safe(eta_t_ * cos_i + eta_i_ * cos_t)
    rperp = (eta_i_ * cos_i - eta_t_ * cos_t) / safe(eta_i_ * cos_i + eta_t_ * cos_t)
    f = 0.5 * (rparl * rparl + rperp * rperp)
    return torch.where(sin_t >= 1.0, 1.0, f)


def concentric_sample_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Concentric disk mapping (Bsdf.cpp:95-115) -> `[..., 2]`."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    theta = torch.where(use_x, (math.pi / 4.0) * (oy / safe_ox),
                        math.pi / 2.0 - (math.pi / 4.0) * (ox / safe_oy))
    d = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, d)


def cosine_sample_hemisphere(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Malley's method (Bsdf.cpp:125-132) -> `[..., 3]` about +z."""
    d = concentric_sample_disk(u1, u2)
    dx, dy = d[..., 0], d[..., 1]
    z = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def uniform_sphere_sample(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform unit sphere (Bsdf.cpp:134-141) -> `[..., 3]`."""
    phi = u2 * 2.0 * math.pi
    cos_t = 2.0 * u1 - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


