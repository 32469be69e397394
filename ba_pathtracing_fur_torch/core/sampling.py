"""Sampling and Fresnel helpers on tensors.

Counterpart of `ba_pathtracing_fur_tpu/core/sampling.py`, holding what the
shading body, the hair automaton, the light sampler, BDPT's photon emission
and the Whitted raytracer's Poisson-disk AA pattern use. Uniform random
numbers come in as explicit arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import vecmath as vm

INV_SQRT_2PI = 0.3989422804014327


def normal_gauss_pdf(x, mean, stddev):
    """Gaussian pdf, matching BSDFHelper::normal_gauss_pdf (Bsdf.cpp:79-85)."""
    a = (x - mean) / stddev
    return INV_SQRT_2PI / stddev * torch.exp(-0.5 * a * a)


def schlick_fresnel(view, normal, ior_in, ior_out):
    """Schlick's approximation (Bsdf.cpp:87-93). The fifth power is
    ((m m)(m m)) m, the products XLA's integer power takes."""
    r0 = ((ior_in - ior_out) / (ior_in + ior_out)) ** 2
    m = 1.0 - vm.dot(view, normal)
    m2 = m * m
    return r0 + (m2 * m2) * m * (1.0 - r0)


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


def sample_angle(u1: torch.Tensor, u2: torch.Tensor, max_angle) -> torch.Tensor:
    """Uniform cone about +z with half-angle max_angle (Bsdf.cpp:117-123)."""
    phi = u1 * 2.0 * math.pi
    cos_t = 1.0 - u2 * (1.0 - torch.cos(max_angle))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)


def sample_disk_about(u1: torch.Tensor, u2: torch.Tensor, normal: torch.Tensor,
                      radius) -> torch.Tensor:
    """A point offset on a disk of `radius` across `normal`, polar r =
    sqrt(u1) (Light::sampleDisk, Light.cpp:94-110) -> `[..., 3]`."""
    r = torch.sqrt(u1)
    theta = 2.0 * math.pi * u2
    x = r * torch.cos(theta) * radius
    y = r * torch.sin(theta) * radius
    s, t = vm.orthonormal_basis(normal)
    return x[..., None] * s + y[..., None] * t


def cosine_hemisphere_about(u1: torch.Tensor, u2: torch.Tensor,
                            normal: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about `normal` (Light.cpp:74-84)."""
    return vm.local_to_world_normal(cosine_sample_hemisphere(u1, u2), normal)


def bessel_i0(x: torch.Tensor) -> torch.Tensor:
    """The modified Bessel function I0 by its power series (20 terms, ~1e-7
    for |x| <= 12), the asymptotic form above 12 (d'Eon's M term names I0;
    the reference calls MSVC `_j0`, Bsdf.cpp:837)."""
    x2 = 0.25 * x * x
    term = torch.ones_like(x)
    acc = torch.ones_like(x)
    for k in range(1, 21):
        term = term * x2 / (k * k)
        acc = acc + term
    ax = x.abs()
    asym = torch.exp(ax) / torch.sqrt(torch.clamp(2.0 * math.pi * ax, min=vm.EPS))
    return torch.where(ax > 12.0, asym, acc)


def log_bessel_i0(x: torch.Tensor) -> torch.Tensor:
    """log(I0(x)), finite where I0 overflows."""
    ax = x.abs()
    small = torch.log(torch.clamp(bessel_i0(torch.clamp(ax, max=12.0)), min=1e-30))
    large = ax - 0.5 * torch.log(torch.clamp(2.0 * math.pi * ax, min=vm.EPS))
    return torch.where(ax > 12.0, large, small)


def poisson_disk_pattern(n: int, seed: int = 0, tries: int = 30) -> np.ndarray:
    """Blue-noise subpixel offsets in [0,1)^2 by dart throwing (the
    reference's PoissonDiskGenerator, Simple_CPU_Raytracer.h:26): a float32
    [n, 2] numpy array made on the host, deterministic in (n, seed). After
    `tries` rejected darts in a row the minimum distance shrinks by 0.8."""
    rng = np.random.default_rng(seed)
    pts: list = []
    min_d2 = (0.75 / np.sqrt(max(n, 1))) ** 2
    budget = tries
    while len(pts) < n:
        c = rng.random(2)
        if all(((c - p) ** 2).sum() >= min_d2 for p in pts):
            pts.append(c)
            budget = tries
        else:
            budget -= 1
            if budget <= 0:
                min_d2 *= 0.8
                budget = tries
    return np.asarray(pts, np.float32)
