"""Procedural noise textures: the Noise helper counterpart.

Counterpart of `ba_pathtracing_fur_tpu/scene/noise.py` (Noise.h:9-36: the
reference renders a noise texture into an FBO): hash-based value noise
with fractal (fBm) octaves, as [H,W] / [H,W,3] float32 tensors on the
device the caller names, ready for the texture atlas or a sphere
environment. The JAX package's uint32 hash is computed on int64 words
masked to 32 bits (torch's uint32 arithmetic is incomplete on CUDA), so
the lattice values are the same bits; the interpolation is float32 as
there.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _counter_hash(x: torch.Tensor) -> torch.Tensor:
    """Wang-hash style integer mix of 32-bit words (int64) -> [0,1) float32:
    stateless per lattice point, so the texture is the same at any
    resolution or tile."""
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _MASK
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _MASK
    x = x ^ (x >> 15)
    return x.to(torch.float32) / float(2**32)


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace(0, stop, num, endpoint=False) in its float32 arithmetic."""
    step = torch.arange(num, dtype=torch.float32, device=device) / float(num)
    return 0.0 * (1 - step) + stop * step


def value_noise(shape, scale: float = 8.0, seed: int = 0, device="cuda") -> torch.Tensor:
    """[H,W] single-octave value noise on `device`: bilinear interpolation
    of hashed lattice values at `scale` cells across the image."""
    h, w = shape
    ys, xs = torch.meshgrid(_linspace(scale, h, device), _linspace(scale, w, device),
                            indexing="ij")
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    # smoothstep fade
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)
    seed_mix = (seed * 0x9E3779B9) & _MASK

    def lattice(dx, dy):
        ix = ((x0 + dx).to(torch.int64) + seed_mix) & _MASK
        iy = (y0 + dy).to(torch.int64)
        return _counter_hash(((ix << 16) & _MASK) ^ iy ^ (ix >> 7))

    v00, v10 = lattice(0, 0), lattice(1, 0)
    v01, v11 = lattice(0, 1), lattice(1, 1)
    top = v00 + fx * (v10 - v00)
    bot = v01 + fx * (v11 - v01)
    return top + fy * (bot - top)


def fbm_noise(shape, octaves: int = 4, scale: float = 4.0, gain: float = 0.5,
              lacunarity: float = 2.0, seed: int = 0, device="cuda") -> torch.Tensor:
    """[H,W] fractal Brownian motion: summed value-noise octaves."""
    acc = torch.zeros(shape, dtype=torch.float32, device=device)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        acc = acc + amp * value_noise(shape, scale * lacunarity**o, seed + o, device)
        total += amp
        amp *= gain
    return acc / total


def noise_texture(size: int = 256, octaves: int = 4, scale: float = 4.0,
                  color_lo=(0.0, 0.0, 0.0), color_hi=(1.0, 1.0, 1.0), seed: int = 0,
                  device="cuda") -> torch.Tensor:
    """[size,size,3] fBm noise texture lerped between two colours, on
    `device`."""
    n = fbm_noise((size, size), octaves=octaves, scale=scale, seed=seed, device=device)
    lo = torch.tensor(color_lo, dtype=torch.float32, device=device)
    hi = torch.tensor(color_hi, dtype=torch.float32, device=device)
    return lo + n[..., None] * (hi - lo)
