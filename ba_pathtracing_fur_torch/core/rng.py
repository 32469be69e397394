"""Counter-based per-pixel RNG: jax.random's threefry2x32, bit for bit.

Counterpart of `ba_pathtracing_fur_tpu/core/rng.py`. A key is a pair of
32-bit words held in an int64 tensor `[..., 2]`; every word stays masked to
32 bits, because torch's uint32 arithmetic is incomplete on CUDA. The
derivations reproduce jax 0.9 with `jax_threefry_partitionable=True`:

  * `fold_in(key, d)` is `threefry2x32(key, (0, d))`;
  * `split(key, n)[i]` is `threefry2x32(key, (0, i))`, i.e. `fold_in(key, i)`;
  * `uniform(key, shape)` takes `x0 ^ x1` of `threefry2x32(key, (i >> 32,
    i & 0xffffffff))` for the row-major flat index `i` of each element,
    and the float is `f32((bits >> 9) | 0x3f800000) - 1`;
  * `normal(key, shape)` is `sqrt(2) * erfinv(u)` with `u` uniform on
    `[nextafter(-1, 0), 1)`, scaled as jax scales it. torch's `erfinv` and
    XLA's polynomial differ by ulps, so `normal` is close to jax, not
    bit-equal;
  * `key(seed)` has key data `(seed >> 32, seed & 0xffffffff)`.

Everything is batched over rays: no vmap, no global generator.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 words masked to 32 bits.

    `k0, k1` broadcast against the counters `x0, x1`. Returns `(y0, y1)`."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device="cuda") -> torch.Tensor:
    """`jax.random.key(seed)` key data as an int64 `[2]` tensor on `device`."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` over a batch: `keys [..., 2]`, `data` an int or
    an integer tensor broadcasting against `keys[..., 0]`."""
    k0, k1 = keys[..., 0], keys[..., 1]
    # a Python int stays a Python int: no host-to-device copy, no sync
    d = data & _MASK if isinstance(data, int) else data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(k0, k1, 0, d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """jax's float32 uniform from 32 random bits: mantissa fill, minus 1."""
    word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return word.view(torch.float32) - 1.0


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)` key data: `[n, 2]`."""
    return fold_in(key[None], torch.arange(n, dtype=torch.int64, device=key.device))


def uniform(keys: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32)` for every key: `[..., *shape]`
    (`shape` an int or a tuple)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _MASK)
    return bits_to_unit_float(y0 ^ y1).reshape(*keys.shape[:-1], *shape)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)` up to erfinv's ulps."""
    lo = torch.tensor(-0.99999994, dtype=torch.float32)  # nextafter(-1, 0)
    span = (1.0 - lo).to(key.device)  # float32 (hi - lo), as jax rounds it
    u = torch.clamp(uniform(key, shape) * span + lo.to(key.device), min=lo.item())
    return torch.erfinv(u) * 1.4142135381698608  # float32(sqrt(2))


def keys_for_pixels(base_key: torch.Tensor, pixel_ids: torch.Tensor,
                    sample_index: int) -> torch.Tensor:
    """One key `[R, 2]` per global pixel id for a progressive sample index
    (independent of the pixel's place in any shard)."""
    k = fold_in(base_key, sample_index)
    return fold_in(k, pixel_ids.to(torch.int64))


def pixel_keys(base_key: torch.Tensor, n_pixels: int, sample_index: int) -> torch.Tensor:
    """One key `[n_pixels, 2]` per pixel 0..n_pixels-1 for a progressive
    sample index."""
    return keys_for_pixels(base_key, torch.arange(n_pixels, device=base_key.device),
                           sample_index)


def bounce_uniform(keys: torch.Tensor, bounce: int, n: int,
                   tag: int = 0) -> torch.Tensor:
    """`[R, n]` uniforms for this bounce; `tag` separates independent uses
    and bounce -1 is reserved for the camera draws."""
    return uniform(fold_in(keys, (bounce + 1) * 97 + tag), n)


def bounce_uniforms(keys: torch.Tensor, bounce: int, n_tags: int, n: int) -> torch.Tensor:
    """`[n_tags, R, n]`: `bounce_uniform(keys, bounce, n, tag)` for tags
    0..n_tags-1, drawn in one batched threefry pass. A tag that needs fewer
    than `n` draws takes the leading ones: draw i depends only on counter i."""
    tags = torch.arange(n_tags, dtype=torch.int64, device=keys.device)
    return uniform(fold_in(keys[None], ((bounce + 1) * 97 + tags)[:, None]), n)


def radical_inverse_vdc(bits: torch.Tensor) -> torch.Tensor:
    """Base-2 van der Corput radical inverse: 32-bit reversal / 2^32."""
    b = torch.as_tensor(bits, dtype=torch.int64) & _MASK
    b = ((b << 16) | (b >> 16)) & _MASK
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    return b.to(torch.float32) * 2.3283064365386963e-10  # 1/2^32


def hammersley2d(i, inv_max_samples: float) -> torch.Tensor:
    """Hammersley point i of the set: `(i/N, radicalInverse(i))` -> `[..., 2]`."""
    i = torch.as_tensor(i, dtype=torch.int64)
    return torch.stack([i.to(torch.float32) * inv_max_samples,
                        radical_inverse_vdc(i)], dim=-1)


def qmc_jitter(base_key: torch.Tensor, pixel_ids: torch.Tensor,
               sample_idx: int, spp: int) -> torch.Tensor:
    """Subpixel QMC jitter `[R, 2]`: the Hammersley point of `sample_idx`,
    Cranley-Patterson-rotated by a per-pixel uniform of the global id."""
    p = hammersley2d(sample_idx, 1.0 / max(spp, 1)).to(base_key.device)
    k = fold_in(base_key, 0x9A3)
    rot = uniform(fold_in(k, pixel_ids.to(torch.int64)), 2)
    return torch.remainder(p[None, :] + rot, 1.0)
