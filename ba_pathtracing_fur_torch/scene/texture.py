"""Texture atlas with bilinear fetch.

Counterpart of `ba_pathtracing_fur_tpu/scene/texture.py` (KIRK::Texture::
getColor, Texture.h:25-90): the textures of a scene stacked into one
`[NT, H, W, 4]` float atlas, each image at the atlas' top-left corner with
its own `(h, w)` recorded in `sizes`, so a fetch addresses every texture at
its native resolution. The atlas stores RGBA (alpha 1 where the source has
none); colour fetches return RGB, float-slot fetches take the 4-channel
length (Material.cpp:15-23).

`build_atlas` runs on the host in numpy, as the JAX package's does;
`fetch_bilinear` runs on the atlas' device. Indices are taken as jnp's
gather takes them: a negative index counts from the end, and every index
clamps to its axis, so no fetch reads out of range.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class TextureAtlas:
    """Stacked textures and the native size of each."""

    images: torch.Tensor  # [NT, H, W, 4] f32, each embedded at (0, 0)
    sizes: Optional[torch.Tensor]  # [NT, 2] int32 (h, w); None = the atlas' own

    def to(self, device) -> "TextureAtlas":
        return TextureAtlas(images=self.images.to(device),
                            sizes=None if self.sizes is None else self.sizes.to(device))


def _to_float_rgba(img: np.ndarray) -> np.ndarray:
    """1/2/3/4-channel byte or float image -> HxWx4 f32 (missing alpha = 1,
    greyscale broadcast to RGB)."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    a = a.astype(np.float32)
    if a.ndim == 2:
        a = a[..., None]
    c = a.shape[-1]
    if c == 1:  # grey -> RGB
        a = a.repeat(3, axis=-1)
    elif c == 2:  # grey + alpha
        a = np.concatenate([a[..., :1].repeat(3, axis=-1), a[..., 1:2]], axis=-1)
    if a.shape[-1] == 3:
        a = np.concatenate([a, np.ones_like(a[..., :1])], axis=-1)
    return a[..., :4]


def _resize_nearest(a: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = np.linspace(0, a.shape[0] - 1, h).astype(np.int64)
    xs = np.linspace(0, a.shape[1] - 1, w).astype(np.int64)
    return a[ys][:, xs]


def build_atlas(images: list, size: Optional[int] = None) -> TextureAtlas:
    """Stack images (HxWx{1..4} float or uint8) into a TextureAtlas on the
    CPU. `size` caps the atlas resolution (default: the largest image
    dimension, at most 2048); smaller images keep their native size."""
    if not images:
        return TextureAtlas(torch.zeros((0, 1, 1, 4)), torch.zeros((0, 2), dtype=torch.int32))
    floats = [_to_float_rgba(im) for im in images]
    max_dim = max(max(a.shape[0], a.shape[1]) for a in floats)
    cap = int(size) if size else min(max_dim, 2048)
    floats = [a if max(a.shape[0], a.shape[1]) <= cap
              else _resize_nearest(a, min(a.shape[0], cap), min(a.shape[1], cap))
              for a in floats]
    h = max(a.shape[0] for a in floats)
    w = max(a.shape[1] for a in floats)
    out = np.zeros((len(floats), h, w, 4), np.float32)
    sizes = np.zeros((len(floats), 2), np.int32)
    for i, a in enumerate(floats):
        out[i, : a.shape[0], : a.shape[1]] = a
        sizes[i] = (a.shape[0], a.shape[1])
    return TextureAtlas(torch.from_numpy(out), torch.from_numpy(sizes))


def jnp_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The index jnp's gather reads on an axis of length n: a negative index
    counts from the end, and the result clamps to [0, n-1]."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def fetch_bilinear(atlas, tex_id: torch.Tensor, uv: torch.Tensor,
                   sizes: Optional[torch.Tensor] = None, channels: int = 3) -> torch.Tensor:
    """Bilinear sample: atlas [NT,H,W,C] (or TextureAtlas), tex_id [R],
    uv [R,2] -> [R,channels]. UVs wrap (repeat addressing, floor-mod as
    jnp's `%`); v is flipped to image row order. With `sizes` [NT,2] each
    texture is addressed at its native resolution. channels=4 includes
    alpha where the atlas stores it."""
    if isinstance(atlas, TextureAtlas):
        sizes = atlas.sizes if sizes is None else sizes
        atlas = atlas.images
    atlas = atlas[..., : min(channels, atlas.shape[-1])]
    nt, ah, aw = atlas.shape[:3]
    tex = jnp_index(tex_id, nt)
    if sizes is None:
        h = torch.full(tex.shape, float(ah), device=uv.device)
        w = torch.full(tex.shape, float(aw), device=uv.device)
    else:
        hw = sizes[tex].to(torch.float32)
        h, w = hw[:, 0], hw[:, 1]
    u = uv[:, 0] % 1.0
    v = 1.0 - (uv[:, 1] % 1.0)
    x = u * (w - 1)
    y = v * (h - 1)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1 = torch.minimum(x0 + 1, (w - 1).to(torch.int32))
    y1 = torch.minimum(y0 + 1, (h - 1).to(torch.int32))
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0, x1 = jnp_index(x0, aw), jnp_index(x1, aw)
    y0, y1 = jnp_index(y0, ah), jnp_index(y1, ah)
    c00 = atlas[tex, y0, x0]
    c01 = atlas[tex, y0, x1]
    c10 = atlas[tex, y1, x0]
    c11 = atlas[tex, y1, x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy
