"""Accel-structure visualization: the DS_Visualizer counterpart.

Counterpart of `ba_pathtracing_fur_tpu/ops/visualize.py`. The reference
blends the accel structure's boxes over the render as coloured wireframes
(DS_Visualizer.{h,cpp}); here the same diagnostic is an image computed
over the pixel rays: a heatmap of how many boxes of one tree level each
primary ray enters (what the traversal's cost follows), with the rays
that meet a box near one of its edges tinted, which reads like the
reference's wireframe boxes.

The slab test is dense, rays x boxes, in the JAX package's arithmetic, so
both packages draw the same image. The rays go through it in chunks of
`CHUNK_ELEMS` ray-box-axis terms, so the temporaries stay near 64 MiB each
at any resolution and tree size (at 1280x720 against 4,096 leaves one
unchunked [R, C, 3] term would take 45 GB).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import camera as cam_mod
from .bvh import BVH

#: ray-box-axis terms of one chunk of rays
CHUNK_ELEMS = 1 << 24


def _level_slice(bvh: BVH, level: int):
    """Heap rows of one tree level: [2^level - 1, 2^(level+1) - 1)."""
    level = max(0, min(level, bvh.depth))
    s = (1 << level) - 1
    e = (1 << (level + 1)) - 1
    return bvh.bmin[s:e], bvh.bmax[s:e]


def _ray_box_hits(o, d, bmin, bmax):
    """[R,C] slab test: the entry t where hit, else inf, and the hit flag."""
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    t0 = (bmin[None] - o[:, None]) * inv_d[:, None]
    t1 = (bmax[None] - o[:, None]) * inv_d[:, None]
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    hit = (tnear <= tfar) & (tfar >= 0.0)
    return torch.where(hit, tnear, torch.inf), hit


def _edge_proximity(p, bmin, bmax, rel=0.06):
    """Whether point p (on a box's surface) lies near an edge of the box: a
    surface point sits on one face, and near an edge when a second axis is
    within `rel` of its slab bound."""
    ext = torch.clamp(bmax - bmin, min=1e-12)
    dlo = (p - bmin).abs() / ext
    dhi = (bmax - p).abs() / ext
    near_bound = torch.minimum(dlo, dhi) < rel  # [..., 3]
    return near_bound.to(torch.int32).sum(-1) >= 2


def _pixel_rays(camera: cam_mod.Camera, device):
    """The pixel-centre primary rays (the DoF sample at the lens centre)."""
    w, h = camera.resolution
    px, py = cam_mod.pixel_grid(camera.resolution, device=device)
    half = torch.full((w * h, 2), 0.5, dtype=torch.float32, device=device)
    return cam_mod.rays_from_pixels(camera, px, py, half, dof_uniforms=half)


def _level_hits(bvh: BVH, camera: cam_mod.Camera, level: int, edges: bool):
    """(count [R] of boxes entered, on_edge [R] or None), chunked over rays."""
    if level < 0:
        level = bvh.depth
    o, d = _pixel_rays(camera, bvh.bmin.device)
    bmin, bmax = _level_slice(bvh, level)
    step = max(1, CHUNK_ELEMS // (3 * bmin.shape[0]))
    counts, on_edge = [], []
    for s in range(0, o.shape[0], step):
        oc, dc = o[s:s + step], d[s:s + step]
        tnear, hit = _ray_box_hits(oc, dc, bmin, bmax)
        counts.append(hit.sum(-1))
        if edges:
            # the nearest box's entry point -> its edge proximity
            j = torch.argmin(tnear, dim=-1)
            t = tnear.gather(-1, j[:, None])[:, 0]
            any_hit = torch.isfinite(t)
            p = oc + torch.where(any_hit, t, 0.0)[:, None] * dc
            on_edge.append(any_hit & _edge_proximity(p, bmin[j], bmax[j]))
    return torch.cat(counts), torch.cat(on_edge) if edges else None


def visualize_structure(bvh: BVH, camera: cam_mod.Camera, level: int = -1,
                        base_image: Optional[torch.Tensor] = None, tint=(1.0, 0.55, 0.1),
                        alpha: float = 0.55) -> torch.Tensor:
    """[H,W,3] diagnostic image of one tree level (-1 = the leaves), on the
    BVH's device: a heatmap of the boxes each pixel ray enters (normalized,
    cool to hot), box edges tinted `tint`; with `base_image` the overlay is
    alpha-blended onto it (DS_Visualizer.h:22-49)."""
    w, h = camera.resolution
    count, on_edge = _level_hits(bvh, camera, level, edges=True)
    count = count.to(torch.float32)
    heat = count / torch.clamp(count.max(), min=1.0)
    img = torch.stack([heat, heat * 0.35, 1.0 - heat], dim=-1)
    img = torch.where(on_edge[:, None], torch.tensor(tint, dtype=torch.float32,
                                                     device=img.device), img)
    img = img.reshape(h, w, 3)
    if base_image is not None:
        base = base_image.to(img.device)
        mask = (count.reshape(h, w, 1) > 0) | on_edge.reshape(h, w, 1)
        img = torch.where(mask, (1 - alpha) * base + alpha * img, base)
    return img


def visit_count_stats(bvh: BVH, camera: cam_mod.Camera, level: int = -1):
    """(mean, max) boxes entered per primary ray at `level`: the printable
    companion of the heatmap (TreeAccel::printDebugInfo style)."""
    count, _ = _level_hits(bvh, camera, level, edges=False)
    return float(count.to(torch.float32).mean()), int(count.max())
