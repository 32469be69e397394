"""Bidirectional path tracing: the light-subpath buffer, the eye-vertex
connection and the camera-plane splat.

Counterpart of `ba_pathtracing_fur_tpu/models/bdpt.py` (the reference GPU
pipeline's BDPT side channel):

  * `build_light_subpaths`: a photon ray per (sample, light), emitted by the
    light's kind and walked `n_bounces` vertices through the scene, each
    vertex's position, incoming direction and path throughput recorded
    (lbb_construction.compute:34-141, 300-402). The emission weight is the
    reference's 1/pi (:231), kept for parity;
  * `connect_eye_vertex`: each eye hit picks one (sample, light) subpath and
    connects to all its vertices with shadow rays of t_max = the distance
    to the vertex, each connection weighted by 1 / (j + 1 + eye bounce),
    without distance attenuation or geometry term (pt_shade.compute:146-201,
    kept);
  * `splat_image_plane`: light vertices connected straight to jittered
    points on the camera plane, with the sensor importance 1/(A cos^4) and
    the t^2/cos density conversion (pt_shade.compute:17-97).

The buffer is `LightSubpaths`, `[P, B]` fields (P = samples a light x
lights). The path tracer traces several samples as one wavefront, so it
stacks their buffers to `[S, P, B]`; the connection and the splat then take
each ray's sample index (`sample`) and read that sample's buffer. Every
shadow ray runs through `ops/traverse.any_hit` (a traversal kernel on a
BVH) and the walk through `closest_hit`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import rng, sampling as sp, vecmath as vm
from ..ops import intersect as isect, traverse
from ..scene.types import LIGHT_POINT, LIGHT_QUAD, LIGHT_SPOT, MATFLAG_EMISSIVE_BOUNCE, \
    DeviceScene, LightPack
from . import bsdf as bsdf_mod

INV_PI = 1.0 / math.pi


class LightSubpaths(NamedTuple):
    """The light-subpath vertex buffer (LightBounce SoA,
    lbb_construction.compute:7-19): `[P, B]` fields, or `[S, P, B]` with a
    leading sample axis (`stack_subpaths`)."""

    position: torch.Tensor  # [P,B,3] vertex position (j = 0: the emission origin)
    in_dir: torch.Tensor  # [P,B,3] direction of the ray arriving at the vertex
    hit_color: torch.Tensor  # [P,B,3] path throughput (starts at 1/pi)
    travel: torch.Tensor  # [P,B] cumulative distance
    valid: torch.Tensor  # [P,B] bool
    light_index: torch.Tensor  # [P] int32


def subpaths_from_numpy(sub, device="cuda") -> LightSubpaths:
    """Read a JAX-package `LightSubpaths` field by field (the object is
    passed in, no jax import) into the port's on `device`."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return LightSubpaths(position=t(sub.position), in_dir=t(sub.in_dir),
                         hit_color=t(sub.hit_color), travel=t(sub.travel),
                         valid=t(sub.valid, torch.bool),
                         light_index=t(sub.light_index, torch.int32))


def stack_subpaths(subs: Sequence[LightSubpaths]) -> LightSubpaths:
    """One buffer of each sample -> `[S, P, B]` fields."""
    return LightSubpaths(*(torch.stack(list(f)) for f in zip(*subs)))


def emit_light_rays(lights: LightPack, idx, u1, u2):
    """calcLightBounce per light kind -> (origin, unit direction) of the
    photon ray (lbb_construction.compute:34-141). u1, u2: [P, 2]."""
    idx = idx.long()
    kind = lights.kind[idx]
    pos = lights.position[idx]
    ldir = lights.direction[idx]
    radius = lights.radius[idx]

    # point: a sphere-normal origin, a cosine direction about that normal
    n_sph = sp.uniform_sphere_sample(u1[:, 0], u1[:, 1])
    o_point = pos + n_sph * radius[:, None]
    d_point = sp.cosine_hemisphere_about(u2[:, 0], u2[:, 1], n_sph)
    # sun: the origin pushed to 1e16 opposite its direction
    rand_pt = sp.uniform_sphere_sample(u1[:, 0], u1[:, 1]) * radius[:, None] - ldir
    o_sun = rand_pt + 1e16 * vm.normalize(rand_pt)
    # spot: a disk origin about the axis, a direction within the outer angle
    o_spot = pos + sp.sample_disk_about(u1[:, 0], u1[:, 1], ldir, radius)
    d_spot = vm.local_to_world_normal(
        sp.sample_angle(u2[:, 0], u2[:, 1], torch.deg2rad(lights.outer_angle[idx])), ldir)
    # quad: a bilinear area point, a cosine direction about the quad's normal
    v = lights.verts[idx]
    x1 = v[:, 0] + u1[:, 0:1] * (v[:, 1] - v[:, 0])
    x2 = v[:, 3] + u1[:, 0:1] * (v[:, 2] - v[:, 3])
    o_quad = x1 + u1[:, 1:2] * (x2 - x1)
    d_quad = sp.cosine_hemisphere_about(u2[:, 0], u2[:, 1], ldir)

    def by_kind(point, quad, spot, sun):
        return torch.where((kind == LIGHT_POINT)[:, None], point,
                           torch.where((kind == LIGHT_QUAD)[:, None], quad,
                                       torch.where((kind == LIGHT_SPOT)[:, None], spot, sun)))

    return by_kind(o_point, o_quad, o_spot, o_sun), \
        vm.normalize(by_kind(d_point, d_quad, d_spot, ldir))


def angular_attenuation(lights: LightPack, idx, dir_to_light):
    """inc_light.compute:207-237: a spot's falloff, a quad's facing, else 1."""
    idx = idx.long()
    kind = lights.kind[idx]
    cosd = vm.dot(vm.normalize(-dir_to_light), lights.direction[idx])
    angle = torch.rad2deg(torch.acos(torch.clamp(cosd, -1.0 + 1e-7, 1.0 - 1e-7)))
    inner, outer = lights.inner_angle[idx], lights.outer_angle[idx]
    spot = 1.0 - torch.clamp((angle - inner) / torch.clamp(outer - inner, min=1e-6), 0.0, 1.0)
    return torch.where(kind == LIGHT_SPOT, spot, torch.where(kind == LIGHT_QUAD, cosd, 1.0))


def build_light_subpaths(scene: DeviceScene, key, samples_per_light: int,
                         n_bounces: int, closest_fn=None) -> LightSubpaths:
    """The light bounce buffer: P = samples_per_light x lights photon rays,
    each walked `n_bounces` vertices (traceLightRays and shadeLightRays
    fused a step). Photon p's key is fold_in(key, p); its uniforms are
    tags 10 and 11 of bounce -1 (the emission) and tag 12 of bounce j (the
    BSDF sample at vertex j). `closest_fn(o, d, scene) -> Hit` replaces
    the walk's closest hit (the geometry-sharded render's seam)."""
    lights = scene.lights
    dev = scene.device
    n_l = lights.count
    p = samples_per_light * n_l
    light_index = torch.arange(n_l, dtype=torch.int32, device=dev).repeat(samples_per_light)
    keys = rng.fold_in(key.to(dev), torch.arange(p, device=dev))
    o0, d0 = emit_light_rays(lights, light_index, rng.bounce_uniform(keys, -1, 2, tag=10),
                             rng.bounce_uniform(keys, -1, 2, tag=11))

    positions, in_dirs = [o0], [d0]
    hit_colors = [torch.full((p, 3), INV_PI, device=dev)]  # lbb_construction.compute:231
    travels = [torch.zeros((p,), device=dev)]
    valids = [torch.ones((p,), dtype=torch.bool, device=dev)]
    o, d, hc, travel, alive = o0, d0, hit_colors[0], travels[0], valids[0]
    up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    flags0 = torch.zeros((p,), dtype=torch.int32, device=dev)

    for j in range(1, n_bounces):
        hit = traverse.closest_hit(o, d, scene) if closest_fn is None else closest_fn(o, d, scene)
        v3 = hit.valid[:, None]
        pos_j = torch.where(v3, hit.position, o)
        norm_j = torch.where(v3, hit.normal, up)
        travel = travel + torch.where(hit.valid, vm.length(pos_j - o), 0.0)

        mp = bsdf_mod.gather_materials(scene.materials, hit.mat_id, hit.uv, scene.textures,
                                       scene.tex_slots)
        bs = bsdf_mod.sample_surface(mp, -d, norm_j, rng.bounce_uniform(keys, j, 2, tag=12),
                                     flags0, present=scene.bsdfs_present)
        # hit_color *= reflectance * clamp(|cos| * pdf, 0, 1) (:344-346)
        w = torch.clamp(vm.dot(bs.wo, norm_j).abs() * bs.pdf, 0.0, 1.0)
        hc_j = hc * bs.reflectance * w[:, None]
        emissive = (bs.flags & MATFLAG_EMISSIVE_BOUNCE) != 0
        dead = ~hit.valid | emissive | (bs.pdf <= 1e-4) | (hc_j == 0.0).all(-1)

        positions.append(pos_j)
        in_dirs.append(vm.normalize(d))
        hit_colors.append(hc_j)
        travels.append(travel)
        # vertex j is usable when the walk reached it on a real, non-emissive
        # hit (the reference marks the slot dead on a miss or emitter, :364-383)
        valids.append(alive & hit.valid & ~emissive)
        o, d, hc, alive = pos_j + 1e-4 * bs.wo, bs.wo, hc_j, alive & ~dead

    return LightSubpaths(position=torch.stack(positions, 1), in_dir=torch.stack(in_dirs, 1),
                         hit_color=torch.stack(hit_colors, 1), travel=torch.stack(travels, 1),
                         valid=torch.stack(valids, 1), light_index=light_index)


def _vertex_rows(sub: LightSubpaths, n_l: int, u_pick, sample):
    """The picked subpath of each ray -> (flat buffer [S*P, B] fields, flat
    row [R], light index [R]). A ray picks sample s = u0 * S_per and light
    l = u1 * n_l of its own sample's buffer (`sample` [R] into a stacked
    buffer, None for a single one)."""
    p_total, n_b = sub.valid.shape[-2:]
    s_total = p_total // n_l
    s_pick = torch.clamp((u_pick[:, 0] * s_total).to(torch.int32), max=s_total - 1)
    l_pick = torch.clamp((u_pick[:, 1] * n_l).to(torch.int32), max=n_l - 1)
    pidx = (s_pick * n_l + l_pick).long()
    light_idx = sub.light_index.reshape(-1, p_total)[0][pidx]
    if sample is not None:
        pidx = sample.long() * p_total + pidx
    flat = LightSubpaths(*(_flat(f, sub.valid.dim()) for f in sub))
    return flat, pidx, light_idx


def _flat(f: torch.Tensor, vdim: int) -> torch.Tensor:
    """A `[S, P, B, ...]` field as `[S*P, B, ...]` (`[P, B, ...]` stays)."""
    return f.reshape(-1, *f.shape[vdim - 1:]) if vdim == 3 else f


def connect_eye_vertex(scene: DeviceScene, sub: LightSubpaths, u_pick, pos, normal, view_dir,
                       mp, bounce: int, bias: float = 1e-4,
                       sample: Optional[torch.Tensor] = None,
                       active: Optional[torch.Tensor] = None, n_alive=None, occlude_fn=None):
    """The BDPT connection at an eye hit (pt_shade.compute:146-201): pick
    one (sample, light) subpath a ray with u_pick [R,2] and connect to each
    of its vertices -> the term [R,3] that replaces NEE. `sample` [R]: each
    ray's sample in a stacked buffer. `active` [R]: the lanes whose term is
    used; the others get t_max = 0 connection rays. `n_alive` is passed to
    the shadow any-hit; `occlude_fn(o, d, scene, t_max) -> blocked`
    replaces it."""
    lights = scene.lights
    flat, pidx, lidx = _vertex_rows(sub, lights.count, u_pick, sample)
    base_color = lights.color[lidx.long()]
    origin = pos + bias * normal
    wo_view = -vm.normalize(view_dir)
    total = torch.zeros_like(pos)
    for j in range(flat.valid.shape[1]):
        v_pos, v_in = flat.position[pidx, j], flat.in_dir[pidx, j]
        v_hc, v_ok = flat.hit_color[pidx, j], flat.valid[pidx, j]
        to_light = (v_pos - bias * v_in) - pos
        sdir = vm.normalize(to_light)
        t_max = vm.length(to_light)
        lc = angular_attenuation(lights, lidx, to_light)[:, None] * base_color \
            if j == 0 else base_color
        t_cap = t_max if active is None else torch.where(active, t_max, 0.0)
        blocked = (traverse.any_hit(origin, sdir, scene, t_cap, n_alive=n_alive)
                   if occlude_fn is None else occlude_fn(origin, sdir, scene, t_cap))
        t_l, valid_l = isect.light_hit_grid(origin, sdir, lights)
        blocked = blocked | (valid_l & (t_l < t_max[:, None])).any(-1)
        f = bsdf_mod.evaluate_light(mp, normal, sdir, wo_view)
        contrib = v_hc * lc * f * vm.dot(sdir, normal).abs()[:, None] / (j + 1.0 + bounce)
        total = total + torch.where((v_ok & ~blocked)[:, None], contrib, 0.0)
    return total


def splat_image_plane(scene: DeviceScene, camera, sub: LightSubpaths, pixel_ids, keys,
                      sample: Optional[torch.Tensor] = None, occlude_fn=None):
    """shadeBDPTImagePlane (pt_shade.compute:17-97): connect light vertices
    straight to jittered points on the camera plane -> [R,3] additive
    colour for `pixel_ids` [R] with the rays' keys [R,2] (tags 13 and 14 of
    bounce -1: the jitter and the subpath pick). `sample` and `occlude_fn`
    as in `connect_eye_vertex`."""
    lights = scene.lights
    w, h = camera.resolution
    jitter = rng.bounce_uniform(keys, -1, 2, tag=13)
    u_pick = rng.bounce_uniform(keys, -1, 2, tag=14)
    px = (pixel_ids % w).to(torch.float32) + jitter[:, 0]
    py = (pixel_ids // w).to(torch.float32) + jitter[:, 1]
    ax = camera.pixel_size * camera.axis_x
    ay = camera.pixel_size * camera.axis_y
    pixel = camera.bottom_left[None, :] + px[:, None] * ax + py[:, None] * ay

    # the sensor plane's area and normal (pt_shade.compute:55-62)
    area = float(w) * float(h) * torch.linalg.norm(vm.cross(ay, ax))
    cam_n = vm.normalize(vm.cross(camera.axis_y, camera.axis_x))

    flat, pidx, _ = _vertex_rows(sub, lights.count, u_pick, sample)
    total = torch.zeros_like(pixel)
    for j in range(flat.valid.shape[1]):
        v_pos, v_in = flat.position[pidx, j], flat.in_dir[pidx, j]
        v_hc, v_ok = flat.hit_color[pidx, j], flat.valid[pidx, j]
        d = (v_pos + 1e-4 * v_in) - pixel
        t = vm.length(d)
        dn = d / torch.clamp(t, min=1e-12)[:, None]
        cos_t = vm.dot(cam_n[None, :], dn)
        we = 1.0 / torch.clamp(area * cos_t ** 4, min=1e-12)
        we = torch.where(cos_t <= 0.0, 0.0, we)
        npdf = (t * t) / torch.clamp(cos_t.abs(), min=1e-12)
        blocked = (traverse.any_hit(pixel, dn, scene, t) if occlude_fn is None
                   else occlude_fn(pixel, dn, scene, t))
        t_l, valid_l = isect.light_hit_grid(pixel, dn, lights)
        blocked = blocked | (valid_l & (t_l < t[:, None])).any(-1)
        contrib = v_hc * (we / torch.clamp(npdf, min=1e-12) / (j + 1.0))[:, None]
        total = total + torch.where((v_ok & ~blocked)[:, None], contrib, 0.0)
    return total
