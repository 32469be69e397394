"""Next-event estimation, light radiance and the environment.

Counterpart of `ba_pathtracing_fur_tpu/models/shading.py`, function for
function and in its order of operations:

  * Light::calcLightdir of the four light kinds with their distance and
    angular attenuation (Light.cpp:127-495, Light.h:72);
  * SimpleShader::calcDirectLight: one light picked uniformly a ray, the
    shadow ray tested against the scene (`ops/traverse.any_hit`, a
    traversal kernel on a BVH) and against the analytic lights
    (`ops/intersect.light_hit_grid`), with no 1/N pick compensation
    (SimpleShader.h:101-152), and its MIS form `calc_direct_light_mis`;
  * the light-hit radiance (LightShader.h:20-26) and the environment on a
    miss, constant, sphere map or cube map (EnvironmentShader.h:21-28).

The reference's quirks stay for parity: a non-MIS shadow ray ends on the
light's own surface, so that light's hit sits at a near tie with t_max;
the MIS shadow ray is shortened by 1e-3 of its length.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import sampling as sp, vecmath as vm
from ..ops import intersect as isect, traverse
from ..scene.types import (
    ENV_COLOR, ENV_SPHERE_MAP, LIGHT_POINT, LIGHT_QUAD, LIGHT_SPOT, LIGHT_SUN, DeviceScene,
    Environment, LightPack,
)
from . import bsdf as bsdf_mod
from .shade_core import _w3, power_heuristic

def distance_attenuation(lights: LightPack, idx, dist):
    """Light.h:72: 1/(c + l d + q d^2) only when c > 0 or (l > 0 and q > 0)."""
    c = lights.const_att[idx]
    lin = lights.lin_att[idx]
    q = lights.quad_att[idx]
    use = (c > 0.0) | ((lin > 0.0) & (q > 0.0))
    denom = torch.clamp(c + lin * dist + q * dist * dist, min=1e-12)
    return torch.where(use, 1.0 / denom, 1.0)


class LightSample(NamedTuple):
    target: torch.Tensor  # [R,3] sampled point on or toward the light
    attenuation: torch.Tensor  # [R]


def sample_light_dir(lights: LightPack, idx, sample_pos, u) -> LightSample:
    """calcLightdir(randomize=True) for each ray's light `idx` [R] with
    uniforms u [R,2]: the target point (ray = target - sample_pos) and the
    attenuation, per kind."""
    idx = idx.long()
    pos = lights.position[idx]
    direction = lights.direction[idx]
    radius = lights.radius[idx]
    kind = lights.kind[idx]
    u1, u2 = u[:, 0], u[:, 1]

    # point (Light.cpp:127-145)
    dir0 = vm.normalize(pos - sample_pos)
    sphere_pt = sp.uniform_sphere_sample(u1, u2)
    p_pos = pos + sphere_pt * radius[:, None]
    dd_point = torch.clamp(vm.dot(sphere_pt, -dir0), 0.0, 1.0)
    att_point = dd_point * distance_attenuation(lights, idx, vm.length(p_pos - sample_pos))

    # quad (Light.cpp:278-296): bilinear corner interpolation
    v = lights.verts[idx]  # [R,4,3]
    x1 = v[:, 0] + u[:, 0:1] * (v[:, 1] - v[:, 0])
    x2 = v[:, 3] + u[:, 0:1] * (v[:, 2] - v[:, 3])
    q_pos = x1 + u[:, 1:2] * (x2 - x1)
    q_dir = q_pos - sample_pos
    dd_quad = torch.clamp(vm.dot(vm.normalize(-q_dir), direction), 0.0, 1.0)
    att_quad = dd_quad * distance_attenuation(lights, idx, vm.length(q_dir))

    # spot (Light.cpp:327-343): disk offset and quartic angular falloff
    s_pos = pos + sp.sample_disk_about(u1, u2, direction, radius)
    s_dir = s_pos - sample_pos
    angle = torch.rad2deg(torch.acos(torch.clamp(vm.dot(vm.normalize(-s_dir), direction),
                                                 -1.0 + 1e-7, 1.0 - 1e-7)))
    inner = lights.inner_angle[idx]
    outer = lights.outer_angle[idx]
    delta = 1.0 - torch.clamp((angle - inner) / torch.clamp(outer - inner, min=1e-6), 0.0, 1.0)
    delta2 = delta * delta
    att_spot = delta2 * delta2 * distance_attenuation(lights, idx, vm.length(s_dir))

    # sun (Light.cpp:463-475): a direction at 1e16
    sun_pos = 1e16 * vm.normalize(radius[:, None] * sp.uniform_sphere_sample(u1, u2)
                                  - direction)

    target = _w3(kind == LIGHT_POINT, p_pos, _w3(kind == LIGHT_QUAD, q_pos,
                                                 _w3(kind == LIGHT_SPOT, s_pos, sun_pos)))
    att = torch.where(kind == LIGHT_POINT, att_point,
                      torch.where(kind == LIGHT_QUAD, att_quad,
                                  torch.where(kind == LIGHT_SPOT, att_spot, 1.0)))
    return LightSample(target, att)


def light_emitted_radiance(lights: LightPack, idx, ray_dir):
    """The radiance seen on hitting light `idx` (sampleLightSource,
    Light.cpp:196-199, 234-239, 436-440, 508-511)."""
    idx = idx.long()
    color = lights.color[idx]
    kind = lights.kind[idx]
    c = lights.const_att[idx]
    cdiv = torch.where(c > 0.0, c, 1.0)[:, None]
    facing = vm.dot(vm.normalize(-ray_dir), lights.direction[idx]) >= 0.0
    inv_pi = 1.0 / math.pi
    rad_point = inv_pi * color / cdiv
    rad_dirlike = inv_pi * _w3(facing, color, 0.0) / cdiv
    return _w3(kind == LIGHT_POINT, rad_point, _w3(kind == LIGHT_SUN, color, rad_dirlike))


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


def quad_area(lights: LightPack, idx):
    """The area of a quad light's bilinear patch, as two triangles."""
    v = lights.verts[idx.long()]
    a1 = 0.5 * vm.length(vm.cross(v[:, 1] - v[:, 0], v[:, 3] - v[:, 0]))
    a2 = 0.5 * vm.length(vm.cross(v[:, 1] - v[:, 2], v[:, 3] - v[:, 2]))
    return torch.clamp(a1 + a2, min=1e-12)


def light_solid_angle_pdf(lights: LightPack, idx, direction, dist):
    """Solid-angle density of the NEE sampler producing `direction` toward
    light `idx` at `dist`, with the uniform 1/N pick: quad dist^2 / (A
    |cos theta_l|), point the disk cross-section dist^2 / (pi r^2), spot
    and sun 0."""
    idx = idx.long()
    kind = lights.kind[idx]
    is_quad, is_point = kind == LIGHT_QUAD, kind == LIGHT_POINT
    cos_l = vm.dot(vm.normalize(direction), lights.direction[idx]).abs()
    # each kind's density from a distance that is finite on the lanes of the
    # other kinds (a sun's 1e16, a missed light's INF): the same values, and
    # no inf * 0 in the gradient of the lanes that drop it
    d_quad, d_point = torch.where(is_quad, dist, 1.0), torch.where(is_point, dist, 1.0)
    p_quad = d_quad * d_quad / (quad_area(lights, idx) * torch.clamp(cos_l, min=1e-4))
    r = torch.clamp(lights.radius[idx], min=1e-6)
    p_point = d_point * d_point / (math.pi * r * r)
    p = torch.where(is_quad, p_quad, torch.where(is_point, p_point, 0.0))
    return p / lights.count


def _pick(lights: LightPack, u_pick):
    n = lights.count
    return torch.clamp((u_pick * n).to(torch.int32), max=n - 1).long()


def calc_direct_light_mis(scene: DeviceScene, mp, hit, ray_dir, u_pick, u_light, active=None,
                          n_alive=None, occlude_fn=None):
    """MIS-mode NEE: a uniform pick with 1/N compensation; quad and point
    lights in solid-angle measure weighted by the power heuristic against
    the BSDF pdf; spot and sun in the reference's attenuation form at weight
    1. The emitted radiance is `light_emitted_radiance`, the same Le a BSDF
    path sees on hitting the light. Dead lanes (`active` False) get a
    zero-length shadow ray; `n_alive` is the live prefix of a compacted
    wavefront, passed to the shadow any-hit. `occlude_fn(o, d, scene,
    t_max) -> blocked` replaces the any-hit (the geometry-sharded render's
    seam)."""
    lights = scene.lights
    n_lights = lights.count
    if n_lights == 0:
        return torch.zeros_like(hit.position)
    idx = _pick(lights, u_pick)
    ls = sample_light_dir(lights, idx, hit.position, u_light)

    origin0 = hit.position
    direction = ls.target - origin0
    dist = vm.length(direction)
    wi = vm.normalize(direction)
    origin = origin0 + 1e-4 * vm.faceforward(hit.normal, -wi, hit.normal)

    le = light_emitted_radiance(lights, idx, wi)
    f, bpdf = bsdf_mod.eval_pdf(mp, hit.normal, -vm.normalize(ray_dir), wi)
    cos_x = vm.dot(wi, hit.normal).abs()
    kind = lights.kind[idx]
    area_like = (kind == LIGHT_QUAD) | (kind == LIGHT_POINT)
    p_l = light_solid_angle_pdf(lights, idx, wi, dist)
    w = power_heuristic(p_l, bpdf)
    contrib_area = le * (cos_x * w / torch.clamp(p_l, min=1e-12))[:, None] * f
    contrib_ref = lights.color[idx] * (ls.attenuation * cos_x)[:, None] * f * n_lights
    contrib = _w3(area_like, contrib_area, contrib_ref)

    t_max = dist * (1.0 - 1e-3)  # stop short of the target itself
    if active is not None:
        t_max = torch.where(active, t_max, 0.0)
    blocked = (traverse.any_hit(origin, wi, scene, t_max, n_alive=n_alive)
               if occlude_fn is None else occlude_fn(origin, wi, scene, t_max))
    t_l, valid_l = isect.light_hit_grid(origin, wi, lights)
    other = torch.arange(n_lights, device=idx.device)[None, :] != idx[:, None]
    blocked = blocked | (valid_l & other & (t_l < t_max[:, None])).any(-1)
    has_color = (lights.color[idx] > 0.0).any(-1)
    return _w3(has_color & ~blocked, contrib, 0.0)


def calc_direct_light(scene: DeviceScene, mp, hit, ray_dir, u_pick, u_light, active=None,
                      n_alive=None, occlude_fn=None):
    """SimpleShader::calcDirectLight (SimpleShader.h:101-152): one light
    picked uniformly a ray, its contribution not divided by the pick
    probability; the shadow ray tests the scene and every analytic light.
    Dead lanes (`active` False) get a zero-length shadow ray; `n_alive` and
    `occlude_fn` as in `calc_direct_light_mis`."""
    lights = scene.lights
    if lights.count == 0:
        return torch.zeros_like(hit.position)
    idx = _pick(lights, u_pick)
    ls = sample_light_dir(lights, idx, hit.position, u_light)

    origin0 = hit.position
    direction = ls.target - origin0
    lightpos = origin0 + direction
    # the surface offset toward the light's side (SimpleShader.h:117)
    origin = origin0 + 1e-4 * vm.faceforward(hit.normal, origin0 - lightpos, hit.normal)
    wi = vm.normalize(direction)

    light_color = lights.color[idx]
    f = bsdf_mod.evaluate_light(mp, hit.normal, wi, -vm.normalize(ray_dir))
    contrib = light_color * ls.attenuation[:, None] * f * vm.dot(wi, hit.normal).abs()[:, None]

    t_max = vm.length(lightpos - origin)
    if active is not None:
        t_max = torch.where(active, t_max, 0.0)
    blocked = (traverse.any_hit(origin, wi, scene, t_max, n_alive=n_alive)
               if occlude_fn is None else occlude_fn(origin, wi, scene, t_max))
    # the light geometry occludes too (SimpleShader.h:135-144)
    t_l, valid_l = isect.light_hit_grid(origin, wi, lights)
    blocked = blocked | (valid_l & (t_l < t_max[:, None])).any(-1)
    has_color = (light_color > 0.0).any(-1)
    return _w3(has_color & ~blocked, contrib, 0.0)
