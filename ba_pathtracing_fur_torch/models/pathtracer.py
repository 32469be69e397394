"""Wavefront progressive path tracer.

Counterpart of `ba_pathtracing_fur_tpu/models/pathtracer.py`. A sample is a
wavefront of `[R]`-shaped ray state, and the samples are averaged as the
running mean `acc + (c - acc) / (i + 1)`. The JAX bounce loop is a
`fori_loop`; here it is a Python loop, so `bounce` is a plain int.

With `fused_shading=False` (the default, as in the JAX package) each
bounce is `trace_bounce`, the JAX package's unfused bounce op for op: the
closest hit (`ops/traverse.closest_hit`, a traversal kernel on a BVH), the
analytic light hits, the textured material gather, NEE with its shadow
any-hit (`models/shading`), the surface BSDF sample or the hair walk's
step, and the throughput update, all in torch around the traversal
kernels. With `fused_shading=True` each bounce is `trace_bounce_fused`:

  * on scenes that pass `full_fuse_eligible` (small untextured triangle
    scenes without a BVH: the Cornell class) one call of
    `ops/cuda/shade.shade_bounce_full`, the whole bounce in one kernel;
  * on every other scene (fur, BVHs) the JAX package's general branch, step
    for step: the closest hit (`ops/traverse.closest_hit`: a traversal
    kernel for BVH packs, the brute-force kernel or the dense grid
    otherwise) and the Hit assembly, the environment colour, the shade
    kernel (`ops/cuda/shade.shade_bounce`, which draws the bounce's
    uniforms from each ray's key and gathers its material row itself), the
    shadow any-hit, and the masked add of the NEE term.

On the card each kernel is a CUDA launch; on the CPU its plain twin runs.
Only `compact=False` is ported so far, and the fused path refuses textured
scenes; other configurations raise `NotImplementedError` naming the ROADMAP
item that brings them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..core import camera as cam_mod, rng, vecmath as vm
from ..models import bsdf, fur, shading
from ..models.shade_core import CoreCfg, _w3 as w3
from ..ops import intersect as isect, traverse
from ..ops.cuda import shade as cshade
from ..scene.types import (
    LIGHT_POINT, LIGHT_QUAD, MATFLAG_CYLINDER_T_BOUNCE, MATFLAG_CYLINDER_TR_BOUNCE,
    MATFLAG_EMISSIVE_BOUNCE, MATFLAG_SPECULAR_BOUNCE, SHADER_MARSCHNER_HAIR, DeviceScene,
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The same fields and defaults as the JAX package's RenderConfig."""

    depth: int = 5  # Demo default max bounces (Demo/main.cpp:209)
    spp: int = 100  # Demo default samples (Demo/main.cpp:210)
    ray_chunk: int = 8192  # sizes chunks in the JAX package only: the port takes whole wavefronts
    hair_p_random: bool = False
    tonemap: bool = False
    mis: bool = False  # NEE + BSDF light hits combined by the power heuristic
    rr: bool = False  # Russian roulette from `rr_start` bounces on
    rr_start: int = 2
    bdpt: bool = False
    bdpt_bounces: int = 3
    bdpt_samples_per_light: int = 8
    bdpt_splat: bool = True
    compact: bool = True
    spp_batch: int = 1  # samples per wavefront; must divide spp, else 1
    qmc: bool = False  # Hammersley subpixel jitter
    remat: bool = False  # autodiff memory knob; no effect on the forward render
    clamp_throughput: float = 1e4
    fused_shading: bool = False
    joint_shadows: bool = False


@dataclasses.dataclass
class RayState:
    """The wavefront as SoA tensors."""

    origin: torch.Tensor  # [R,3]
    direction: torch.Tensor  # [R,3]
    radiance: torch.Tensor  # [R,3] path throughput
    color: torch.Tensor  # [R,3] accumulated sample colour
    flags: torch.Tensor  # [R] int32 mat_flags
    theta_i: torch.Tensor  # [R] hair shader stash
    prev_pdf: torch.Tensor  # [R] pdf of the last BSDF sample; -1 = delta/camera


def init_state(origins: torch.Tensor, directions: torch.Tensor) -> RayState:
    r = origins.shape[0]
    dev = origins.device
    return RayState(
        origin=origins.contiguous(), direction=directions.contiguous(),
        radiance=torch.ones((r, 3), dtype=torch.float32, device=dev),
        color=torch.zeros((r, 3), dtype=torch.float32, device=dev),
        flags=torch.zeros((r,), dtype=torch.int32, device=dev),
        theta_i=torch.zeros((r,), dtype=torch.float32, device=dev),
        prev_pdf=torch.full((r,), -1.0, dtype=torch.float32, device=dev))


@dataclasses.dataclass
class BounceTables:
    """The per-scene tables of the full-bounce pass, built once per render."""

    tris: torch.Tensor
    mats: torch.Tensor
    lights: torch.Tensor

    @classmethod
    def of(cls, scene: DeviceScene) -> "BounceTables":
        return cls(tris=cshade.pack_tris_table(scene.tris),
                   mats=cshade.pack_mats_table(scene.materials),
                   lights=cshade.pack_lights_table(scene.lights))


def check_supported(scene: DeviceScene, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.bdpt:
        raise NotImplementedError("bidirectional mode is not ported yet (ROADMAP M11)")
    if cfg.joint_shadows:
        raise NotImplementedError("joint closest+shadow traversal measured negative "
                                  "and is not ported (ROADMAP, do-not-port list)")
    if cfg.compact:
        raise NotImplementedError("stream compaction is not ported yet (ROADMAP M6)")
    if cfg.tonemap:
        raise NotImplementedError("tone mapping is not ported yet (ROADMAP M6)")


def full_bounce_inputs(state: RayState, scene: DeviceScene, keys: torch.Tensor, bounce: int,
                       cfg: RenderConfig, tables: BounceTables) -> dict:
    """The keyword arguments of `shade_bounce_full` for this bounce: the ray
    state, the tables, and the draws u_bsdf/u_pick/u_light/u_hairp (and u_rr
    when `cfg.rr`) with the tags 0-4 of the JAX package."""
    u = rng.bounce_uniforms(keys, bounce, 5 if cfg.rr else 4, 2)  # [tags, R, 2]
    u_pick = u[1, :, 0].contiguous()
    return dict(
        origin=state.origin, direction=state.direction, radiance=state.radiance,
        color=state.color, flags=state.flags, theta_i=state.theta_i, prev_pdf=state.prev_pdf,
        mats_table=tables.mats, tris_table=tables.tris, lights_table=tables.lights,
        env_color3=scene.env.color, env_ambient=scene.env.ambient,
        n_lights=scene.lights.count, n_tris=scene.tris.count, n_mats=scene.materials.count,
        u_bsdf=u[0], u_pick=u_pick, u_light=u[2], u_hairp=u[3, :, 0],
        u_rr=u[4, :, 0].contiguous() if cfg.rr else None,
        rr_gate=bounce >= cfg.rr_start,
        cfg=core_cfg(scene, cfg))


def core_cfg(scene: DeviceScene, cfg: RenderConfig) -> CoreCfg:
    return CoreCfg(n_lights=scene.lights.count, mis=cfg.mis, rr=cfg.rr,
                   has_hair=scene.has_hair, hair_p_random=cfg.hair_p_random,
                   clamp_throughput=cfg.clamp_throughput, bsdfs_present=scene.bsdfs_present)


def shade_inputs(state: RayState, scene: DeviceScene, keys: torch.Tensor, bounce: int,
                 cfg: RenderConfig, hit, tables: BounceTables) -> dict:
    """The keyword arguments of `shade_bounce` for this bounce: the ray
    state, the hit with its material id, the material and light tables,
    the environment colour, and the per-sample keys with the bounce, from
    which the shade stage draws u_bsdf/u_pick/u_light/u_hairp (and u_rr
    when `cfg.rr`) with the tags 0-4 of the JAX package. No draw and no
    material gather happens here."""
    bsdf.require_untextured(scene.textures)
    return dict(
        origin=state.origin, direction=state.direction, radiance=state.radiance,
        color=state.color, flags=state.flags, theta_i=state.theta_i, prev_pdf=state.prev_pdf,
        hit_t=hit.t, hit_valid=hit.valid, hit_pos=hit.position, hit_normal=hit.normal,
        fib_u=hit.fiber_u, fib_v=hit.fiber_v, fib_w=hit.fiber_w, mat_id=hit.mat_id,
        mats_table=tables.mats, keys=keys, bounce=bounce,
        env_color=shading.environment_color(scene.env, state.direction),
        env_ambient=scene.env.ambient, lights_table=tables.lights,
        n_lights=scene.lights.count, rr_gate=bounce >= cfg.rr_start, cfg=core_cfg(scene, cfg))


def trace_bounce_fused(state: RayState, scene: DeviceScene, keys: torch.Tensor,
                       bounce: int, cfg: RenderConfig,
                       tables: Optional[BounceTables] = None) -> RayState:
    """One bounce. Level-2 scenes run it as one full-bounce pass; every
    other scene runs closest hit -> Hit assembly -> env colour -> shade
    kernel (draws and material rows inside) -> shadow any-hit -> NEE add."""
    check_supported(scene, cfg)
    tables = BounceTables.of(scene) if tables is None else tables
    if cshade.full_fuse_eligible(scene):
        return RayState(**cshade.shade_bounce_full(
            **full_bounce_inputs(state, scene, keys, bounce, cfg, tables)))

    do_trace = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
    t_cap = torch.where(do_trace, traverse.INF, 0.0)
    hit = traverse.closest_hit(state.origin, state.direction, scene, t_max=t_cap)
    out = cshade.shade_bounce(**shade_inputs(state, scene, keys, bounce, cfg, hit, tables))
    color = out["color"]
    if scene.lights.count:
        blocked = traverse.any_hit(out["shadow_o"], out["shadow_d"], scene,
                                   out["shadow_tmax"])
        color = color + torch.where(blocked[:, None], 0.0, out["direct_rgb"])
    return RayState(origin=out["origin"], direction=out["direction"],
                    radiance=out["radiance"], color=color, flags=out["flags"],
                    theta_i=out["theta_i"], prev_pdf=out["prev_pdf"])


def trace_bounce(state: RayState, scene: DeviceScene, keys: torch.Tensor, bounce: int,
                 cfg: RenderConfig) -> RayState:
    """One unfused wavefront bounce (the JAX package's `trace_bounce`,
    traceRays' body): trace, then shade per shader in torch. The bounce's
    uniforms are tags 0-3 of `rng.bounce_uniforms` (and 4 under RR), the
    JAX package's draws. `cfg.ray_chunk` is not read: JAX chunks the
    traversal by it, but its ray sort permutes and its Hit is the same per
    ray, so the port traces whole wavefronts."""
    check_supported(scene, cfg)
    active = (state.radiance != 0.0).any(-1)
    do_trace = active & (state.direction != 0.0).any(-1)
    t_cap = torch.where(do_trace, traverse.INF, 0.0)  # dead lanes trace nothing
    hit = traverse.closest_hit(state.origin, state.direction, scene, t_max=t_cap)

    # analytic light intersections (traceRay:185-208)
    n_lights = scene.lights.count
    if n_lights:
        t_l, _ = isect.light_hit_grid(state.origin, state.direction, scene.lights)
        light_idx = torch.argmin(t_l, dim=-1)
        t_light = t_l.gather(-1, light_idx[:, None])[:, 0]
        light_wins = t_light < hit.t
    else:
        light_wins = torch.zeros_like(do_trace)
    miss = do_trace & ~hit.valid & ~light_wins
    hit_light = do_trace & light_wins
    hit_geom = do_trace & hit.valid & ~light_wins

    color, radiance = state.color, state.radiance
    # EnvironmentShader (EnvironmentShader.h:21-28)
    color = color + w3(miss, shading.environment_color(scene.env, state.direction) * radiance,
                       0.0)
    # LightShader (LightShader.h:20-26), MIS-weighted against the NEE strategy
    if n_lights:
        lrad = shading.light_emitted_radiance(scene.lights, light_idx, state.direction)
        if cfg.mis:
            p_b = state.prev_pdf
            p_l = shading.light_solid_angle_pdf(scene.lights, light_idx, state.direction,
                                                t_light)
            kind = scene.lights.kind[light_idx]
            area_like = (kind == LIGHT_QUAD) | (kind == LIGHT_POINT)
            w = torch.where(p_b <= 0.0, 1.0,
                            torch.where(area_like, shading.power_heuristic(p_b, p_l), 0.0))
            lrad = lrad * w[:, None]
        color = color + w3(hit_light, lrad * radiance, 0.0)
    radiance = w3(miss | hit_light, 0.0, radiance)

    # the hit fields of missed rays, made finite (the shading below is
    # masked by hit_geom)
    dev = state.origin.device
    up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    valid = hit.valid
    n = w3(valid, hit.normal, up)
    hit = dataclasses.replace(
        hit, normal=n, position=w3(valid, hit.position, 0.0),
        fiber_u=w3(valid, hit.fiber_u, torch.tensor([1.0, 0.0, 0.0], device=dev)),
        fiber_v=w3(valid, hit.fiber_v, up),
        fiber_w=w3(valid, hit.fiber_w, torch.tensor([0.0, 0.0, 1.0], device=dev)))
    mp = bsdf.gather_materials(scene.materials, hit.mat_id, hit.uv, scene.textures,
                               scene.tex_slots)
    counter = -vm.normalize(state.direction)
    u = rng.bounce_uniforms(keys, bounce, 5 if cfg.rr else 4, 2)  # [tags, R, 2]

    # NEE, shared by both shaders (calcDirectLight)
    nee = shading.calc_direct_light_mis if cfg.mis else shading.calc_direct_light
    direct = nee(scene, mp, hit, state.direction, u[1, :, 0], u[2], active=hit_geom)
    # ambient = env_ambient * evaluateLight(n, n) / pi (SimpleShader.h:47)
    ambient = scene.env.ambient * bsdf.evaluate_light(mp, n, n, n) / math.pi
    accum = (direct + ambient) * radiance

    bs = bsdf.sample_surface(mp, counter, n, u[0], state.flags, present=scene.bsdfs_present)
    if scene.has_hair:
        # the hair walk's step, selected per ray against the surface sample
        p_choice = (torch.clamp((u[3, :, 0] * 3).to(torch.int32), max=2)
                    if cfg.hair_p_random else torch.zeros_like(state.flags))
        hs = fur.sample_hair(mp, counter, n, hit.fiber_u, hit.fiber_v, hit.fiber_w,
                             state.flags, p_choice)
        is_hair = mp.shader_id == SHADER_MARSCHNER_HAIR
        refl, wo = w3(is_hair, hs.reflectance, bs.reflectance), w3(is_hair, hs.wo, bs.wo)
        pdf = torch.where(is_hair, hs.pdf, bs.pdf)
        new_flags = torch.where(is_hair, hs.flags, bs.flags)
        hs_theta_i = hs.theta_i
    else:
        is_hair = torch.zeros_like(hit_geom)
        refl, wo, pdf, new_flags = bs
        hs_theta_i = state.theta_i

    # the common cutoff (SimpleShader.h:61-62, MarschnerHairShader.h:78);
    # unbiased RR replaces the throughput cutoff
    kill = (refl == 0.0).all(-1) | (pdf <= 1e-4)
    if not cfg.rr:
        kill = kill | (radiance.amax(-1) < 0.01)
    emissive = (new_flags & MATFLAG_EMISSIVE_BOUNCE) != 0
    mid_walk = (new_flags & (MATFLAG_CYLINDER_T_BOUNCE | MATFLAG_CYLINDER_TR_BOUNCE)) != 0

    # ray offset (SimpleShader.h:86-95)
    specular = (new_flags & MATFLAG_SPECULAR_BOUNCE) != 0
    offset = w3(specular, 1e-4 * wo, vm.faceforward(-1e-4 * n, n, wo))
    new_origin = hit.position + offset

    # SimpleShader colour and throughput (SimpleShader.h:31-98)
    simple_color = accum + w3(emissive & ~kill, mp.emission * radiance, 0.0)
    simple_radiance = w3(kill | emissive, 0.0, radiance * refl * (
        vm.dot(wo, n).abs() / torch.clamp(pdf, min=1e-20))[:, None])
    # MarschnerHairShader (MarschnerHairShader.h:31-84)
    hair_color = w3(mid_walk, 0.0, accum)
    hair_radiance = w3(mid_walk, radiance, w3(
        kill, 0.0, radiance * 3.0 * refl * torch.cos(hs_theta_i).abs()[:, None]))

    color = color + w3(hit_geom, w3(is_hair, hair_color, simple_color), 0.0)
    radiance = w3(hit_geom, w3(is_hair, hair_radiance, simple_radiance), radiance)
    radiance = torch.clamp(radiance, max=cfg.clamp_throughput)

    if cfg.rr:
        q = torch.clamp(radiance.amax(-1), 0.05, 1.0)
        do_rr = hit_geom & ~mid_walk if bounce >= cfg.rr_start else torch.zeros_like(hit_geom)
        dead = do_rr & (u[4, :, 0] >= q)
        boost = torch.where(do_rr & ~dead, 1.0 / q, 1.0)
        radiance = w3(dead, 0.0, radiance * boost[:, None])

    # continuing rays take the new ray; the hair walk moves its ray even
    # mid-walk and writes its flags always, the simple shader only when
    # continuing (SimpleShader.h:84)
    continuing = hit_geom & ~kill & ~emissive
    move = continuing | (hit_geom & is_hair)
    flags = torch.where(hit_geom & is_hair, new_flags,
                        torch.where(continuing & ~is_hair, new_flags, state.flags))
    prev_pdf = state.prev_pdf
    if cfg.mis:
        spdf = torch.where(is_hair, -1.0, bsdf.sample_pdf(mp, n, counter, wo))
        prev_pdf = torch.where(hit_geom, spdf, prev_pdf)
    return RayState(origin=w3(move, new_origin, state.origin),
                    direction=w3(move, wo, state.direction), radiance=radiance, color=color,
                    flags=flags,
                    theta_i=torch.where(hit_geom & is_hair, hs_theta_i, state.theta_i),
                    prev_pdf=prev_pdf)


def camera_wavefront(camera: cam_mod.Camera, pixel_ids: torch.Tensor, key: torch.Tensor,
                     sample_ids: Sequence[int], cfg: RenderConfig):
    """The camera rays of samples `sample_ids` for the global `pixel_ids`,
    as ONE wavefront of len(sample_ids) * len(pixel_ids) rays ->
    (RayState, keys [S*R, 2])."""
    w, _ = camera.resolution
    key = key.to(pixel_ids.device)
    keys, jitter, dof_u = [], [], []
    for s in sample_ids:
        k = rng.keys_for_pixels(key, pixel_ids, s)
        keys.append(k)
        jitter.append(rng.qmc_jitter(key, pixel_ids, s, cfg.spp) if cfg.qmc
                      else rng.bounce_uniform(k, -1, 2, tag=7))
        if camera.use_dof:
            dof_u.append(rng.bounce_uniform(k, -1, 2, tag=8))
    keys = torch.cat(keys)
    px = (pixel_ids % w).to(torch.float32).repeat(len(sample_ids))
    py = (pixel_ids // w).to(torch.float32).repeat(len(sample_ids))
    o, d = cam_mod.rays_from_pixels(camera, px, py, torch.cat(jitter),
                                    torch.cat(dof_u) if dof_u else None)
    return init_state(o, d), keys


def _render_samples(scene: DeviceScene, camera: cam_mod.Camera, pixel_ids: torch.Tensor,
                    key: torch.Tensor, sample_ids: Sequence[int], cfg: RenderConfig,
                    tables: Optional[BounceTables] = None) -> torch.Tensor:
    """Samples `sample_ids` for the global `pixel_ids`, traced as one
    wavefront -> `[S, R, 3]`: `trace_bounce_fused` a bounce with
    `cfg.fused_shading`, else `trace_bounce` (the JAX package's
    `render_sample_ids` dispatch)."""
    check_supported(scene, cfg)
    state, keys = camera_wavefront(camera, pixel_ids, key, sample_ids, cfg)
    if cfg.fused_shading:
        tables = BounceTables.of(scene) if tables is None else tables
        for b in range(cfg.depth):
            state = trace_bounce_fused(state, scene, keys, b, cfg, tables)
    else:
        for b in range(cfg.depth):
            state = trace_bounce(state, scene, keys, b, cfg)
    return state.color.reshape(len(sample_ids), pixel_ids.shape[0], 3)


def render_sample_ids(scene: DeviceScene, camera: cam_mod.Camera, pixel_ids: torch.Tensor,
                      key: torch.Tensor, sample_idx: int, cfg: RenderConfig,
                      tables: Optional[BounceTables] = None) -> torch.Tensor:
    """One progressive sample for a set of global pixel ids -> `[R, 3]`.
    Keys depend on the global id, so any partition of the image renders
    bit-identically to the whole."""
    return _render_samples(scene, camera, pixel_ids, key, [sample_idx], cfg, tables)[0]


def render_sample(scene: DeviceScene, camera: cam_mod.Camera, key: torch.Tensor,
                  sample_idx: int, cfg: RenderConfig,
                  tables: Optional[BounceTables] = None) -> torch.Tensor:
    """One full progressive sample -> per-pixel colour `[W*H, 3]`."""
    w, h = camera.resolution
    pixel_ids = torch.arange(w * h, device=scene.device)
    return render_sample_ids(scene, camera, pixel_ids, key, sample_idx, cfg, tables)


def render_image(scene: DeviceScene, camera: cam_mod.Camera, key: torch.Tensor,
                 cfg: RenderConfig) -> torch.Tensor:
    """Full render: the running mean of `cfg.spp` samples -> `[H, W, 3]`,
    on the scene's device."""
    check_supported(scene, cfg)
    w, h = camera.resolution
    bsz = cfg.spp_batch if cfg.spp_batch > 1 and cfg.spp % cfg.spp_batch == 0 else 1
    tables = BounceTables.of(scene) if cfg.fused_shading else None
    pixel_ids = torch.arange(w * h, device=scene.device)
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
    for i in range(cfg.spp // bsz):
        cs = _render_samples(scene, camera, pixel_ids, key,
                             range(i * bsz, (i + 1) * bsz), cfg, tables)
        acc = acc + (cs.mean(0) - acc) / (i + 1.0)
    return acc.reshape(h, w, 3)
