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

With `joint_shadows=True` as well, on a scene that `ops/traverse.
joint_eligible` passes (one two-level BVH: the hair ball), each bounce is
`trace_bounce_fused_joint`: bounce b's shadow rays ride in bounce b + 1's
closest-hit launch (one mixed launch of the streaming kernel), and the
image equals the separate bounces' bit for bit.

On the card each kernel is a CUDA launch; on the CPU its plain twin runs.
A sample's camera wavefront (each pixel's key, jitter and camera ray, and
the initial state) is one launch of the camera kernel (`ops/cuda/camera`).

With `compact=True` (the default, as in the JAX package) the wavefront is
compacted after every bounce: the rays with a non-zero throughput move to
the front in a stable order (`ops/compact`), the keys and each ray's pixel
slot travel with them, and the colour is scattered back by slot at the end.
Each ray's result does not depend on its position, so the image equals the
`compact=False` image bit for bit; the dense grid skips its chunks past the
live prefix `n_alive`.

The unfused path is differentiable on torch autograd (`diff/fit.py`): the
traversal kernels only pick rows from detached rays, and every value the
image depends on is computed in torch. `remat` recomputes each bounce in
the backward pass (`torch.utils.checkpoint`) instead of keeping its
intermediates. The fused path runs kernels without a backward and raises
under autograd. `tonemap` maps the finished image (`ops/tonemap`).
`render_progressive` yields the running mean after each sample, as the
CLI and `utils/checkpoint.render_resumable` consume it.

While a torch.profiler session records, a pass, its camera wavefront, each
bounce and the running mean are spans of `utils/profiling` (`pass`,
`camera`, `bounce`, `mean`), and each bounce counts its lanes (`rays`),
the lanes it traces (`live`) and its shadow rays with t_max > 0
(`shadow_live`); off, each costs one boolean read.

`render_sample_ids(..., closest_fn=, occlude_fn=)` is the JAX package's
seam for the geometry-sharded render (`parallel/render.py`): the hooks
`closest_fn(o, d, scene) -> Hit` and `occlude_fn(o, d, scene, t_max) ->
blocked` replace every closest hit and any hit of the sample (the bounces,
NEE, BDPT's walk, connections and splat), and the full-bounce pass is
skipped while a hook is given. Without hooks nothing changes.

With `bdpt=True` (bidirectional mode, as in the JAX package) each sample
builds its light-subpath buffer once (`models/bdpt.build_light_subpaths`,
keyed by fold_in(fold_in(key, sample), 0x1bb)), the eye-vertex connection
(`bdpt.connect_eye_vertex`) replaces NEE in the unfused bounce, and with
`bdpt_splat` the camera-plane splat is added after the bounce loop. BDPT
always runs the unfused bounce, `fused_shading` or not, as the JAX package
does. A wavefront of several samples stacks their buffers; each ray reads
its own sample's (slot // pixels, which compaction carries along).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.utils.checkpoint

from ..core import camera as cam_mod, rng, vecmath as vm
from ..models import bdpt as bdpt_mod, bsdf, fur, shading
from ..models.shade_core import CoreCfg, _w3 as w3
from ..ops import compact, intersect as isect, tonemap, traverse
from ..ops.cuda import camera as ccamera, shade as cshade
from ..scene.types import (
    LIGHT_POINT, LIGHT_QUAD, MATFLAG_CYLINDER_T_BOUNCE, MATFLAG_CYLINDER_TR_BOUNCE,
    MATFLAG_EMISSIVE_BOUNCE, MATFLAG_SPECULAR_BOUNCE, SHADER_MARSCHNER_HAIR, DeviceScene,
)
from ..utils import profiling


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
    remat: bool = False  # recompute each bounce in the backward pass
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
    return RayState(*ccamera.state_fields(origins, directions))


@dataclasses.dataclass
class BounceTables:
    """The per-scene tables of the fused bounce, built once per render: the
    texture ids [M, 6] only for a textured scene."""

    tris: torch.Tensor
    mats: torch.Tensor
    lights: torch.Tensor
    tex: Optional[torch.Tensor] = None

    @classmethod
    def of(cls, scene: DeviceScene) -> "BounceTables":
        return cls(tris=cshade.pack_tris_table(scene.tris),
                   mats=cshade.pack_mats_table(scene.materials),
                   lights=cshade.pack_lights_table(scene.lights),
                   tex=None if scene.textures is None
                   else cshade.pack_tex_table(scene.materials))


def check_no_grad(scene: DeviceScene) -> None:
    """Raise for the fused path while autograd records and a tensor of the
    scene requires grad: its kernels (K1, K4) have no backward, and a
    render through them would give zero gradients."""
    parts = (scene.tris, scene.cones, scene.materials, scene.lights, scene.env)
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for p in parts for x in vars(p).values()):
        raise NotImplementedError(
            "the fused shading path (fused_shading=True: the shade and full-bounce "
            "kernels) is not differentiable: render with fused_shading=False (the unfused "
            "trace_bounce) to take gradients, or under torch.no_grad()")


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
    when `cfg.rr`) with the tags 0-4 of the JAX package; on a textured
    scene also the hit's uv, the atlas and the texture ids, from which it
    fetches the textured slots. No draw, no material gather and no texture
    fetch happens here."""
    tex = {} if scene.textures is None else dict(
        uv=hit.uv, textures=scene.textures, tex_table=tables.tex, tex_slots=scene.tex_slots)
    return dict(
        origin=state.origin, direction=state.direction, radiance=state.radiance,
        color=state.color, flags=state.flags, theta_i=state.theta_i, prev_pdf=state.prev_pdf,
        hit_t=hit.t, hit_valid=hit.valid, hit_pos=hit.position, hit_normal=hit.normal,
        fib_u=hit.fiber_u, fib_v=hit.fiber_v, fib_w=hit.fiber_w, mat_id=hit.mat_id,
        mats_table=tables.mats, keys=keys, bounce=bounce,
        env_color=shading.environment_color(scene.env, state.direction),
        env_ambient=scene.env.ambient, lights_table=tables.lights,
        n_lights=scene.lights.count, rr_gate=bounce >= cfg.rr_start, cfg=core_cfg(scene, cfg),
        **tex)


def _trace_cap(state: RayState) -> torch.Tensor:
    """t_max of the bounce's closest-hit rays: INF, 0 on dead lanes (they
    trace nothing); the live lanes are counted into the open span."""
    do_trace = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
    t_max = torch.where(do_trace, traverse.INF, 0.0)
    profiling.count_nonzero("live", t_max)
    return t_max


def _closest(state: RayState, scene: DeviceScene, n_alive, closest_fn):
    """The bounce's closest hit: `closest_fn(o, d, scene)` when given (the
    JAX package's seam; dead lanes are traced too and masked by the
    shading), else `traverse.closest_hit` with dead lanes at t_max = 0."""
    if closest_fn is not None:
        return closest_fn(state.origin, state.direction, scene)
    return traverse.closest_hit(state.origin, state.direction, scene, t_max=_trace_cap(state),
                                n_alive=n_alive)


def _shade_stage(state: RayState, scene: DeviceScene, keys: torch.Tensor, bounce: int,
                 cfg: RenderConfig, hit, tables: BounceTables):
    """The post-traversal half of a general fused bounce (the JAX package's
    `_fused_shade_stage`): the shade kernel on the hit -> (the next ray
    state, its colour without the NEE term; the pending NEE term: its
    shadow rays `o`, `d`, `tmax` and its colour `direct`)."""
    out = cshade.shade_bounce(**shade_inputs(state, scene, keys, bounce, cfg, hit, tables))
    profiling.count_nonzero("shadow_live", out["shadow_tmax"])
    nxt = RayState(origin=out["origin"], direction=out["direction"], radiance=out["radiance"],
                   color=out["color"], flags=out["flags"], theta_i=out["theta_i"],
                   prev_pdf=out["prev_pdf"])
    return nxt, dict(o=out["shadow_o"], d=out["shadow_d"], tmax=out["shadow_tmax"],
                     direct=out["direct_rgb"])


def _add_unblocked(state: RayState, pend: dict, blocked: torch.Tensor) -> RayState:
    """The state with the pending NEE colour added where its shadow ray is
    not blocked."""
    with profiling.span("nee"):
        return dataclasses.replace(
            state, color=state.color + torch.where(blocked[:, None], 0.0, pend["direct"]))


def trace_bounce_fused(state: RayState, scene: DeviceScene, keys: torch.Tensor,
                       bounce: int, cfg: RenderConfig,
                       tables: Optional[BounceTables] = None, n_alive=None,
                       closest_fn=None, occlude_fn=None) -> RayState:
    """One bounce. Level-2 scenes run it as one full-bounce pass; every
    other scene runs closest hit -> Hit assembly -> env colour -> shade
    kernel (draws and material rows inside) -> shadow any-hit -> NEE add.
    `n_alive`: the live prefix of a compacted wavefront (the traversal's
    dense grid skips the chunks past it). `closest_fn(o, d, scene) -> Hit`
    and `occlude_fn(o, d, scene, t_max) -> blocked` replace the closest hit
    and the shadow any-hit (the geometry-sharded render's seam,
    `parallel/render.py`); with either, the full-bounce pass is skipped, as
    the JAX package skips it. Raises under autograd."""
    check_no_grad(scene)
    tables = BounceTables.of(scene) if tables is None else tables
    if closest_fn is None and occlude_fn is None and cshade.full_fuse_eligible(scene):
        return RayState(**cshade.shade_bounce_full(
            **full_bounce_inputs(state, scene, keys, bounce, cfg, tables)))

    hit = _closest(state, scene, n_alive, closest_fn)
    state, pend = _shade_stage(state, scene, keys, bounce, cfg, hit, tables)
    if scene.lights.count:
        if occlude_fn is None:
            blocked = traverse.any_hit(pend["o"], pend["d"], scene, pend["tmax"],
                                       n_alive=n_alive)
        else:
            blocked = occlude_fn(pend["o"], pend["d"], scene, pend["tmax"])
        state = _add_unblocked(state, pend, blocked)
    return state


def init_pending(r: int, device) -> dict:
    """The pending NEE term before bounce 0: no shadow rays (t_max 0 rays
    are inert in the mixed launch) and no colour."""
    z3 = torch.zeros((r, 3), dtype=torch.float32, device=device)
    return dict(o=z3, d=z3, tmax=torch.zeros((r,), dtype=torch.float32, device=device),
                direct=z3)


def trace_bounce_fused_joint(state: RayState, pend: dict, scene: DeviceScene,
                             keys: torch.Tensor, bounce: int, cfg: RenderConfig,
                             tables: Optional[BounceTables] = None, n_alive=None):
    """`trace_bounce_fused` with its shadow rays deferred one bounce (the
    JAX package's `trace_bounce_fused_joint`): the previous bounce's shadow
    rays `pend` ride in this bounce's closest-hit launch
    (`traverse.joint_closest_any`, one mixed K3 launch; a pair shares its
    origin), their unblocked colour is added before the shade kernel runs,
    and the kernel's shadow rays become the new pending term -> (state,
    pend). The caller resolves the last pending term after the loop. The
    colour sums as in `trace_bounce_fused`: (shaded colour + NEE of bounce
    b) + the terms of bounce b + 1. Raises under autograd."""
    check_no_grad(scene)
    tables = BounceTables.of(scene) if tables is None else tables
    hit, blocked = traverse.joint_closest_any(state.origin, state.direction, _trace_cap(state),
                                              pend["o"], pend["d"], pend["tmax"], scene,
                                              n_alive=n_alive)
    return _shade_stage(_add_unblocked(state, pend, blocked), scene, keys, bounce, cfg, hit,
                        tables)


def trace_bounce(state: RayState, scene: DeviceScene, keys: torch.Tensor, bounce: int,
                 cfg: RenderConfig, n_alive=None, subpaths=None, sample=None,
                 closest_fn=None, occlude_fn=None) -> RayState:
    """One unfused wavefront bounce (the JAX package's `trace_bounce`,
    traceRays' body): trace, then shade per shader in torch. The bounce's
    uniforms are tags 0-3 of `rng.bounce_uniforms` (and 4 under RR), the
    JAX package's draws. `cfg.ray_chunk` is not read: JAX chunks the
    traversal by it, but its ray sort permutes and its Hit is the same per
    ray, so the port traces whole wavefronts. `n_alive`: the live prefix of
    a compacted wavefront, passed to the closest hit and the NEE shadow
    any-hit. With `cfg.bdpt` and a light-subpath buffer `subpaths` the
    connection to it replaces NEE (`sample` [R]: each ray's sample in a
    stacked buffer); lanes without a geometry hit connect with t_max = 0,
    their term being unused. `closest_fn` / `occlude_fn` replace the
    closest hit and every shadow any-hit, as in `trace_bounce_fused`."""
    do_trace = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
    hit = _closest(state, scene, n_alive, closest_fn)

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
            # the pdf only weighs rays that hit the light: a finite t on the
            # others keeps inf * 0 out of the gradient
            p_l = shading.light_solid_angle_pdf(scene.lights, light_idx, state.direction,
                                                torch.where(light_wins, t_light, 1.0))
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

    # NEE, shared by both shaders (calcDirectLight); in BDPT mode the
    # light-subpath connection replaces it (pt_shade.compute:146)
    if cfg.bdpt and subpaths is not None:
        direct = bdpt_mod.connect_eye_vertex(scene, subpaths, u[2], hit.position, n,
                                             state.direction, mp, bounce, sample=sample,
                                             active=hit_geom, n_alive=n_alive,
                                             occlude_fn=occlude_fn)
    else:
        nee = shading.calc_direct_light_mis if cfg.mis else shading.calc_direct_light
        direct = nee(scene, mp, hit, state.direction, u[1, :, 0], u[2], active=hit_geom,
                     n_alive=n_alive, occlude_fn=occlude_fn)
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
    (RayState, keys [S*R, 2]): the camera kernel on the card (one launch a
    sample), its torch chain on the CPU (`ops/cuda/camera.camera_rays`)."""
    with profiling.span("camera"):
        keys, fields = ccamera.camera_rays(camera, pixel_ids, key, sample_ids, cfg.qmc, cfg.spp)
        return RayState(*fields), keys


def _render_samples(scene: DeviceScene, camera: cam_mod.Camera, pixel_ids: torch.Tensor,
                    key: torch.Tensor, sample_ids: Sequence[int], cfg: RenderConfig,
                    tables: Optional[BounceTables] = None, closest_fn=None,
                    occlude_fn=None) -> torch.Tensor:
    """Samples `sample_ids` for the global `pixel_ids`, traced as one
    wavefront -> `[S, R, 3]`: `trace_bounce_fused` a bounce with
    `cfg.fused_shading` (and not `cfg.bdpt`), else `trace_bounce` (the JAX
    package's `render_sample_ids` dispatch). With `cfg.compact` the whole
    wavefront is compacted after each bounce (the live rays first, their
    keys and pixel slots with them) and the colour scattered back by slot;
    with `cfg.remat`, while autograd records, each bounce is recomputed in
    the backward pass instead of keeping its intermediates. With `cfg.bdpt`
    (and lights) each sample's light subpaths are built first and stacked;
    a ray's sample is its slot // len(pixel_ids). `closest_fn` /
    `occlude_fn` replace every closest hit and any hit of the sample (the
    bounces, the light-subpath walk, the connections and the splat).

    With `cfg.joint_shadows` on the fused path, without hooks, with lights
    and on a `traverse.joint_eligible` scene (the JAX package's conditions),
    each bounce is `trace_bounce_fused_joint`: bounce b's shadow rays are
    traced in bounce b + 1's mixed launch, a compacted lane stays alive while
    its shadow ray is pending, and the last bounce's shadow rays are traced
    by one `traverse.any_hit` after the loop. The image equals the separate
    fused image bit for bit."""
    state, keys = camera_wavefront(camera, pixel_ids, key, sample_ids, cfg)
    use_fused = cfg.fused_shading and not cfg.bdpt
    use_joint = (use_fused and cfg.joint_shadows and closest_fn is None and occlude_fn is None
                 and scene.lights.count > 0 and traverse.joint_eligible(scene))
    if use_fused:
        tables = BounceTables.of(scene) if tables is None else tables
    subpaths = None
    if cfg.bdpt and scene.lights.count:
        key = key.to(keys.device)
        subpaths = bdpt_mod.stack_subpaths([bdpt_mod.build_light_subpaths(
            scene, rng.fold_in(rng.fold_in(key, s), 0x1BB), cfg.bdpt_samples_per_light,
            cfg.bdpt_bounces, closest_fn=closest_fn) for s in sample_ids])
    n_pix = pixel_ids.shape[0]

    def step(st, ks, b, n_alive, sample):
        if use_fused:
            return trace_bounce_fused(st, scene, ks, b, cfg, tables, n_alive=n_alive,
                                      closest_fn=closest_fn, occlude_fn=occlude_fn)
        return trace_bounce(st, scene, ks, b, cfg, n_alive=n_alive, subpaths=subpaths,
                            sample=sample, closest_fn=closest_fn, occlude_fn=occlude_fn)

    remat = cfg.remat and torch.is_grad_enabled()
    keys0 = keys
    slot, n_alive = torch.arange(keys.shape[0], device=keys.device), None
    pend = init_pending(keys.shape[0], keys.device) if use_joint else None
    for b in range(cfg.depth):
        with profiling.span("bounce", bounce=b):
            profiling.count("rays", keys.shape[0])
            sample = slot // n_pix if subpaths is not None else None
            if use_joint:
                state, pend = trace_bounce_fused_joint(state, pend, scene, keys, b, cfg, tables,
                                                       n_alive=n_alive)
            elif remat:
                state = torch.utils.checkpoint.checkpoint(step, state, keys, b, n_alive, sample,
                                                          use_reentrant=False)
            else:
                state = step(state, keys, b, n_alive, sample)
            if cfg.compact:
                alive = (state.radiance != 0.0).any(-1)
                if use_joint:  # a pending shadow ray still owes its lane a colour
                    alive = alive | (pend["tmax"] > 0.0)
                perm, n_alive = compact.compaction_permutation(alive)
                state = compact.gather_fields(state, perm)
                keys, slot = keys[perm.long()], slot[perm.long()]
                if use_joint:
                    pend = {k: v[perm.long()] for k, v in pend.items()}
    if use_joint:
        state = _add_unblocked(state, pend, traverse.any_hit(pend["o"], pend["d"], scene,
                                                             pend["tmax"], n_alive=n_alive))
    color = state.color
    if cfg.compact:
        color = torch.zeros_like(color).index_copy(0, slot, color)
    if subpaths is not None and cfg.bdpt_splat:
        # the splat takes the un-permuted keys and pixel ids (as in JAX)
        ids = torch.arange(keys0.shape[0], device=keys0.device)
        color = color + bdpt_mod.splat_image_plane(scene, camera, subpaths,
                                                   pixel_ids.repeat(len(sample_ids)), keys0,
                                                   sample=ids // n_pix, occlude_fn=occlude_fn)
    return color.reshape(len(sample_ids), n_pix, 3)


def render_sample_ids(scene: DeviceScene, camera: cam_mod.Camera, pixel_ids: torch.Tensor,
                      key: torch.Tensor, sample_idx: int, cfg: RenderConfig,
                      tables: Optional[BounceTables] = None, closest_fn=None,
                      occlude_fn=None) -> torch.Tensor:
    """One progressive sample for a set of global pixel ids -> `[R, 3]`.
    Keys depend on the global id, so any partition of the image renders
    bit-identically to the whole. `closest_fn(o, d, scene) -> Hit` and
    `occlude_fn(o, d, scene, t_max) -> blocked [R]` replace the
    intersection backend (the seam of `parallel/render.py`)."""
    return _render_samples(scene, camera, pixel_ids, key, [sample_idx], cfg, tables,
                           closest_fn, occlude_fn)[0]


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
    on the scene's device, tone-mapped when `cfg.tonemap`."""
    w, h = camera.resolution
    bsz = cfg.spp_batch if cfg.spp_batch > 1 and cfg.spp % cfg.spp_batch == 0 else 1
    tables = BounceTables.of(scene) if cfg.fused_shading and not cfg.bdpt else None
    pixel_ids = torch.arange(w * h, device=scene.device)
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
    for i in range(cfg.spp // bsz):
        with profiling.span("pass", pass_index=i):
            cs = _render_samples(scene, camera, pixel_ids, key,
                                 range(i * bsz, (i + 1) * bsz), cfg, tables)
            with profiling.span("mean"):
                acc = acc + (cs.mean(0) - acc) / (i + 1.0)
    img = acc.reshape(h, w, 3)
    return tonemap.tonemap(img) if cfg.tonemap else img


def render_progressive(scene: DeviceScene, camera: cam_mod.Camera, key: torch.Tensor,
                       cfg: RenderConfig, accum: Optional[torch.Tensor] = None,
                       start_sample: int = 0):
    """The progressive loop (the reference's render() a frame,
    CPU_PathTracer.cpp:17-52, and the checkpoint/resume surface): yields
    (sample index, the running mean `[H, W, 3]` after it) for the samples
    `start_sample .. cfg.spp - 1`, continuing from `accum` (the mean of the
    samples before `start_sample`) when given. The mean is the JAX
    package's `acc + (c - acc) / (i + 1)`, on the scene's device."""
    w, h = camera.resolution
    r = w * h
    acc = (torch.zeros((r, 3), dtype=torch.float32, device=scene.device) if accum is None
           else accum.reshape(r, 3).to(scene.device))
    tables = BounceTables.of(scene) if cfg.fused_shading and not cfg.bdpt else None
    for i in range(start_sample, cfg.spp):
        with profiling.span("pass", pass_index=i):
            c = render_sample(scene, camera, key, i, cfg, tables)
            with profiling.span("mean"):
                acc = acc + (c - acc) / (i + 1.0)
        yield i, acc.reshape(h, w, 3)
