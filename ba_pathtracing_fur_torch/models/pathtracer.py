"""Wavefront progressive path tracer with fused shading.

Counterpart of `ba_pathtracing_fur_tpu/models/pathtracer.py`. A sample is a
wavefront of `[R]`-shaped ray state, and the samples are averaged as the
running mean `acc + (c - acc) / (i + 1)`. The JAX bounce loop is a
`fori_loop`; here it is a Python loop, so `bounce` is a plain int. Each
bounce is `trace_bounce_fused`:

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
Only `fused_shading=True, compact=False` on untextured scenes is ported so
far; other configurations raise `NotImplementedError` naming the ROADMAP
item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..core import camera as cam_mod, rng
from ..models import bsdf, shading
from ..models.shade_core import CoreCfg
from ..ops import traverse
from ..ops.cuda import shade as cshade
from ..scene.types import DeviceScene


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The same fields and defaults as the JAX package's RenderConfig."""

    depth: int = 5  # Demo default max bounces (Demo/main.cpp:209)
    spp: int = 100  # Demo default samples (Demo/main.cpp:210)
    ray_chunk: int = 8192  # unused by the full-bounce path
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
    if not cfg.fused_shading:
        raise NotImplementedError("the unfused trace_bounce is not ported yet (ROADMAP M5)")
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
    wavefront -> `[S, R, 3]`."""
    check_supported(scene, cfg)
    tables = BounceTables.of(scene) if tables is None else tables
    state, keys = camera_wavefront(camera, pixel_ids, key, sample_ids, cfg)
    for b in range(cfg.depth):
        state = trace_bounce_fused(state, scene, keys, b, cfg, tables)
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
    tables = BounceTables.of(scene)
    pixel_ids = torch.arange(w * h, device=scene.device)
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
    for i in range(cfg.spp // bsz):
        cs = _render_samples(scene, camera, pixel_ids, key,
                             range(i * bsz, (i + 1) * bsz), cfg, tables)
        acc = acc + (cs.mean(0) - acc) / (i + 1.0)
    return acc.reshape(h, w, 3)
