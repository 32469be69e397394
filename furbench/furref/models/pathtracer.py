# Frozen copy of the parts of ba_pathtracing_fur_torch/models/pathtracer.py at
# commit 24f22d1 that a progressive sample of the fused path runs (the render
# config, the ray state, the camera wavefront and the general fused bounce
# `trace_bounce_fused`), with the shade kernel's plain version and the
# reference's own scene search in the kernels' place. Left out: the unfused
# bounce, textures, MIS, QMC jitter, BDPT, the joint shadow path, the Cornell
# full-bounce pass, remat and stream compaction (a permutation that leaves
# every sample as it is); `core_cfg` refuses a scene or config that needs them.
"""The benchmark's plain reference of a progressive sample."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..core import camera as cam_mod, rng
from ..models import shading
from ..models.shade_core import CoreCfg
from ..ops import shade_ref, traverse
from ..scene.types import BSDF_LAMBERT, BSDF_MARSCHNER_HAIR, DeviceScene


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The port's RenderConfig fields that the fused path reads, with their
    defaults; `compact` and `tonemap` change no sample."""

    depth: int = 5  # Demo default max bounces (Demo/main.cpp:209)
    spp: int = 100  # Demo default samples (Demo/main.cpp:210)
    hair_p_random: bool = False
    tonemap: bool = False
    mis: bool = False  # not in the reference: core_cfg refuses it
    rr: bool = False  # Russian roulette from `rr_start` bounces on
    rr_start: int = 2
    compact: bool = True
    clamp_throughput: float = 1e4
    fused_shading: bool = False  # the reference runs the fused path only
    # the reference's own: round every stage's floats to this dtype (the
    # lower-precision control), None to compute in float32
    round_to: Optional[torch.dtype] = None


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


def rounded(x, cfg: RenderConfig):
    """`x` (a tensor, a RayState or a dict of tensors) with its floats
    rounded to `cfg.round_to` and back; itself without it."""
    if cfg.round_to is None:
        return x
    if isinstance(x, torch.Tensor):
        return x.to(cfg.round_to).float() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: rounded(v, cfg) for k, v in x.items()}
    return dataclasses.replace(x, **{f.name: rounded(getattr(x, f.name), cfg)
                                     for f in dataclasses.fields(x)})


@dataclasses.dataclass
class BounceTables:
    mats: torch.Tensor
    lights: torch.Tensor

    @classmethod
    def of(cls, scene: DeviceScene) -> "BounceTables":
        return cls(mats=shade_ref.pack_mats_table(scene.materials),
                   lights=shade_ref.pack_lights_table(scene.lights))


#: the surface BSDFs the reference's shading has (shade_core.sample_surface)
SURFACE_BSDFS = {BSDF_LAMBERT, BSDF_MARSCHNER_HAIR}


def core_cfg(scene: DeviceScene, cfg: RenderConfig) -> CoreCfg:
    """The shading body's constants; refuses what the reference leaves out."""
    if not cfg.fused_shading or cfg.mis or not set(scene.bsdfs_present) <= SURFACE_BSDFS:
        raise ValueError("the reference renders the fused path of untextured Lambert and "
                         "hair surfaces without MIS")
    return CoreCfg(n_lights=scene.lights.count, rr=cfg.rr, has_hair=scene.has_hair,
                   hair_p_random=cfg.hair_p_random, clamp_throughput=cfg.clamp_throughput)


def shade_inputs(state: RayState, scene: DeviceScene, keys: torch.Tensor, bounce: int,
                 cfg: RenderConfig, hit, tables: BounceTables) -> dict:
    """The keyword arguments of `shade_bounce` for this bounce: the ray
    state, the hit with its material id, the material and light tables,
    the environment colour, and the per-sample keys with the bounce, from
    which the shade stage draws u_bsdf/u_pick/u_light/u_hairp (and u_rr
    when `cfg.rr`) with the tags 0-4 of the JAX package. No draw and no
    material gather happens here."""
    return dict(
        origin=state.origin, direction=state.direction, radiance=state.radiance,
        color=state.color, flags=state.flags, theta_i=state.theta_i, prev_pdf=state.prev_pdf,
        hit_t=hit.t, hit_valid=hit.valid, hit_pos=hit.position, hit_normal=hit.normal,
        fib_u=hit.fiber_u, fib_v=hit.fiber_v, fib_w=hit.fiber_w, mat_id=hit.mat_id,
        mats_table=tables.mats, keys=keys, bounce=bounce,
        env_color=shading.environment_color(scene.env, state.direction),
        env_ambient=scene.env.ambient, lights_table=tables.lights,
        n_lights=scene.lights.count, rr_gate=bounce >= cfg.rr_start, cfg=core_cfg(scene, cfg))


def _trace_cap(state: RayState) -> torch.Tensor:
    """t_max of the bounce's closest-hit rays: INF, 0 on dead lanes (they
    trace nothing)."""
    do_trace = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
    return torch.where(do_trace, traverse.INF, 0.0)


def _closest(state: RayState, scene: DeviceScene, n_alive, closest_fn, cfg: RenderConfig):
    if closest_fn is not None:
        return closest_fn(state.origin, state.direction, scene)
    return traverse.closest_hit(state.origin, state.direction, scene, t_max=_trace_cap(state),
                                n_alive=n_alive, round_to=cfg.round_to)


def _shade_stage(state: RayState, scene: DeviceScene, keys: torch.Tensor, bounce: int,
                 cfg: RenderConfig, hit, tables: BounceTables):
    """The post-traversal half of a general fused bounce (the JAX package's
    `_fused_shade_stage`): the shade kernel on the hit -> (the next ray
    state, its colour without the NEE term; the pending NEE term: its
    shadow rays `o`, `d`, `tmax` and its colour `direct`)."""
    out = shade_ref.shade_bounce_ref(**shade_inputs(state, scene, keys, bounce, cfg, hit, tables))
    nxt = RayState(origin=out["origin"], direction=out["direction"], radiance=out["radiance"],
                   color=out["color"], flags=out["flags"], theta_i=out["theta_i"],
                   prev_pdf=out["prev_pdf"])
    return nxt, dict(o=out["shadow_o"], d=out["shadow_d"], tmax=out["shadow_tmax"],
                     direct=out["direct_rgb"])


def _add_unblocked(state: RayState, pend: dict, blocked: torch.Tensor) -> RayState:
    return dataclasses.replace(
        state, color=state.color + torch.where(blocked[:, None], 0.0, pend["direct"]))


def trace_bounce_fused(state: RayState, scene: DeviceScene, keys: torch.Tensor,
                       bounce: int, cfg: RenderConfig, tables: BounceTables) -> RayState:
    """The general fused bounce (fur, BVHs): closest hit -> shade stage ->
    shadow any-hit -> NEE add."""
    hit = _closest(state, scene, None, None, cfg)
    state, pend = _shade_stage(state, scene, keys, bounce, cfg, hit, tables)
    state, pend = rounded(state, cfg), rounded(pend, cfg)
    if scene.lights.count:
        blocked = traverse.any_hit(pend["o"], pend["d"], scene, pend["tmax"])
        state = _add_unblocked(state, pend, blocked)
    return state


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
        jitter.append(rng.bounce_uniform(k, -1, 2, tag=7))
        if camera.use_dof:
            dof_u.append(rng.bounce_uniform(k, -1, 2, tag=8))
    keys = torch.cat(keys)
    px = (pixel_ids % w).to(torch.float32).repeat(len(sample_ids))
    py = (pixel_ids // w).to(torch.float32).repeat(len(sample_ids))
    o, d = cam_mod.rays_from_pixels(camera, px, py, torch.cat(jitter),
                                    torch.cat(dof_u) if dof_u else None)
    return init_state(o, d), keys


def render_samples(scene: DeviceScene, camera: cam_mod.Camera, pixel_ids: torch.Tensor,
                   key: torch.Tensor, sample_ids: Sequence[int], cfg: RenderConfig
                   ) -> torch.Tensor:
    """Samples `sample_ids` of the global `pixel_ids`, traced as one
    wavefront -> `[S, R, 3]` (the port's `_render_samples` on the fused
    path without compaction: `trace_bounce_fused` a bounce)."""
    core_cfg(scene, cfg)
    state, keys = camera_wavefront(camera, pixel_ids, key, sample_ids, cfg)
    state = rounded(state, cfg)
    tables = BounceTables.of(scene)
    for b in range(cfg.depth):
        state = trace_bounce_fused(state, scene, keys, b, cfg, tables)
    return state.color.reshape(len(sample_ids), pixel_ids.shape[0], 3)


