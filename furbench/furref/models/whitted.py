# Frozen copy of ba_pathtracing_fur_torch/models/whitted.py at commit 7595e93 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), with the
# Whitted fur shader's closed-form lobes (models/fur.py: hair_tangent,
# marschner_closed_form), the light's distance attenuation (models/shading.py) and the
# untextured material gather (models/bsdf.py: gather_materials) of the same commit, cut to
# the deterministic render with hard shadows on a grid of supersamples; the reference's
# own scene search (ops/traverse.py) in the kernels' place. Left out: soft shadows, depth
# of field, adaptive and Poisson supersampling, textures, the spans and the gradient
# path; `check_config` refuses a config that needs them.
"""The benchmark's plain reference of the Whitted fur raytracer.

Counterpart of the JAX package's `models/whitted.py` (KIRK's
SimpleCPURaytracer, Simple_CPU_Raytracer.cpp) as the port computes it: the
binary recursion tree trace -> shade -> {refraction, reflection} walked as a
lock-step per-ray depth-first loop (each ray its current node and a stack of
deferred reflection siblings, one a level), at most 2^(depth+1) iterations,
each iteration tracing and shading one wavefront of current nodes; hard
shadow rays to each light from every surface node; the Marschner closed-form
R, TT and TRT lobes with the TT second wall and the TRT re-hit traced through
the scene from 1e-4 inside the fiber.

The reference's quirks stay, for parity:

  * `hair_lobes="r"` sums the R lobe only (:755); "all" adds TT and TRT;
  * the Minweight gate's scalar weight multiplies the reflection child's
    colour a second time (:107, 228);
  * the Schlick term uses a hardcoded ior of 1.56 (:543);
  * the hair alpha is given in degrees and used as radians;
  * the nodes trace with t_max = inf, so a live ray that misses everything
    is a hit on triangle row 0 at t = 3.4e38 (INF < inf): it is shaded as a
    surface at o + 3.4e38 d and fires a hard shadow ray to each light from
    there. Those rays are traced like any other. What they answer follows
    from the leaf tests (`ops/bvh._tri_core`, `_cone_core`, the JAX
    package's arithmetic): toward the sun the direction is 0 (the 1e16 of
    the sun's target is lost in rounding at a point near 3.4e38), so a triangle's
    determinant is 0 and a cone's quadratic has a = b = 0, a NaN or infinite
    constant term, or roots at -/+1e6, never inside (1e-4, 1); toward the
    quad light the direction is of the point's size, so the products of the
    tests overflow to infinities and NaNs that no bound test accepts. No
    primitive blocks them, and the search answers so without special cases
    (its box test passes them to the leaf tests or drops groups the leaf
    tests reject). Their answer never reaches the colour either: the quad's
    attenuation is NaN at an infinite distance (unlit), the sun's direction
    is 0 (a zero term).

Departures from the JAX package, each leaving every pixel's colour as the
port computes it:

  * the scene search is the reference's own (`ops/traverse.py`: morton
    groups of 256 primitives, every group a ray enters tested near to far),
    not a BVH and not a kernel; the Hit is the frozen assembly of the port's;
  * the DFS is a Python loop with one host sync an iteration, as in the port
    (a `lax.while_loop` in the JAX package);
  * the TT and TRT traces give the lanes that are not hair t_max = 0, as the
    port does (the JAX package traces every lane and masks the result);
  * `render_pixels` traces any set of pixels, so that a check renders a
    sample of the image in blocks: a ray's colour depends on no other ray;
  * `RefConfig.round_to` rounds each node's Hit and colour to a lower
    precision (the check's control); `drop_lobe` leaves a hair lobe out of
    the sum and `scale` multiplies the colour (the check's planted faults).

Float32 throughout; no matmul runs here, and TF32 is off while a render
runs all the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core import camera as cam_mod, vecmath as vm
from ..core.sampling import dielectric_fresnel, normal_gauss_pdf
from ..ops import traverse
from ..scene.types import LIGHT_SUN, SHADER_MARSCHNER_HAIR, DeviceScene
from . import shading
from .bsdf import material_index
from .fur import _EPS, _bravais, _clip1, _safe_div
from .shade_core import CoreMat as MatParams

MINWEIGHT = 0.01  # CVK_Defs.h:67
RAY_EPS = 1e-4  # Ray.h:9
_NODE = ("o", "d", "W", "w", "lvl")
#: the render fields the reference takes: the port's WhittedConfig's
RENDER_FIELDS = ("depth", "supersamples", "hair_lobes", "shadows", "reflections",
                 "refractions", "soft_shadows", "shadow_samples", "dof", "dof_samples",
                 "aa", "adaptive", "adaptive_threshold", "adaptive_depth", "ray_chunk")


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The port's WhittedConfig fields the reference renders, with their
    defaults, and the reference's own knobs."""

    depth: int = 8  # the reference default (CPU_Raytracer.h:75)
    supersamples: int = 1
    hair_lobes: str = "r"
    shadows: bool = True
    reflections: bool = True
    refractions: bool = True
    soft_shadows: bool = False  # refused
    dof: bool = False  # refused
    aa: str = "grid"
    adaptive: bool = False  # refused
    # the reference's own: each node's Hit and colour rounded to this dtype
    # and back (the lower-precision control), None for float32
    round_to: Optional[torch.dtype] = None
    # planted faults: a lobe ("r", "tt" or "trt") left out of the hair sum;
    # every colour multiplied
    drop_lobe: Optional[str] = None
    scale: float = 1.0

    @classmethod
    def of(cls, render: dict, **own) -> "RefConfig":
        """From a configuration's `render` (the port's WhittedConfig keys)."""
        unknown = set(render) - set(RENDER_FIELDS)
        if unknown:
            raise ValueError(f"not WhittedConfig fields: {sorted(unknown)}")
        keep = {f.name for f in dataclasses.fields(cls)}
        return cls(**{**{k: v for k, v in render.items() if k in keep}, **own})


def check_config(cfg: RefConfig) -> None:
    """Refuse what the reference leaves out."""
    if cfg.soft_shadows or cfg.dof or (cfg.adaptive and cfg.supersamples == 1) or (
            cfg.aa != "grid" and cfg.supersamples > 1):
        raise ValueError("the reference renders hard shadows on a grid of supersamples, "
                         "without depth of field or adaptive sampling")


def _round(x: torch.Tensor, cfg: RefConfig) -> torch.Tensor:
    if cfg.round_to is None or not x.is_floating_point():
        return x
    return x.to(cfg.round_to).float()


def _w3(m: torch.Tensor, a, b):
    return torch.where(m[:, None], a, b)


def _bc(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


# ---------------------------------------------------------------------------
# Frozen from the port's models/bsdf.py, models/shading.py and models/fur.py
# ---------------------------------------------------------------------------

def gather_materials(materials, mat_id: torch.Tensor) -> MatParams:
    """The material row of each ray's hit (untextured)."""
    idx = material_index(mat_id, materials.count)
    return MatParams(**{f: getattr(materials, f)[idx] for f in (
        "diffuse", "specular", "volume", "emission", "ior", "transparency", "reflectivity",
        "roughness", "bsdf_id", "shader_id", "hair_alpha", "hair_beta")})


def distance_attenuation(lights, idx, dist):
    """Light.h:72: 1/(c + l d + q d^2) only when c > 0 or (l > 0 and q > 0)."""
    c = lights.const_att[idx]
    lin = lights.lin_att[idx]
    q = lights.quad_att[idx]
    use = (c > 0.0) | ((lin > 0.0) & (q > 0.0))
    denom = torch.clamp(c + lin * dist + q * dist * dist, min=1e-12)
    return torch.where(use, 1.0 / denom, 1.0)


def hair_tangent(normal: torch.Tensor) -> torch.Tensor:
    """The longer of n x z and n x y, normalized (:470-472)."""
    c1 = vm.cross(normal, torch.tensor([0.0, 0.0, 1.0], device=normal.device))
    c2 = vm.cross(normal, torch.tensor([0.0, 1.0, 0.0], device=normal.device))
    use1 = vm.length(c1) > vm.length(c2)
    return vm.normalize(torch.where(use1[..., None], c1, c2))


def marschner_closed_form(mp, ray_dir, normal, fiber_axis, t_normal, tr_normal):
    """Single-pass R, TT and TRT lobes (:451-746) -> (scat_r, scat_tt,
    scat_trt), each [R,3]."""
    nin = vm.normalize(ray_dir)
    tangent = hair_tangent(normal)
    alpha, beta, ior = mp.hair_alpha, mp.hair_beta, mp.ior

    sin_theta_i = vm.dot(nin, tangent)
    theta_i = torch.asin(_clip1(sin_theta_i))
    in_plane = vm.normalize(nin - sin_theta_i[:, None] * tangent)
    nf = vm.faceforward(normal, -nin, normal)

    def lobe_angles(out_ray):
        outn = vm.normalize(out_ray)
        sin_tr = vm.dot(outn, tangent)
        theta_r = torch.asin(_clip1(sin_tr))
        out_plane = vm.normalize(outn - sin_tr[:, None] * tangent)
        return theta_r, torch.acos(_clip1(vm.dot(out_plane, in_plane)))

    def cos2(x):
        return torch.clamp(torch.cos(x) ** 2, min=_EPS)

    # R lobe (:506-563)
    out_r = vm.rotate_about_axis(vm.reflect(-nin, nf), fiber_axis, -alpha)
    theta_r, phi = lobe_angles(out_r)
    theta_h = 0.5 * (theta_r + theta_i)
    theta_d = 0.5 * (theta_r - theta_i)
    m_r = normal_gauss_pdf(theta_h - torch.deg2rad(alpha), 0.0, beta)
    h_r = torch.sin(phi) * -0.5
    gamma_r = torch.asin(_clip1(h_r))
    dh_dphi_r = _safe_div(-2.0, torch.sqrt(torch.clamp(1.0 - h_r * h_r, min=_EPS))).abs()
    b1, b2 = _bravais(ior, gamma_r)
    fr = dielectric_fresnel(torch.cos(gamma_r), b1, b2)
    fr = torch.where(fr == 1.0, 0.0, fr)  # the fresnel == 1 -> 0 hack (:551)
    n_r = 0.5 * fr * dh_dphi_r
    scat_r = (m_r * n_r / cos2(theta_d))[:, None] * torch.ones_like(nin)

    # TT lobe (:570-646)
    t_dir = vm.refract(-nin, nf, 1.0 / ior)
    t_nf = vm.faceforward(t_normal, -vm.normalize(t_dir), t_normal)
    out_tt = vm.refract(-vm.normalize(t_dir), t_nf, 1.0)
    out_tt = vm.rotate_about_axis(out_tt, fiber_axis, alpha / 2.0)
    theta_r_tt, phi_tt = lobe_angles(out_tt)
    theta_h_tt = 0.5 * (theta_r_tt + theta_i)
    theta_d_tt = 0.5 * (theta_r_tt - theta_i)
    m_tt = normal_gauss_pdf(theta_h_tt - torch.deg2rad(-alpha / 2.0), 0.0, beta / 2.0)
    a_inv = 1.0 / ior
    nenner = torch.sqrt(torch.clamp(
        1.0 + a_inv ** 2 - 2.0 * a_inv * torch.sign(phi_tt) * torch.sin(phi_tt / 2.0),
        min=_EPS))
    h_tt = torch.sign(phi_tt) * torch.cos(phi_tt / 2.0) / nenner
    gamma_tt = torch.asin(_clip1(h_tt))
    b1t, b2t = _bravais(ior, gamma_tt)
    c_tt = torch.asin(_clip1(1.0 / b1t))
    pi = math.pi
    denom_tt = _safe_div(1.0, torch.sqrt(torch.clamp(1.0 - h_tt * h_tt, min=_EPS))) * (
        -(24.0 * c_tt / pi ** 3) * gamma_tt ** 2 + (6.0 * c_tt / pi - 2.0))
    dh_dphi_tt = _safe_div(1.0, denom_tt.abs())
    f_tt = dielectric_fresnel(torch.cos(gamma_tt), b1t, b2t)
    f_tt = torch.where(f_tt == 1.0, 0.0, f_tt)
    cos_gamma_t = 2.0 * torch.cos(torch.asin(_clip1(h_tt / b1t)))
    sigma = mp.diffuse / torch.clamp(torch.cos(theta_r_tt), min=_EPS)[:, None]
    att_tt = ((1.0 - f_tt) ** 2)[:, None] * torch.exp(sigma * cos_gamma_t[:, None])
    n_tt = 0.5 * att_tt * dh_dphi_tt[:, None]
    scat_tt = m_tt[:, None] * n_tt / cos2(theta_d_tt)[:, None]

    # TRT lobe (:654-745)
    tr_dir = vm.reflect(-vm.normalize(t_dir), t_nf)
    tr_nf = vm.faceforward(tr_normal, -vm.normalize(tr_dir), tr_normal)
    out_trt = vm.refract(-vm.normalize(tr_dir), tr_nf, _clip1(ior))
    out_trt = vm.rotate_about_axis(out_trt, fiber_axis, 3.0 * alpha / 2.0)
    theta_r_trt, phi_trt = lobe_angles(out_trt)
    theta_h_trt = 0.5 * (theta_r_trt + theta_i)
    theta_d_trt = 0.5 * (theta_r_trt - theta_i)
    m_trt = normal_gauss_pdf(theta_h_trt - torch.deg2rad(-3.0 * alpha / 2.0), 0.0,
                             2.0 * beta)
    gamma_trt = vm.angle_between(nin, vm.normalize(normal))
    h_trt = torch.sin(gamma_trt)
    b1r, b2r = _bravais(ior, gamma_trt)
    c_trt = torch.asin(_clip1(1.0 / b1r))
    denom_trt = _safe_div(1.0, torch.sqrt(torch.clamp(1.0 - h_trt * h_trt, min=_EPS))) * (
        -(48.0 * c_trt / pi ** 3) * gamma_trt ** 2 + (12.0 * c_trt / pi - 2.0))
    dh_dphi_trt = _safe_div(1.0, denom_trt.abs())
    f_trt = dielectric_fresnel(torch.cos(gamma_trt), b1r, b2r)
    f_trt = torch.where(f_trt == 1.0, 0.0, f_trt)
    cos_gamma_t2 = torch.cos(torch.asin(_clip1(h_trt / b1r)))
    f_exit = dielectric_fresnel(cos_gamma_t2, 1.0 / b1r, 1.0 / b2r)
    sigma2 = mp.diffuse / torch.clamp(torch.cos(theta_r_trt), min=_EPS)[:, None]
    att_trt = ((1.0 - f_trt) ** 2 * f_exit)[:, None] * \
        torch.exp(sigma2 * (-2.0 * cos_gamma_t2)[:, None]) ** 2
    n_trt = 0.5 * att_trt * dh_dphi_trt[:, None]
    scat_trt = m_trt[:, None] * n_trt / cos2(theta_d_trt)[:, None]

    def finite(x):
        return torch.where(torch.isfinite(x), x, 0.0)

    return finite(scat_r), finite(scat_tt), finite(scat_trt)


# ---------------------------------------------------------------------------
# Frozen from the port's models/whitted.py
# ---------------------------------------------------------------------------

def _norm_view_flip(norm, view):
    """The normal flipped toward the viewer (:97-103, :371-376)."""
    m_dot = vm.dot(norm, view)
    flipped = -vm.normalize(m_dot[:, None] * norm)
    return _w3(m_dot.abs() >= 1e-5, flipped, norm)


def _light_target(lights, i: int, pos):
    """calcLightdir(randomize=False) for light i: a point, spot or quad
    light aims at its position, a sun at pos - direction * 1e16."""
    sun_target = pos - lights.direction[i][None] * 1e16
    return torch.where(lights.kind[i] == LIGHT_SUN, sun_target,
                       lights.position[i].expand_as(pos))


def light_shading(scene: DeviceScene, pos, norm, view, mp, diff_color, cfg: RefConfig,
                  active):
    """lightShading (:80-180): ambient plus every light's Phong diffuse and
    specular behind a hard shadow ray (bias 1e-2 along the view-flipped
    normal, the unnormalized direction to the light, t_max = 1); lanes not
    `active` fire t_max = 0 shadow rays."""
    lights = scene.lights
    r = pos.shape[0]
    color = scene.env.ambient * diff_color  # ambient (:88)
    norm_view = _norm_view_flip(norm, view)
    shininess = 1.0 / torch.clamp(mp.roughness, min=1e-3)
    shadow_t = torch.where(active, 1.0, 0.0)

    for i in range(lights.count):
        target = _light_target(lights, i, pos)
        ldir = target - pos
        n_ldir = vm.normalize(ldir)
        dist = vm.length(ldir)
        idx = torch.full((r,), i, dtype=torch.long, device=pos.device)
        att = distance_attenuation(lights, idx, dist)
        kind = lights.kind[i]
        laxis = lights.direction[i][None]
        dd = torch.clamp(vm.dot(-n_ldir, laxis), 0.0, 1.0)
        ang = torch.rad2deg(torch.acos(torch.clamp(vm.dot(-n_ldir, laxis), -1.0, 1.0)))
        inner, outer = lights.inner_angle[i], lights.outer_angle[i]
        delta = 1.0 - torch.clamp((ang - inner) / torch.clamp(outer - inner, min=1e-6),
                                  0.0, 1.0)
        delta2 = delta * delta
        att = torch.where(kind == 1, att * dd,  # a quad faces the point
                          torch.where(kind == 2, att * (delta2 * delta2), att))  # spot
        lit = (att > 0.0) & (vm.dot(norm_view, n_ldir) >= 0.0)
        n_ldir, att = _w3(lit, n_ldir, norm), torch.where(lit, att, 0.0)

        cos_phi = torch.clamp(vm.dot(norm, n_ldir), min=0.0)
        direct = cos_phi[:, None] * diff_color * lights.color[i] * att[:, None]
        refl = vm.reflect(n_ldir, norm)
        cos_psi = torch.clamp(vm.dot(refl, view), min=0.0) ** shininess
        direct = direct + (mp.reflectivity * cos_psi)[:, None] * mp.specular \
            * lights.color[i] * att[:, None]
        direct = _w3(lit, direct, 0.0)

        if cfg.shadows:
            origin = pos + 1e-2 * norm_view
            sdir = target - origin
            blocked = traverse.any_hit(origin, sdir, scene, shadow_t)
            direct = _w3(blocked, 0.0, direct)
        color = color + direct
    return color


def _hair_color(scene: DeviceScene, hit, view_n, mp, cfg: RefConfig, is_hair):
    """shadeMarschnerHair (:451-760): with hair_lobes="all" the TT second
    wall and the TRT first-wall re-hit traced from 1e-4 inside the fiber;
    the lanes that are not hair trace from the origin with t_max = 0."""
    nin, normal = view_n, hit.normal
    if cfg.hair_lobes == "all":
        t_max = torch.where(is_hair, traverse.INF, 0.0)

        def live(o):
            return _w3(is_hair, o, 0.0)

        nf = vm.faceforward(normal, -nin, normal)
        t_dir = vm.refract(-nin, nf, 1.0 / mp.ior)
        t_hit = traverse.closest_hit(live(hit.position + 1e-4 * t_dir), t_dir, scene,
                                     t_max=t_max, round_to=cfg.round_to)
        t_normal = _w3(t_hit.valid, t_hit.normal, normal)
        t_pos = _w3(t_hit.valid, t_hit.position, hit.position)
        t_nf = vm.faceforward(t_normal, -vm.normalize(t_dir), t_normal)
        tr_dir = vm.reflect(-vm.normalize(t_dir), t_nf)
        tr_hit = traverse.closest_hit(live(t_pos + 1e-4 * tr_dir), tr_dir, scene, t_max=t_max,
                                      round_to=cfg.round_to)
        tr_normal = _w3(tr_hit.valid, tr_hit.normal, normal)
    else:
        t_normal = tr_normal = normal
    lobes = dict(zip(("r", "tt", "trt"), marschner_closed_form(
        mp, nin, normal, hit.fiber_v, t_normal, tr_normal)))
    names = ("r", "tt", "trt") if cfg.hair_lobes == "all" else ("r",)  # R only (:755)
    total = None
    for name in names:
        if name != cfg.drop_lobe:
            total = lobes[name] if total is None else total + lobes[name]
    return torch.zeros_like(nin) if total is None else total


def _trace_shade(scene, o, d, W, w, level, live, cfg: RefConfig):
    """One wavefront of nodes -> (colour [R,3], refraction child, reflection
    child, spawn_t [R], spawn_r [R])."""
    live = live & (W > 0.0).any(-1)
    t_cap = torch.where(live, float("inf"), 0.0)  # dead lanes trace nothing
    hit = traverse.closest_hit(o, d, scene, t_max=t_cap, round_to=cfg.round_to)
    view = vm.normalize(d)

    miss = live & ~hit.valid  # the background (:77): no live lane reaches it
    color = _w3(miss, W * shading.environment_color(scene.env, d), 0.0)

    mp = gather_materials(scene.materials, hit.mat_id)
    is_hair = (mp.shader_id == SHADER_MARSCHNER_HAIR) & hit.valid & live
    is_surf = hit.valid & live & ~is_hair

    base = light_shading(scene, hit.position, hit.normal, view, mp, mp.diffuse, cfg,
                         active=is_surf)
    norm = hit.normal
    norm_view = _norm_view_flip(norm, view)
    angle = vm.angle_between(-view, norm_view)
    r_0 = ((1.0 - 1.56) / (1.0 + 1.56)) ** 2  # the hardcoded 1.56 (:543)
    r_theta = r_0 + (1.0 - r_0) * (1.0 - torch.cos(angle)) ** 5
    fresnel = torch.clamp(mp.reflectivity ** 2 - mp.transparency ** 2
                          + r_theta * mp.reflectivity, 0.0, 1.0)

    can_recurse = level < cfg.depth
    child_lvl = level + 1
    r = o.shape[0]
    zeros3 = torch.zeros((r, 3), dtype=torch.float32, device=o.device)
    zero_child = {"o": zeros3, "d": zeros3, "W": zeros3, "w": torch.zeros_like(w),
                  "lvl": child_lvl}
    t_child, r_child = dict(zero_child), dict(zero_child)
    spawn_t = spawn_r = torch.zeros((r,), dtype=torch.bool, device=o.device)

    if cfg.refractions:
        ft = mp.transparency * (1.0 - fresnel)
        spawn_t = is_surf & can_recurse & (ft * w > MINWEIGHT)
        eta = torch.where(hit.enter, 1.0 / mp.ior, mp.ior)
        tdir = vm.refract(view, _w3(hit.enter, norm, -norm), eta)
        tir = (tdir == 0.0).all(-1) | torch.isnan(tdir[:, 0])
        rdir = vm.normalize(vm.reflect(view, norm_view))  # TIR reflects (:230-232)
        cdir = _w3(tir, rdir, vm.normalize(_w3(tir, rdir, tdir)))
        corig = _w3(tir, hit.position + 1e-2 * norm_view, hit.position + RAY_EPS * cdir)
        child_w = W * mp.volume * mp.transparency[:, None]
        t_child = {"o": corig, "d": cdir, "W": _w3(spawn_t, child_w, 0.0),
                   "w": torch.where(spawn_t, ft, 0.0), "lvl": child_lvl}
        base = _w3(spawn_t, base * (1.0 - mp.transparency)[:, None], base)

    if cfg.reflections:
        spawn_r = is_surf & can_recurse & (fresnel * w > MINWEIGHT)
        rdir = vm.normalize(vm.reflect(view, norm_view))
        rorig = hit.position + 1e-2 * norm_view
        child_w = W * mp.specular * (fresnel * w)[:, None]  # the weight again (:107)
        r_child = {"o": rorig, "d": rdir, "W": _w3(spawn_r, child_w, 0.0),
                   "w": torch.where(spawn_r, fresnel * w, 0.0), "lvl": child_lvl}
        base = _w3(spawn_r, base * (1.0 - fresnel)[:, None], base)

    color = color + _w3(is_surf, W * base, 0.0)
    hair_c = _hair_color(scene, hit, view, mp, cfg, is_hair)
    color = color + _w3(is_hair, W * hair_c, 0.0)
    return _round(color, cfg), t_child, r_child, spawn_t, spawn_r


def _trace_queue(scene, o, d, cfg: RefConfig) -> torch.Tensor:
    """The lock-step per-ray DFS over the weighted recursion tree -> colour
    [R,3]: each iteration traces and shades every live ray's node; the
    refraction child becomes the next node, the reflection child is pushed
    when both spawned (or becomes the node alone), a ray without a child
    pops its stack; at most 2^(depth+1) iterations."""
    r = o.shape[0]
    depth, dcap = cfg.depth, max(cfg.depth, 1)
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    stack = {"o": torch.zeros((r, dcap, 3), **f32), "d": torch.zeros((r, dcap, 3), **f32),
             "W": torch.zeros((r, dcap, 3), **f32), "w": torch.zeros((r, dcap), **f32),
             "lvl": torch.zeros((r, dcap), dtype=torch.int32, device=dev)}
    cur = {"o": o, "d": d, "W": torch.ones((r, 3), **f32), "w": torch.ones((r,), **f32),
           "lvl": torch.zeros((r,), dtype=torch.int32, device=dev)}
    slot = torch.arange(dcap, dtype=torch.int32, device=dev)[None]
    rows = torch.arange(r, device=dev)
    color = torch.zeros((r, 3), **f32)
    live = torch.ones((r,), dtype=torch.bool, device=dev)
    sp = torch.zeros((r,), dtype=torch.int32, device=dev)
    it = 0
    while it < 2 ** (depth + 1) and bool(live.any()):
        c, t_child, r_child, spawn_t, spawn_r = _trace_shade(
            scene, cur["o"], cur["d"], cur["W"], cur["w"], cur["lvl"], live, cfg)
        color = color + c
        push = live & spawn_t & spawn_r
        mask = push[:, None] & (slot == sp[:, None])
        stack = {k: torch.where(_bc(mask, stack[k]), r_child[k][:, None], stack[k])
                 for k in _NODE}
        sp = sp + push.to(torch.int32)
        cont = live & (spawn_t | spawn_r)
        take_t = live & spawn_t
        child = {k: torch.where(_bc(take_t, t_child[k]), t_child[k], r_child[k])
                 for k in _NODE}
        pop = ~cont & (sp > 0)
        sp = sp - pop.to(torch.int32)
        top = torch.clamp(sp, max=dcap - 1).long()
        popped = {k: stack[k][rows, top] for k in _NODE}
        cur = {k: torch.where(_bc(cont, child[k]), child[k],
                              torch.where(_bc(pop, popped[k]), popped[k], cur[k]))
               for k in _NODE}
        live = cont | pop
        it += 1
    return color


def render_pixels(scene: DeviceScene, camera: cam_mod.Camera, pixel_ids: torch.Tensor,
                  cfg: RefConfig) -> torch.Tensor:
    """The colours of the image's pixels `pixel_ids` (row-major ids, y * W +
    x) -> [P, 3]: each pixel's supersamples on the grid, traced and summed in
    the port's order, as `render_whitted` gives them."""
    check_config(cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        w, _ = camera.resolution
        px = (pixel_ids % w).to(torch.float32)
        py = (pixel_ids // w).to(torch.float32)
        n_ss = max(1, cfg.supersamples)
        offsets = [((i + 0.5) / n_ss, (j + 0.5) / n_ss)
                   for j in range(n_ss) for i in range(n_ss)]
        image = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                            device=pixel_ids.device)
        for ox, oy in offsets:
            jit = torch.tensor([ox, oy], dtype=torch.float32,
                               device=pixel_ids.device).expand(px.shape[0], 2)
            o, d = cam_mod.rays_from_pixels(camera, px, py, jit)
            image = image + _trace_queue(scene, o, d, cfg) / len(offsets)
        return image * cfg.scale if cfg.scale != 1.0 else image
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
