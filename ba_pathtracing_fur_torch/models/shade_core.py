"""Per-bounce shading body in plain torch: the twin of `csrc/shade_core.cuh`.

Counterpart of `ba_pathtracing_fur_tpu/models/shade_core.py::
shade_bounce_core`: after the scene traversal, one wavefront bounce does the
analytic light hits, env/light termination (with the MIS power weight), the
NEE light pick and sample (emitting a shadow ray and the unoccluded direct
term), the surface BSDF sample cascade, and the throughput, flag and ray
update. Same citations, epsilons and quirks as the reference:

  * ids outside `present` fall through to Lambert, and a grazing `wi`
    (dot(wi, n) == 0) zeroes the reflectance;
  * the light argmin is strict `<`, so the first light wins ties;
  * a quad light hit tests (v0,v1,v3) then (v2,v3,v1), the second
    overwriting the first.

Vectors are `[R, 3]` tensors and scalars `[R]`. Lights are consumed one by
one in a Python loop over `CoreLight`s whose kind is a Python int, so only
the branch of each light's kind is evaluated. Native `torch.acos`/`asin`/
`atan2` replace the Cephes forms the TPU lowering needed. With
`CoreCfg.has_hair`, materials of the hair shader take the Marschner/d'Eon
walk automaton (`sample_hair`, the `_marschner3`/`_deon3` twins).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import vecmath as vm
from ..ops.intersect import tri_t
from ..core.sampling import (
    cosine_sample_hemisphere, dielectric_fresnel, normal_gauss_pdf, sample_angle,
    uniform_sphere_sample,
)
from ..scene.types import (
    BSDF_EMISSION, BSDF_GLASS, BSDF_GLOSSY, BSDF_LAMBERT, BSDF_LAMBERT_TRANSMISSION,
    BSDF_MARSCHNER_HAIR, BSDF_DEON_HAIR, BSDF_MILK_GLASS, BSDF_SPECULAR_REFLECTION,
    BSDF_SPECULAR_TRANSMISSION, BSDF_TRANSPARENT, LIGHT_POINT, LIGHT_QUAD, LIGHT_SPOT,
    LIGHT_SUN, MATFLAG_CYLINDER_T_BOUNCE, MATFLAG_CYLINDER_TR_BOUNCE,
    MATFLAG_EMISSIVE_BOUNCE, MATFLAG_SPECULAR_BOUNCE, MATFLAG_TRANSPARENT_BOUNCE,
    SHADER_MARSCHNER_HAIR,
)
from .fur import _EPS as _HAIR_EPS, _bravais, _clip1, _safe_div, bessel_j0

EPS = 1e-7  # vm.EPS
INF = 3.4e38
TRI_EPS = 1.1920929e-7
INV_PI = 1.0 / math.pi
_DELTA_EPS = 1e-3


@dataclasses.dataclass
class CoreMat:
    """Per-ray material (MatParams): vectors `[R, 3]`, scalars `[R]`."""

    diffuse: torch.Tensor
    specular: torch.Tensor
    volume: torch.Tensor
    emission: torch.Tensor
    ior: torch.Tensor
    transparency: torch.Tensor
    reflectivity: torch.Tensor
    roughness: torch.Tensor
    bsdf_id: torch.Tensor  # int32
    shader_id: torch.Tensor  # int32
    hair_alpha: torch.Tensor
    hair_beta: torch.Tensor


@dataclasses.dataclass
class CoreLight:
    """One light: kind and scalars as Python values, vectors as `[3]` tensors."""

    kind: int
    color: torch.Tensor
    position: torch.Tensor
    direction: torch.Tensor
    radius: float
    const_att: float
    lin_att: float
    quad_att: float
    v0: torch.Tensor  # quad corners
    v1: torch.Tensor
    v2: torch.Tensor
    v3: torch.Tensor
    inner_angle: float
    outer_angle: float
    area: float  # bilinear-patch quad area (MIS)
    has_color: bool  # any colour channel > 0

    @property
    def area_like(self) -> bool:
        return self.kind in (LIGHT_QUAD, LIGHT_POINT)


@dataclasses.dataclass(frozen=True)
class CoreCfg:
    """Per-render constants of the shading body."""

    n_lights: int
    mis: bool = False
    rr: bool = False
    has_hair: bool = False
    hair_p_random: bool = False  # the walk's first step drawn from u_hairp
    clamp_throughput: float = 1e4
    bsdfs_present: tuple = ()


@dataclasses.dataclass
class CoreOut:
    origin: torch.Tensor
    direction: torch.Tensor
    radiance: torch.Tensor
    color: torch.Tensor  # without the direct term: add direct_rgb after occlusion
    flags: torch.Tensor
    theta_i: torch.Tensor
    prev_pdf: torch.Tensor
    shadow_o: torch.Tensor
    shadow_d: torch.Tensor  # normalized
    shadow_tmax: torch.Tensor  # 0 on rays with no shadow ray
    direct_rgb: torch.Tensor  # unoccluded NEE term x throughput x masks


def _w3(m: torch.Tensor, a, b):
    """torch.where for `[R, 3]` values under an `[R]` mask."""
    return torch.where(m[..., None], a, b)


# ---------------------------------------------------------------------------
# Light math
# ---------------------------------------------------------------------------

def _distance_attenuation(li: CoreLight, dist: torch.Tensor):
    if li.const_att > 0.0 or (li.lin_att > 0.0 and li.quad_att > 0.0):
        return 1.0 / torch.clamp(li.const_att + li.lin_att * dist
                                 + li.quad_att * dist * dist, min=1e-12)
    return torch.ones_like(dist)


def light_hit(o, d, li: CoreLight):
    """One light's analytic intersection -> (t, ok); t = INF where not ok."""
    if li.kind == LIGHT_POINT:
        # sphere: chosen root -0.5*(b+sqrt)/a, facing precondition
        oc = o - li.position
        a = vm.dot(d, d)
        b = 2.0 * vm.dot(d, oc)
        c = (vm.dot(li.position, li.position) + vm.dot(o, o)
             - 2.0 * vm.dot(o, li.position) - li.radius * li.radius)
        disc = b * b - 4.0 * a * c
        ok = (li.radius * li.radius > 0.0) & ~(vm.dot(d, oc) > 0.0) & (disc >= 0.0)
        sq = torch.sqrt(torch.clamp(disc, min=1e-12))
        t = -0.5 * (b + sq) / torch.where(a.abs() < 1e-12, 1e-12, a)
    elif li.kind == LIGHT_QUAD:
        # (v0,v1,v3) then (v2,v3,v1); the second overwrites
        t1, ok1 = tri_t(o, d, li.v0, li.v1, li.v3)
        t2, ok2 = tri_t(o, d, li.v2, li.v3, li.v1)
        t = torch.where(ok2, t2, t1)
        ok = ok1 | ok2
    elif li.kind == LIGHT_SPOT:
        # disk about position, perpendicular to direction
        s_ax, t_ax = vm.orthonormal_basis(li.direction)
        p = vm.cross(d, t_ax)
        det = vm.dot(s_ax, p)
        okd = det.abs() > TRI_EPS
        inv_det = 1.0 / torch.where(okd, det, 1.0)
        tv = o - li.position
        uu = vm.dot(tv, p) * inv_det
        q = vm.cross(tv, s_ax)
        vv = vm.dot(d, q) * inv_det
        t = vm.dot(t_ax, q) * inv_det
        ok = okd & (uu * uu + vv * vv <= li.radius * li.radius) & (t > TRI_EPS) & (li.radius > 0.0)
    else:  # sun: never hit
        t = torch.full_like(o[..., 0], INF)
        ok = torch.zeros_like(t, dtype=torch.bool)
    return torch.where(ok, t, INF), ok


def light_emitted(li: CoreLight, ray_dir):
    """Radiance seen on hitting the light (sampleLightSource per kind)."""
    cdiv = li.const_att if li.const_att > 0.0 else 1.0
    if li.kind == LIGHT_POINT:
        return (li.color * (INV_PI / cdiv)).expand_as(ray_dir)
    if li.kind == LIGHT_SUN:
        return li.color.expand_as(ray_dir)
    facing = vm.dot(vm.normalize(-ray_dir), li.direction) >= 0.0
    return _w3(facing, li.color, 0.0) * (INV_PI / cdiv)


def light_sample_dir(li: CoreLight, pos, u1, u2):
    """A point on the light seen from `pos` -> (target [R,3], attenuation [R])."""
    if li.kind == LIGHT_POINT:
        sphere_pt = uniform_sphere_sample(u1, u2)
        target = li.position + sphere_pt * li.radius
        dir0 = vm.normalize(li.position - pos)
        dd = torch.clamp(vm.dot(sphere_pt, -dir0), 0.0, 1.0)
        return target, dd * _distance_attenuation(li, vm.length(target - pos))
    if li.kind == LIGHT_QUAD:
        x1 = li.v0 + (li.v1 - li.v0) * u1[..., None]
        x2 = li.v3 + (li.v2 - li.v3) * u1[..., None]
        target = x1 + (x2 - x1) * u2[..., None]
        q_dir = target - pos
        dd = torch.clamp(vm.dot(vm.normalize(-q_dir), li.direction), 0.0, 1.0)
        return target, dd * _distance_attenuation(li, vm.length(q_dir))
    if li.kind == LIGHT_SPOT:
        # disk offset + quartic angular falloff
        r = torch.sqrt(u1) * li.radius
        theta = 2.0 * math.pi * u2
        s_ax, t_ax = vm.orthonormal_basis(li.direction)
        target = (li.position + s_ax * (r * torch.cos(theta))[..., None]
                  + t_ax * (r * torch.sin(theta))[..., None])
        s_dir = target - pos
        ang = torch.rad2deg(torch.acos(torch.clamp(
            vm.dot(vm.normalize(-s_dir), li.direction), -1.0 + 1e-7, 1.0 - 1e-7)))
        delta = 1.0 - torch.clamp((ang - li.inner_angle)
                                  / max(li.outer_angle - li.inner_angle, 1e-6), 0.0, 1.0)
        return target, delta ** 4 * _distance_attenuation(li, vm.length(s_dir))
    # sun at 1e16
    sun_pt = uniform_sphere_sample(u1, u2) * li.radius - li.direction
    return vm.normalize(sun_pt) * 1e16, torch.ones_like(u1)


def light_solid_angle_pdf(li: CoreLight, n_lights: int, direction, dist):
    """Solid-angle pdf of sampling this light, with the uniform 1/N pick."""
    if li.kind == LIGHT_QUAD:
        cos_l = vm.dot(vm.normalize(direction), li.direction).abs()
        p = dist * dist / (max(li.area, 1e-12) * torch.clamp(cos_l, min=1e-4))
    elif li.kind == LIGHT_POINT:
        r = max(li.radius, 1e-6)
        p = dist * dist / (math.pi * r * r)
    else:
        p = torch.zeros_like(dist)
    return p / n_lights


def power_heuristic(pf, pg):
    pf2 = pf * pf
    return pf2 / torch.clamp(pf2 + pg * pg, min=1e-20)


# ---------------------------------------------------------------------------
# Surface BSDFs (models/bsdf.py twins) -> (refl [R,3], wo [R,3], pdf, flags)
# ---------------------------------------------------------------------------

def _abs_dot_safe(a, b):
    return torch.clamp(vm.dot(a, b).abs(), min=EPS)


def _eta(mp, wi, n):
    entering = vm.dot(wi, n) > 0.0
    return torch.where(entering, 1.0, mp.ior), torch.where(entering, mp.ior, 1.0)


def _b_lambert(mp, wi, n, u1, u2, flags):
    sgn = torch.where(vm.dot(wi, n) > 0.0, 1.0, -1.0)[..., None]
    wo = vm.local_to_world_normal(cosine_sample_hemisphere(u1, u2) * sgn, n)
    pdf = vm.dot(wo, n).abs() / math.pi
    refl = _w3(pdf == 0.0, 0.0, mp.diffuse * INV_PI)
    return refl, wo, pdf, torch.zeros_like(flags)


def _b_specular_reflection(mp, wi, n, u1, u2, flags):
    wo = vm.reflect(-wi, vm.faceforward(n, -wi, n))
    refl = mp.specular * (1.0 / _abs_dot_safe(wo, n))[..., None]
    return refl, wo, torch.ones_like(u1), flags | MATFLAG_SPECULAR_BOUNCE


def _b_specular_transmission(mp, wi, n, u1, u2, flags):
    eta_i, eta_t = _eta(mp, wi, n)
    fresnel = dielectric_fresnel(vm.dot(wi, n).abs(), eta_i, eta_t)
    wo = vm.refract(vm.normalize(-wi), vm.faceforward(n, -wi, n), eta_i / eta_t)
    refracted = vm.dot(wo, wo) > 0.0
    ft = mp.volume * ((1.0 - fresnel) * (eta_i * eta_i) / (eta_t * eta_t))[..., None]
    refl = _w3(refracted, ft * (1.0 / _abs_dot_safe(wo, n))[..., None], 0.0)
    spec = flags | MATFLAG_SPECULAR_BOUNCE
    return refl, wo, torch.ones_like(u1), torch.where(
        refracted, spec | MATFLAG_TRANSPARENT_BOUNCE, spec)


def _glossy_lobe(u1, u2, roughness, axis, nf, flip_when_below: bool):
    """A cone sample about `axis`, mirrored about the axis when it lands on
    the wrong side of `nf` (below for reflection, above for transmission)."""
    rad = torch.deg2rad(180.0 - (1.0 - roughness) * 180.0)
    s = sample_angle(u1, u2, rad)
    wo = vm.local_to_world_normal(s, axis)
    side = vm.dot(wo, nf)
    flip = side < 0.0 if flip_when_below else side > 0.0
    mirrored = torch.stack([-s[..., 0], -s[..., 1], s[..., 2]], dim=-1)
    return _w3(flip, vm.local_to_world_normal(mirrored, axis), wo)


def _b_glossy(mp, wi, n, u1, u2, flags):
    nf = vm.faceforward(n, -wi, n)
    wo = _glossy_lobe(u1, u2, mp.roughness, vm.reflect(-wi, nf), nf, True)
    refl = mp.specular * (1.0 / _abs_dot_safe(wo, n))[..., None]
    return refl, wo, torch.ones_like(u1), flags | MATFLAG_SPECULAR_BOUNCE


def _dielectric_choice(mp, wi, n, u2):
    win = vm.normalize(wi)
    eta_i, eta_t = _eta(mp, wi, n)
    fresnel = dielectric_fresnel(vm.dot(win, n).abs(), eta_i, eta_t)
    nf = vm.faceforward(n, -win, n)
    refr = vm.refract(-win, nf, eta_i / eta_t)
    choose_t = (vm.dot(refr, refr) > 0.0) & (u2 > fresnel)
    ft = mp.volume * ((1.0 - fresnel) * (eta_i * eta_i) / (eta_t * eta_t))[..., None]
    return win, fresnel, nf, refr, choose_t, ft


def _dielectric_out(choose_t, wo_t, refl_t, wo_r, refl_r, fresnel, flags):
    spec = flags | MATFLAG_SPECULAR_BOUNCE
    return (_w3(choose_t, refl_t, refl_r), _w3(choose_t, wo_t, wo_r),
            torch.where(choose_t, 1.0 - fresnel, fresnel),
            torch.where(choose_t, spec | MATFLAG_TRANSPARENT_BOUNCE, spec))


def _b_glass(mp, wi, n, u1, u2, flags):
    win, fresnel, nf, refr, choose_t, ft = _dielectric_choice(mp, wi, n, u2)
    refl_t = ft * (1.0 / _abs_dot_safe(refr, n))[..., None]
    wo_r = vm.reflect(-win, nf)
    refl_r = mp.specular * (fresnel / _abs_dot_safe(wo_r, n))[..., None]
    return _dielectric_out(choose_t, refr, refl_t, wo_r, refl_r, fresnel, flags)


def _b_milk_glass(mp, wi, n, u1, u2, flags):
    win, fresnel, _, refr, choose_t, ft = _dielectric_choice(mp, wi, n, u2)
    nf_unnorm = vm.faceforward(n, -wi, n)
    wo_t = _glossy_lobe(u1, u2, mp.roughness, refr, nf_unnorm, False)
    refl_t = ft * (1.0 / _abs_dot_safe(wo_t, n))[..., None]
    wo_r = _glossy_lobe(u1, u2, mp.roughness, vm.reflect(-wi, nf_unnorm), nf_unnorm, True)
    refl_r = mp.specular * (fresnel / _abs_dot_safe(wo_r, n))[..., None]
    return _dielectric_out(choose_t, wo_t, refl_t, wo_r, refl_r, fresnel, flags)


def _b_lambert_transmission(mp, wi, n, u1, u2, flags):
    sgn = torch.where(vm.dot(wi, n) > 0.0, -1.0, 1.0)[..., None]
    wo = vm.local_to_world_normal(cosine_sample_hemisphere(u1, u2) * sgn, n)
    pdf = vm.dot(wo, n).abs() / math.pi
    refl = _w3(pdf == 0.0, 0.0, mp.volume * INV_PI)
    return refl, wo, pdf, torch.full_like(flags, MATFLAG_TRANSPARENT_BOUNCE)


def _b_emission(mp, wi, n, u1, u2, flags):
    return (torch.ones_like(wi), torch.zeros_like(wi), torch.ones_like(u1),
            torch.full_like(flags, MATFLAG_EMISSIVE_BOUNCE))


def _b_transparent(mp, wi, n, u1, u2, flags):
    wo = -wi
    refl = mp.volume * (1.0 / _abs_dot_safe(wo, n))[..., None]
    return refl, wo, torch.ones_like(u1), torch.full_like(
        flags, MATFLAG_TRANSPARENT_BOUNCE | MATFLAG_SPECULAR_BOUNCE)


_SURFACE = (
    (BSDF_SPECULAR_REFLECTION, _b_specular_reflection),
    (BSDF_SPECULAR_TRANSMISSION, _b_specular_transmission),
    (BSDF_GLOSSY, _b_glossy),
    (BSDF_GLASS, _b_glass),
    (BSDF_MILK_GLASS, _b_milk_glass),
    (BSDF_LAMBERT_TRANSMISSION, _b_lambert_transmission),
    (BSDF_EMISSION, _b_emission),
    (BSDF_TRANSPARENT, _b_transparent),
)


def sample_surface(mp: CoreMat, wi, n, u1, u2, flags, present: tuple = ()):
    """models/bsdf.sample_surface twin: Lambert unless the material's id is
    one of the (present) non-Lambert BSDFs; zero reflectance at grazing."""
    refl, wo, pdf, fl = _b_lambert(mp, wi, n, u1, u2, flags)
    for bid, fn in _SURFACE:
        if present and bid not in present:
            continue
        r_b, wo_b, pdf_b, fl_b = fn(mp, wi, n, u1, u2, flags)
        is_b = mp.bsdf_id == bid
        refl, wo = _w3(is_b, r_b, refl), _w3(is_b, wo_b, wo)
        pdf, fl = torch.where(is_b, pdf_b, pdf), torch.where(is_b, fl_b, fl)
    return _w3(vm.dot(wi, n) == 0.0, 0.0, refl), wo, pdf, fl


def evaluate_light(mp: CoreMat, n, wi_light, wo_view):
    """models/bsdf.evaluate_light twin."""
    same_side = (vm.dot(wi_light, n) * vm.dot(wo_view, n)) > 0.0
    lambert_like = (mp.bsdf_id == BSDF_LAMBERT) | (mp.bsdf_id == BSDF_MARSCHNER_HAIR)
    translucent = mp.bsdf_id == BSDF_LAMBERT_TRANSMISSION
    m = (lambert_like & same_side) | (translucent & ~same_side)
    return _w3(m, mp.diffuse * INV_PI, 0.0)


def is_delta(mp: CoreMat):
    bid = mp.bsdf_id
    smooth = (bid == BSDF_LAMBERT) | (bid == BSDF_LAMBERT_TRANSMISSION)
    glossy_wide = (bid == BSDF_GLOSSY) & (mp.roughness > _DELTA_EPS)
    return ~(smooth | glossy_wide)


def eval_pdf(mp: CoreMat, n, wi_view, wo):
    """models/bsdf.eval_pdf twin -> (f [R,3], pdf [R])."""
    bid = mp.bsdf_id
    won = vm.normalize(wo)
    cos_o = vm.dot(won, n)
    cos_i = vm.dot(vm.normalize(wi_view), n)
    same_side = (cos_o * cos_i) > 0.0
    abs_cos = torch.clamp(cos_o.abs(), min=EPS)

    f = torch.zeros_like(wo)
    pdf = torch.zeros_like(cos_o)

    m = (bid == BSDF_LAMBERT) & same_side
    f = _w3(m, mp.diffuse * INV_PI, f)
    pdf = torch.where(m, abs_cos / math.pi, pdf)

    m = (bid == BSDF_LAMBERT_TRANSMISSION) & ~same_side
    f = _w3(m, mp.volume * INV_PI, f)
    pdf = torch.where(m, abs_cos / math.pi, pdf)

    glos = (bid == BSDF_GLOSSY) & (mp.roughness > _DELTA_EPS)
    nf = vm.faceforward(n, -wi_view, n)
    reflected = vm.normalize(vm.reflect(vm.normalize(-wi_view), nf))
    cos_max = torch.cos(torch.deg2rad(mp.roughness * 180.0))
    inv_solid = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-6)
    m = glos & (vm.dot(won, reflected) >= cos_max) & same_side
    f = _w3(m, mp.specular * (inv_solid / abs_cos)[..., None], f)
    pdf = torch.where(m, inv_solid, pdf)

    hair = (bid == BSDF_MARSCHNER_HAIR) | (bid == BSDF_DEON_HAIR)
    f = _w3(hair & same_side, mp.diffuse * INV_PI, f)
    return f, pdf


def sample_pdf(mp: CoreMat, n, wi_view, wo):
    _, pdf = eval_pdf(mp, n, wi_view, wo)
    return torch.where(is_delta(mp), -1.0, torch.clamp(pdf, min=1e-8))


# ---------------------------------------------------------------------------
# Hair automaton (models/fur.py twins) -> (refl, wo, pdf, flags, theta_i)
# ---------------------------------------------------------------------------

def _to_cyl(x, fu, fv, fw):
    """World -> cylinder space; component 0 is along the fiber axis V."""
    return vm.dot(x, fv), vm.dot(x, fu), vm.dot(x, fw)


def _theta(c0, c1, c2):
    return torch.atan2(torch.sqrt(torch.clamp(c0 * c0 + c2 * c2, min=1e-20)), c1)


def _phi(c0, c1):
    degenerate = (c0.abs() < 1e-12) & (c1.abs() < 1e-12)
    return torch.atan2(c0, torch.where(degenerate, 1.0, c1))


def _deon_M(v, theta_i, theta_r, radians_quirk: bool):
    """d'Eon's longitudinal term with the reference's mixed radians()/
    degrees() quirk on the R lobe (Bsdf.cpp:993-995) and MSVC _j0."""
    v_safe = torch.clamp(v, min=_HAIR_EPS)
    if radians_quirk:
        x = torch.deg2rad(1.0 / v_safe)
        scale = torch.rad2deg(v_safe)
    else:
        x = 1.0 / v_safe
        scale = v_safe
    s = torch.sin(-theta_i) * torch.sin(theta_r) / scale
    x_pos = torch.clamp(x, min=_HAIR_EPS)
    log_m = (-x_pos - torch.log(torch.clamp(1.0 - torch.exp(-2.0 * x_pos), min=1e-30))
             - torch.log(v_safe) + s)
    bes = bessel_j0(torch.cos(-theta_i) * torch.cos(theta_r) / scale)
    return torch.exp(torch.clamp(log_m, max=80.0)) * bes


def _deon_detector(phi, stddev_deg):
    """d'Eon's azimuthal detector: a Gaussian wrapped over 21 periods."""
    acc = 0.0
    for k in range(-10, 11):
        acc = acc + normal_gauss_pdf(phi - 2.0 * math.pi * k, 0.0, stddev_deg)
    return acc


def _walk_select(flags, p_choice, first_r, enter, tt, tr, trt):
    """The automaton's state select over (refl, wo, pdf, flags, theta_i)
    tuples: R or the entry step on a first hit, then TT, TR or TRT by the
    walk bits of `flags`."""
    t_set = (flags & MATFLAG_CYLINDER_T_BOUNCE) != 0
    tr_set = (flags & MATFLAG_CYLINDER_TR_BOUNCE) != 0
    first = p_choice == 0
    out = [(_w3 if f.dim() == 2 else torch.where)(first, a, b)
           for f, a, b in zip(first_r, first_r, enter)]
    for m, lobe in ((tr_set & t_set, trt), (tr_set & ~t_set, tr), (t_set & ~tr_set, tt)):
        out = [(_w3 if o.dim() == 2 else torch.where)(m, a, o) for o, a in zip(out, lobe)]
    return out


def _marschner(mp: CoreMat, nin, n, fu, fv, fw, flags, p_choice):
    """fur.marschner_sample twin (MarschnerHairBSDF::localSample,
    Bsdf.cpp:465-769): degree-valued alpha/beta fed to radian math and the
    x10 TRT boost, as in the reference."""
    alpha, beta = mp.hair_alpha, mp.hair_beta
    theta_i = _theta(*_to_cyl(nin, fu, fv, fw))
    nf = vm.faceforward(n, -nin, n)
    gamma_i = vm.angle_between(nin, vm.normalize(n))
    h = torch.sin(gamma_i)
    b1, b2 = _bravais(mp.ior, gamma_i)
    fresnel = dielectric_fresnel(gamma_i, b1, b2)
    zero3 = torch.zeros_like(nin)
    ones = torch.ones_like(h)
    zeros = torch.zeros_like(h)

    wo_r = vm.rotate_about_axis(vm.reflect(-nin, nf), fv, -alpha)
    th_r = _theta(*_to_cyl(wo_r, fu, fv, fw))
    th_h, th_d = 0.5 * (th_r + theta_i), 0.5 * (th_r - theta_i)
    pdf_r = normal_gauss_pdf(th_h - alpha, 0.0, beta)
    dh_dphi = _safe_div(-2.0, torch.sqrt(torch.clamp(1.0 - h * h, min=_HAIR_EPS))).abs()
    scat_r = pdf_r * (0.5 * fresnel * dh_dphi) / torch.clamp(torch.cos(th_d) ** 2,
                                                             min=_HAIR_EPS)
    r_lobe = (scat_r[:, None].expand(-1, 3), wo_r, pdf_r,
              torch.full_like(flags, MATFLAG_SPECULAR_BOUNCE), theta_i)
    enter = (zero3, vm.refract(-nin, nf, 1.0 / mp.ior), ones,
             torch.where(p_choice == 2, MATFLAG_CYLINDER_TR_BOUNCE,
                         MATFLAG_CYLINDER_T_BOUNCE).to(torch.int32), zeros)

    c_tt = torch.asin(_clip1(1.0 / b1))
    inv_root = _safe_div(1.0, torch.sqrt(torch.clamp(1.0 - h * h, min=_HAIR_EPS)))
    pi3 = math.pi ** 3

    wo_tt = vm.rotate_about_axis(vm.refract(-nin, nf, 1.0), fv, alpha / 2.0)
    th_r_tt = _theta(*_to_cyl(wo_tt, fu, fv, fw))
    th_h_tt, th_d_tt = 0.5 * (th_r_tt + theta_i), 0.5 * (th_r_tt - theta_i)
    pdf_tt = normal_gauss_pdf(th_h_tt + alpha / 2.0, 0.0, beta / 2.0)
    denom = inv_root * (-(24.0 * c_tt / pi3) * gamma_i ** 2 + (6.0 * c_tt / math.pi - 2.0))
    dh_tt = _safe_div(1.0, denom.abs())
    cos_gamma_t = -2.0 * torch.cos(torch.asin(_clip1(h / b1)))
    inv_ctr = 1.0 / torch.clamp(torch.cos(th_r_tt), min=_HAIR_EPS)
    att = torch.exp(mp.diffuse * inv_ctr[:, None] * cos_gamma_t[:, None]) \
        * ((1.0 - fresnel) ** 2)[:, None]
    refl_tt = att * (0.5 * dh_tt)[:, None] \
        * (pdf_tt / torch.clamp(torch.cos(th_d_tt) ** 2, min=_HAIR_EPS))[:, None]
    tt = (refl_tt, wo_tt, pdf_tt, torch.zeros_like(flags), theta_i)

    tr = (zero3, vm.reflect(-nin, nf), ones,
          torch.full_like(flags, MATFLAG_CYLINDER_TR_BOUNCE | MATFLAG_CYLINDER_T_BOUNCE
                          | MATFLAG_SPECULAR_BOUNCE), zeros)

    wo_trt = vm.rotate_about_axis(vm.refract(-nin, nf, 1.0), fv, 3.0 * alpha / 2.0)
    th_r_trt = _theta(*_to_cyl(wo_trt, fu, fv, fw))
    th_h_trt, th_d_trt = 0.5 * (th_r_trt + theta_i), 0.5 * (th_r_trt - theta_i)
    pdf_trt = normal_gauss_pdf(th_h_trt + 3.0 * alpha / 2.0, 0.0, 2.0 * beta)
    denom2 = inv_root * (-(48.0 * c_tt / pi3) * gamma_i ** 2 + (12.0 * c_tt / math.pi - 2.0))
    dh_trt = _safe_div(1.0, denom2.abs())
    gamma_t = torch.asin(_clip1(h / b1))
    fresnel_exit = dielectric_fresnel(gamma_t, 1.0 / b1, 1.0 / b2)
    inv_ctr2 = 1.0 / torch.clamp(torch.cos(th_r_trt), min=_HAIR_EPS)
    e2 = torch.exp(mp.diffuse * inv_ctr2[:, None] * (-2.0 * torch.cos(gamma_t))[:, None])
    att2 = (e2 * e2) * ((1.0 - fresnel) ** 2 * fresnel_exit)[:, None]
    refl_trt = att2 * (0.5 * dh_trt)[:, None] * (
        10.0 * pdf_trt / torch.clamp(torch.cos(th_d_trt) ** 2, min=_HAIR_EPS))[:, None]
    trt = (refl_trt, wo_trt, pdf_trt, torch.zeros_like(flags), theta_i)
    return _walk_select(flags, p_choice, r_lobe, enter, tt, tr, trt)


def _deon(mp: CoreMat, nin, n, fu, fv, fw, flags, p_choice):
    """fur.deon_sample twin (DEonHairBSDF::localSample, Bsdf.cpp:784-1051)."""
    ic0, ic1, ic2 = _to_cyl(nin, fu, fv, fw)
    alpha = torch.deg2rad(mp.hair_alpha)
    beta = torch.deg2rad(mp.hair_beta)
    ior = mp.ior
    theta_i = _theta(ic0, ic1, ic2)
    phi_i = _phi(ic0, ic1)
    gamma_i = vm.angle_between(nin, vm.normalize(n))
    h = torch.sin(gamma_i)
    nf = vm.faceforward(n, -nin, n)
    zero3 = torch.zeros_like(nin)
    ones = torch.ones_like(h)

    wo_r = vm.rotate_about_axis(vm.reflect(-nin, nf), fv, -alpha)
    rc0, rc1, rc2 = _to_cyl(wo_r, fu, fv, fw)
    m_r = _deon_M(beta * beta, theta_i, _theta(rc0, rc1, rc2), radians_quirk=True)
    d_r = 0.25 * torch.cos(_phi(rc0, rc1) - phi_i / 2.0).abs()
    fres_r = dielectric_fresnel(
        0.5 * torch.acos(_clip1(vm.dot(nin, vm.normalize(wo_r)))), 1.0, ior)
    s_r = m_r * 0.5 * fres_r * d_r
    r_lobe = (s_r[:, None].expand(-1, 3), wo_r, m_r,
              torch.full_like(flags, MATFLAG_SPECULAR_BOUNCE), theta_i)
    enter = (zero3, vm.refract(-nin, nf, 1.0 / ior), ones,
             torch.where(p_choice == 2, MATFLAG_CYLINDER_TR_BOUNCE,
                         MATFLAG_CYLINDER_T_BOUNCE).to(torch.int32), theta_i)

    def exit_lobe(angle, lobe_beta, trt: bool):
        wo = vm.rotate_about_axis(vm.refract(-nin, nf, 1.0), fv, angle)
        c0, c1, c2 = _to_cyl(wo, fu, fv, fw)
        theta_r = _theta(c0, c1, c2)
        theta_d = 0.5 * (theta_r - theta_i)
        m = _deon_M(lobe_beta ** 2, theta_i, theta_r, radians_quirk=False)
        phi = _phi(c0, c1) - phi_i
        cos_td = torch.cos(theta_d)
        bravais = torch.sqrt(torch.clamp(ior * ior - torch.sin(theta_d) ** 2,
                                         min=_HAIR_EPS)) / torch.clamp(cos_td, min=_HAIR_EPS)
        det = _deon_detector(phi, torch.rad2deg(lobe_beta))
        fres = dielectric_fresnel(torch.acos(_clip1(cos_td * torch.cos(gamma_i))), ior, 1.0)
        cos_2gt = torch.cos(2.0 * torch.asin(_clip1(h / bravais)))
        inv_c = 1.0 / torch.clamp(torch.cos(theta_r), min=_HAIR_EPS)
        base = torch.exp(mp.diffuse * inv_c[:, None] * (-2.0 * (1.0 + cos_2gt))[:, None])
        if trt:
            att = (base * base) * ((1.0 - fres) ** 2 * fres)[:, None]
        else:
            att = base * ((1.0 - fres) ** 2)[:, None]
        return (att * (m * 0.5 * det)[:, None], wo, m, torch.zeros_like(flags), theta_i)

    tt = exit_lobe(alpha / 2.0, beta / 2.0, trt=False)
    tr = (zero3, vm.reflect(-nin, nf), ones,
          torch.full_like(flags, MATFLAG_CYLINDER_TR_BOUNCE | MATFLAG_CYLINDER_T_BOUNCE
                          | MATFLAG_SPECULAR_BOUNCE), theta_i)
    trt = exit_lobe(3.0 * alpha / 2.0, beta * 2.0, trt=True)
    return _walk_select(flags, p_choice, r_lobe, enter, tt, tr, trt)


def sample_hair(mp: CoreMat, wi, n, fu, fv, fw, flags, p_choice):
    """One step of the hair walk: d'Eon for its bsdf id, Marschner
    otherwise -> (refl, wo, pdf, flags, theta_i)."""
    nin = vm.normalize(wi)
    m = _marschner(mp, nin, n, fu, fv, fw, flags, p_choice)
    d = _deon(mp, nin, n, fu, fv, fw, flags, p_choice)
    is_deon = mp.bsdf_id == BSDF_DEON_HAIR
    return [(_w3 if a.dim() == 2 else torch.where)(is_deon, b, a) for a, b in zip(m, d)]


# ---------------------------------------------------------------------------
# The bounce's shade stage
# ---------------------------------------------------------------------------

def shade_bounce_core(
    *, origin, direction, radiance, color, flags, theta_i, prev_pdf,
    hit_t, hit_valid, hit_pos, hit_normal, mp: CoreMat,
    env_color,  # [R,3] or [3]: environment radiance for `direction`
    env_ambient,  # [3]: scene-constant ambient
    lights: list, u_bsdf1, u_bsdf2, u_pick, u_light1, u_light2, u_rr,
    rr_gate: bool,  # bounce >= cfg.rr_start
    cfg: CoreCfg,
    fib_u=None, fib_v=None, fib_w=None,  # [R,3] fiber frame at the hit (hair)
    u_hairp=None,  # [R] walk-choice draw (hair with cfg.hair_p_random)
) -> CoreOut:
    """One wavefront bounce after the scene traversal (trace_bounce
    line for line), with the NEE term factored out as (shadow ray,
    direct_rgb) so that the caller applies the scene occlusion."""
    n_lights = cfg.n_lights
    active = (radiance != 0.0).any(-1)
    do_trace = active & (direction != 0.0).any(-1)

    # --- analytic light intersections (traceRay:185-208)
    t_light = torch.full_like(hit_t, INF)
    light_ix = torch.zeros_like(flags)
    for l, li in enumerate(lights):
        tl, _ = light_hit(origin, direction, li)
        better = tl < t_light
        t_light = torch.where(better, tl, t_light)
        light_ix = torch.where(better, l, light_ix)
    light_wins = t_light < hit_t if n_lights else torch.zeros_like(hit_valid)

    miss = do_trace & ~hit_valid & ~light_wins
    hit_light = do_trace & light_wins
    hit_geom = do_trace & hit_valid & ~light_wins

    color = color + _w3(miss, env_color * radiance, 0.0)

    if n_lights:
        lrad = torch.zeros_like(color)
        for l, li in enumerate(lights):
            lrad = _w3(light_ix == l, light_emitted(li, direction), lrad)
        if cfg.mis:
            p_l = torch.zeros_like(hit_t)
            area_like = torch.zeros_like(hit_valid)
            for l, li in enumerate(lights):
                sel = light_ix == l
                p_l = torch.where(sel, light_solid_angle_pdf(li, n_lights, direction, t_light), p_l)
                if li.area_like:
                    area_like = area_like | sel
            w = torch.where(prev_pdf <= 0.0, 1.0,
                            torch.where(area_like, power_heuristic(prev_pdf, p_l), 0.0))
            lrad = lrad * w[..., None]
        color = color + _w3(hit_light, lrad * radiance, 0.0)

    radiance = _w3(miss | hit_light, 0.0, radiance)

    # --- sanitize the hit fields of missed rays
    up = torch.tensor([0.0, 1.0, 0.0], device=origin.device)
    n = _w3(hit_valid, hit_normal, up)
    pos = _w3(hit_valid, hit_pos, 0.0)
    counter = -vm.normalize(direction)

    # --- NEE (calcDirectLight / calc_direct_light_mis), occlusion deferred
    if n_lights:
        pick = torch.clamp((u_pick * n_lights).to(torch.int32), max=n_lights - 1)
        target = torch.zeros_like(pos)
        att = torch.zeros_like(hit_t)
        lcolor = torch.zeros_like(pos)
        area_like = torch.zeros_like(hit_valid)
        has_color = torch.zeros_like(hit_valid)
        for l, li in enumerate(lights):
            sel = pick == l
            tgt_l, att_l = light_sample_dir(li, pos, u_light1, u_light2)
            target = _w3(sel, tgt_l, target)
            att = torch.where(sel, att_l, att)
            lcolor = _w3(sel, li.color, lcolor)
            if li.area_like:
                area_like = area_like | sel
            if li.has_color:
                has_color = has_color | sel

        direction_l = target - pos
        dist = vm.length(direction_l)
        wi = vm.normalize(direction_l)
        if cfg.mis:
            sh_o = pos + vm.faceforward(n, -wi, n) * 1e-4
            le = torch.zeros_like(pos)
            p_l = torch.zeros_like(hit_t)
            for l, li in enumerate(lights):
                sel = pick == l
                le = _w3(sel, light_emitted(li, wi), le)
                p_l = torch.where(sel, light_solid_angle_pdf(li, n_lights, wi, dist), p_l)
            f, bpdf = eval_pdf(mp, n, -vm.normalize(direction), wi)
            cos_x = vm.dot(wi, n).abs()
            w = power_heuristic(p_l, bpdf)
            contrib_area = le * f * (cos_x * w / torch.clamp(p_l, min=1e-12))[..., None]
            contrib_ref = lcolor * f * (att * cos_x * n_lights)[..., None]
            contrib = _w3(area_like, contrib_area, contrib_ref)
            t_max = dist * (1.0 - 1e-3)
        else:
            lightpos = pos + direction_l
            sh_o = pos + vm.faceforward(n, pos - lightpos, n) * 1e-4
            f = evaluate_light(mp, n, wi, -vm.normalize(direction))
            contrib = lcolor * f * (att * vm.dot(wi, n).abs())[..., None]
            t_max = vm.length(lightpos - sh_o)
        t_max = torch.where(hit_geom, t_max, 0.0)
        # light geometry also occludes (SimpleShader.h:135-144)
        light_blocked = torch.zeros_like(hit_valid)
        for l, li in enumerate(lights):
            tl, okl = light_hit(sh_o, wi, li)
            blocks = okl & (tl < t_max)
            if cfg.mis:
                blocks = blocks & (pick != l)
            light_blocked = light_blocked | blocks
        direct = _w3(has_color & ~light_blocked, contrib, 0.0)
        shadow_o, shadow_d, shadow_tmax = sh_o, wi, t_max
    else:
        direct = torch.zeros_like(pos)
        shadow_o = torch.zeros_like(pos)
        shadow_d = up.expand_as(pos)
        shadow_tmax = torch.zeros_like(hit_t)

    # ambient = env_ambient * evaluateLight(n, n) / pi (SimpleShader.h:47)
    ambient = evaluate_light(mp, n, n, n)

    # --- BSDF sample, or the hair walk's step on hair-shader materials
    refl, wo, pdf, new_flags = sample_surface(mp, counter, n, u_bsdf1, u_bsdf2, flags,
                                              present=cfg.bsdfs_present)
    if cfg.has_hair:
        if cfg.hair_p_random:
            p_choice = torch.clamp((u_hairp * 3).to(torch.int32), max=2)
        else:
            p_choice = torch.zeros_like(flags)
        xax = torch.tensor([1.0, 0.0, 0.0], device=origin.device)
        zax = torch.tensor([0.0, 0.0, 1.0], device=origin.device)
        fu = _w3(hit_valid, fib_u, xax)
        fv = _w3(hit_valid, fib_v, up)
        fw = _w3(hit_valid, fib_w, zax)
        h_refl, h_wo, h_pdf, h_flags, hs_theta_i = sample_hair(mp, counter, n, fu, fv, fw,
                                                               flags, p_choice)
        is_hair = mp.shader_id == SHADER_MARSCHNER_HAIR
        refl, wo = _w3(is_hair, h_refl, refl), _w3(is_hair, h_wo, wo)
        pdf = torch.where(is_hair, h_pdf, pdf)
        new_flags = torch.where(is_hair, h_flags, new_flags)
    else:
        is_hair = torch.zeros_like(hit_valid)
        hs_theta_i = theta_i
    refl_zero = (refl == 0.0).all(-1)
    if cfg.rr:
        kill = refl_zero | (pdf <= 1e-4)
    else:
        kill = refl_zero | (pdf <= 1e-4) | (radiance.amax(-1) < 0.01)

    emissive = (new_flags & MATFLAG_EMISSIVE_BOUNCE) != 0
    mid_walk = (new_flags & (MATFLAG_CYLINDER_T_BOUNCE | MATFLAG_CYLINDER_TR_BOUNCE)) != 0
    specular = (new_flags & MATFLAG_SPECULAR_BOUNCE) != 0
    offset = _w3(specular, wo * 1e-4, vm.faceforward(-1e-4 * n, n, wo))
    new_origin = pos + offset

    # the direct term, suppressed while a hair walk is inside the fiber
    direct_gate = hit_geom & ~(is_hair & mid_walk)
    direct_rgb = _w3(direct_gate, direct * radiance, 0.0)
    shadow_tmax = torch.where(direct_gate, shadow_tmax, 0.0)

    # --- SimpleShader / MarschnerHairShader colour and throughput update
    amb_rgb = (env_ambient * ambient * INV_PI) * radiance
    simple_color = amb_rgb + _w3(emissive & ~kill, mp.emission * radiance, 0.0)
    inv_pdf = 1.0 / torch.clamp(pdf, min=1e-20)
    simple_radiance = _w3(kill | emissive, 0.0,
                          radiance * refl * (vm.dot(wo, n).abs() * inv_pdf)[..., None])
    hair_color = _w3(mid_walk, 0.0, amb_rgb)
    hair_radiance = _w3(mid_walk, radiance, _w3(
        kill, 0.0, radiance * refl * (3.0 * torch.cos(hs_theta_i).abs())[..., None]))
    color = color + _w3(hit_geom, _w3(is_hair, hair_color, simple_color), 0.0)
    radiance = _w3(hit_geom, _w3(is_hair, hair_radiance, simple_radiance), radiance)
    radiance = torch.clamp(radiance, max=cfg.clamp_throughput)

    if cfg.rr:
        q = torch.clamp(radiance.amax(-1), 0.05, 1.0)
        do_rr = hit_geom & ~mid_walk if rr_gate else torch.zeros_like(hit_geom)
        dead = do_rr & (u_rr >= q)
        boost = torch.where(do_rr & ~dead, 1.0 / q, 1.0)
        radiance = _w3(dead, 0.0, radiance * boost[..., None])

    # continuing rays take the new ray; the hair walk moves its ray (and
    # writes its flags and theta_i) even mid-walk
    continuing = hit_geom & ~kill & ~emissive
    move = continuing | (hit_geom & is_hair)
    origin = _w3(move, new_origin, origin)
    direction = _w3(move, wo, direction)
    flags = torch.where(move, new_flags, flags)
    theta_i = torch.where(hit_geom & is_hair, hs_theta_i, theta_i)

    if cfg.mis:
        spdf = torch.where(is_hair, -1.0, sample_pdf(mp, n, counter, wo))
        prev_pdf = torch.where(hit_geom, spdf, prev_pdf)

    return CoreOut(origin=origin, direction=direction, radiance=radiance, color=color,
                   flags=flags, theta_i=theta_i, prev_pdf=prev_pdf, shadow_o=shadow_o,
                   shadow_d=shadow_d, shadow_tmax=shadow_tmax, direct_rgb=direct_rgb)
