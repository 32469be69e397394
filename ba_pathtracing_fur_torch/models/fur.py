"""Hair-fiber scattering: the Marschner and d'Eon walk automaton.

Counterpart of `ba_pathtracing_fur_tpu/models/fur.py`:

  * the elementwise helpers: Bessel J0 (the d'Eon M term uses MSVC `_j0`,
    Bsdf.cpp:993-995), the Bravais virtual indices (Bsdf.cpp:542-545) and
    the guarded clip and division, with the reference's constants and clamps;
  * `marschner_sample`, `deon_sample` and `sample_hair`: one step of the
    cylinder walk (MarschnerHairBSDF / DEonHairBSDF::localSample,
    Bsdf.cpp:465-1051) with the JAX package's signatures, over the
    plain-torch automaton of `models/shade_core.py` (`_marschner`,
    `_deon`), which the fused path's plain version runs too. The walk state
    rides in the MATFLAG_CYLINDER_T/TR bits of the ray's flags; `p_choice`
    0/1/2 picks R, TT or TRT on a first hit;
  * `marschner_closed_form`: the Whitted fur shader's single-pass R, TT and
    TRT lobes (Simple_CPU_Raytracer.cpp:451-746) with their tangent
    (`hair_tangent`), given the second- and third-wall normals.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import sampling as sp, vecmath as vm

_EPS = 1e-6


def bessel_j0(x: torch.Tensor) -> torch.Tensor:
    """Bessel function of the first kind, order 0 (Abramowitz & Stegun 9.4).
    Each branch's input is clamped into its own domain, as in the reference."""
    ax = x.abs()
    y = torch.clamp(x * x, max=64.0)
    p1 = (57568490574.0 + y * (-13362590354.0 + y * (651619640.7
          + y * (-11214424.18 + y * (77392.33017 + y * -184.9052456)))))
    q1 = (57568490411.0 + y * (1029532985.0 + y * (9494680.718
          + y * (59272.64853 + y * (267.8532712 + y)))))
    small = p1 / q1
    ax_l = torch.clamp(ax, min=8.0)
    z = 8.0 / ax_l
    y2 = z * z
    xx = ax_l - 0.785398164
    p2 = (1.0 + y2 * (-0.1098628627e-2 + y2 * (0.2734510407e-4
          + y2 * (-0.2073370639e-5 + y2 * 0.2093887211e-6))))
    q2 = (-0.1562499995e-1 + y2 * (0.1430488765e-3 + y2 * (-0.6911147651e-5
          + y2 * (0.7621095161e-6 + y2 * -0.934935152e-7))))
    large = torch.sqrt(0.636619772 / ax_l) * (torch.cos(xx) * p2 - z * torch.sin(xx) * q2)
    return torch.where(ax < 8.0, small, large)


def _bravais(ior: torch.Tensor, gamma_i: torch.Tensor):
    """Virtual (Bravais) indices (Bsdf.cpp:542-545) -> (n1, n2)."""
    cg = torch.cos(gamma_i)
    cg_safe = torch.where(cg.abs() < _EPS, _EPS, cg)
    x1 = torch.sqrt(torch.clamp(ior * ior - torch.sin(gamma_i) ** 2, min=_EPS))
    return x1 / cg_safe, ior * ior * cg_safe / x1


def _clip1(x: torch.Tensor) -> torch.Tensor:
    """Clip to the open interval (-1, 1)."""
    return torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)


def _safe_div(a, b: torch.Tensor) -> torch.Tensor:
    """a / b with |b| floored at 1e-6, keeping its sign."""
    return a / torch.where(b.abs() < _EPS, torch.where(b < 0, -_EPS, _EPS), b)


class HairSample(NamedTuple):
    reflectance: torch.Tensor  # [R,3]
    wo: torch.Tensor  # [R,3]
    pdf: torch.Tensor  # [R]
    flags: torch.Tensor  # [R] int32
    theta_i: torch.Tensor  # [R] kept for the hair shader (Bsdf.cpp:516)


def marschner_sample(mp, wi, n, fu, fv, fw, flags, p_choice) -> HairSample:
    """One Marschner automaton step (Bsdf.cpp:465-769): degree-valued
    alpha/beta fed to radian math and the x10 TRT boost, as the reference."""
    from . import shade_core as sc  # imported here: shade_core imports this module
    nin = vm.normalize(wi)
    return HairSample(*sc._marschner(mp, nin, n, fu, fv, fw, flags, p_choice))


def deon_sample(mp, wi, n, fu, fv, fw, flags, p_choice) -> HairSample:
    """One d'Eon automaton step (Bsdf.cpp:784-1051)."""
    from . import shade_core as sc
    nin = vm.normalize(wi)
    return HairSample(*sc._deon(mp, nin, n, fu, fv, fw, flags, p_choice))


def sample_hair(mp, wi, n, fu, fv, fw, flags, p_choice) -> HairSample:
    """d'Eon's step for its bsdf id, Marschner's otherwise."""
    from . import shade_core as sc
    return HairSample(*sc.sample_hair(mp, wi, n, fu, fv, fw, flags, p_choice))


def hair_tangent(normal: torch.Tensor) -> torch.Tensor:
    """The Whitted fur shader's tangent (Simple_CPU_Raytracer.cpp:470-472):
    the longer of n x z and n x y, normalized."""
    c1 = vm.cross(normal, torch.tensor([0.0, 0.0, 1.0], device=normal.device))
    c2 = vm.cross(normal, torch.tensor([0.0, 1.0, 0.0], device=normal.device))
    use1 = vm.length(c1) > vm.length(c2)
    return vm.normalize(torch.where(use1[..., None], c1, c2))


class ClosedFormLobes(NamedTuple):
    scat_r: torch.Tensor  # [R,3]
    scat_tt: torch.Tensor
    scat_trt: torch.Tensor
    sin_theta_i: torch.Tensor  # [R]


def marschner_closed_form(mp, ray_dir, normal, fiber_axis, t_normal,
                          tr_normal) -> ClosedFormLobes:
    """Single-pass R + TT + TRT lobes (Simple_CPU_Raytracer.cpp:451-746).

    `ray_dir` [R,3] points toward the surface, `normal` is the hit normal,
    `fiber_axis` the cone's V axis (the lobes' tilt axis), `t_normal` and
    `tr_normal` the normals at the TT second-wall hit and the TRT first-wall
    re-hit, which the caller traces. The reference's quirks stay: alpha is
    given in degrees and used as radians, and degenerate lobes (an out ray
    along the tangent, a zero refraction at grazing) are scrubbed to 0."""
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
    m_r = sp.normal_gauss_pdf(theta_h - torch.deg2rad(alpha), 0.0, beta)
    h_r = torch.sin(phi) * -0.5
    gamma_r = torch.asin(_clip1(h_r))
    dh_dphi_r = _safe_div(-2.0, torch.sqrt(torch.clamp(1.0 - h_r * h_r, min=_EPS))).abs()
    b1, b2 = _bravais(ior, gamma_r)
    fr = sp.dielectric_fresnel(torch.cos(gamma_r), b1, b2)
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
    m_tt = sp.normal_gauss_pdf(theta_h_tt - torch.deg2rad(-alpha / 2.0), 0.0, beta / 2.0)
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
    f_tt = sp.dielectric_fresnel(torch.cos(gamma_tt), b1t, b2t)
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
    m_trt = sp.normal_gauss_pdf(theta_h_trt - torch.deg2rad(-3.0 * alpha / 2.0), 0.0,
                                2.0 * beta)
    gamma_trt = vm.angle_between(nin, vm.normalize(normal))
    h_trt = torch.sin(gamma_trt)
    b1r, b2r = _bravais(ior, gamma_trt)
    c_trt = torch.asin(_clip1(1.0 / b1r))
    denom_trt = _safe_div(1.0, torch.sqrt(torch.clamp(1.0 - h_trt * h_trt, min=_EPS))) * (
        -(48.0 * c_trt / pi ** 3) * gamma_trt ** 2 + (12.0 * c_trt / pi - 2.0))
    dh_dphi_trt = _safe_div(1.0, denom_trt.abs())
    f_trt = sp.dielectric_fresnel(torch.cos(gamma_trt), b1r, b2r)
    f_trt = torch.where(f_trt == 1.0, 0.0, f_trt)
    cos_gamma_t2 = torch.cos(torch.asin(_clip1(h_trt / b1r)))
    f_exit = sp.dielectric_fresnel(cos_gamma_t2, 1.0 / b1r, 1.0 / b2r)
    sigma2 = mp.diffuse / torch.clamp(torch.cos(theta_r_trt), min=_EPS)[:, None]
    att_trt = ((1.0 - f_trt) ** 2 * f_exit)[:, None] * \
        torch.exp(sigma2 * (-2.0 * cos_gamma_t2)[:, None]) ** 2
    n_trt = 0.5 * att_trt * dh_dphi_trt[:, None]
    scat_trt = m_trt[:, None] * n_trt / cos2(theta_d_trt)[:, None]

    def finite(x):
        return torch.where(torch.isfinite(x), x, 0.0)

    return ClosedFormLobes(finite(scat_r), finite(scat_tt), finite(scat_trt), sin_theta_i)
