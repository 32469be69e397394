# Frozen copy of ba_pathtracing_fur_torch/models/fur.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# what the reference's progressive sample of the hair ball calls.
"""Hair-fiber scattering: the Marschner and d'Eon walk automaton.

Counterpart of `ba_pathtracing_fur_tpu/models/fur.py`:

  * the elementwise helpers: Bessel J0 (the d'Eon M term uses MSVC `_j0`,
    Bsdf.cpp:993-995), the Bravais virtual indices (Bsdf.cpp:542-545) and
    the guarded clip and division, with the reference's constants and clamps;
  * the walk itself (MarschnerHairBSDF / DEonHairBSDF::localSample,
    Bsdf.cpp:465-1051) is the plain-torch automaton of
    `models/shade_core.py` (`_marschner`, `_deon`, `sample_hair`), which
    reads these helpers.
"""

from __future__ import annotations

import torch


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


