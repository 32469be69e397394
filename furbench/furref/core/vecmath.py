# Frozen copy of ba_pathtracing_fur_torch/core/vecmath.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# what the reference's progressive sample of the hair ball calls.
"""Vector math on `[..., 3]` float tensors.

Counterpart of `ba_pathtracing_fur_tpu/core/vecmath.py`, holding what the
camera, the shading body and the hair shaders use. Every function is
batched over the leading axes; scalars come back as `[...]` tensors.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=1e-20))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize: zero vectors pass through scaled by 0."""
    return v / torch.clamp(length(v), min=EPS)[..., None]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """GLSL-convention reflect: incident points toward the surface."""
    return incident - (2.0 * dot(incident, normal))[..., None] * normal


def refract(incident: torch.Tensor, normal: torch.Tensor, eta) -> torch.Tensor:
    """glm::refract; the zero vector on total internal reflection. `eta` is
    a float or a `[...]` tensor."""
    if isinstance(eta, torch.Tensor):
        eta = eta[..., None]
    cos_i = dot(normal, incident)[..., None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = eta * incident - (eta * cos_i + torch.sqrt(torch.clamp(k, min=1e-12))) * normal
    return torch.where(k < 0.0, 0.0, out)


def faceforward(n: torch.Tensor, i: torch.Tensor, nref: torch.Tensor) -> torch.Tensor:
    """GLSL faceforward: n if dot(nref, i) < 0 else -n."""
    return torch.where((dot(nref, i) < 0.0)[..., None], n, -n)


def local_to_world_normal(local_dir: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Math::localToWorldNormal: s = normalize(n.y^2 > n.x^2 ? (0, nz, -ny)
    : (-nz, 0, nx)); t = normalize(cross(n, s)). Not the Light frame above:
    the branch condition differs."""
    nx, ny, nz = normal.unbind(-1)
    zero = torch.zeros_like(nx)
    dx0 = torch.stack([zero, nz, -ny], dim=-1)
    dx1 = torch.stack([-nz, zero, nx], dim=-1)
    s = normalize(torch.where((ny * ny > nx * nx)[..., None], dx0, dx1))
    t = normalize(cross(normal, s))
    return (local_dir[..., 0:1] * s + local_dir[..., 1:2] * t
            + local_dir[..., 2:3] * normal)


def rotate_about_axis(v: torch.Tensor, axis: torch.Tensor, angle) -> torch.Tensor:
    """Rodrigues rotation of v about the (normalized) axis by `angle`
    radians, a float or a `[...]` tensor. The reference multiplies the row
    vector on the left of glm::rotate's matrix (Bsdf.cpp:498,587,677), which
    rotates by -angle: callers pass the negated angle."""
    angle = torch.as_tensor(angle, dtype=v.dtype, device=v.device)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    a = normalize(axis)
    return v * c + cross(a, v) * s + a * (dot(a, v)[..., None] * (1.0 - c))


def angle_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """glm::angle: acos of the clamped dot of the normalized vectors."""
    d = dot(normalize(a), normalize(b))
    return torch.acos(torch.clamp(d, -1.0 + 1e-7, 1.0 - 1e-7))


