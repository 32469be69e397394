# Frozen copy of ba_pathtracing_fur_torch/core/camera.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to
# what the reference's progressive sample of the hair ball calls.
"""Physically-parameterized thin-lens camera (KIRK::Camera parity).

Counterpart of `ba_pathtracing_fur_tpu/core/camera.py`: the same
sensor-size + focal-length FoV, bottom-left/pixel-size basis, and the
reference's quirk of leaving the depth-of-field direction unnormalized
(Camera.cpp:48).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Camera:
    """Derived camera state. Build with `make_camera` or `camera_from_numpy`."""

    position: torch.Tensor  # [3]
    axis_x: torch.Tensor  # [3]
    axis_y: torch.Tensor  # [3]
    axis_z: torch.Tensor  # [3]
    bottom_left: torch.Tensor  # [3]
    pixel_size: float  # float32 value
    aperture: float
    focus_distance: float
    resolution: Tuple[int, int] = (512, 512)
    use_dof: bool = False


def _f32(x) -> float:
    return float(np.float32(x))


def _vec(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_camera(position=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0),
                up=(0.0, 1.0, 0.0), resolution=(512, 512),
                sensor_size=(0.036, 0.024), focal_length=0.0415, f_stop=1.8,
                focus_distance=11.0, transform=None, use_dof=False,
                device="cuda") -> Camera:
    """Camera::applyParameters (Camera.cpp:6-37), in host float32 numpy as
    the JAX package does it, with the vectors on `device`. `look_at` is a
    direction."""

    def _nrm(v):
        return v / max(float(np.linalg.norm(v)), 1e-20)

    position = np.asarray(position, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)
    if transform is not None:
        t = np.asarray(transform, np.float32)
        position = (t @ np.append(position, 1.0))[:3].astype(np.float32)
        look_at = (t @ np.append(look_at, 0.0))[:3].astype(np.float32)
        up = (t @ np.append(up, 0.0))[:3].astype(np.float32)

    aperture = focal_length / f_stop
    axis_z = _nrm(-look_at).astype(np.float32)
    axis_x = _nrm(np.cross(up, axis_z)).astype(np.float32)
    axis_y = _nrm(np.cross(axis_z, axis_x)).astype(np.float32)

    sensor = np.asarray(sensor_size, np.float32)
    sensor_diameter = np.sqrt(sensor[0] ** 2 + sensor[1] ** 2)
    fov = 2.0 * np.arctan(sensor_diameter / (2.0 * focal_length))
    aspect = resolution[0] / resolution[1]
    sy = np.tan(0.5 * fov)
    sx = sy * aspect
    pixel_size = np.float32(2.0 * sx / resolution[0])
    bottom_left = (position - axis_z - sy * axis_y - sx * axis_x).astype(np.float32)

    return Camera(
        position=_vec(position, device), axis_x=_vec(axis_x, device),
        axis_y=_vec(axis_y, device), axis_z=_vec(axis_z, device),
        bottom_left=_vec(bottom_left, device), pixel_size=_f32(pixel_size),
        aperture=_f32(aperture), focus_distance=_f32(focus_distance),
        resolution=tuple(resolution), use_dof=use_dof)


def rays_from_pixels(cam: Camera, px: torch.Tensor, py: torch.Tensor,
                     jitter: torch.Tensor, dof_uniforms: torch.Tensor | None = None):
    """Primary rays for pixel coords (px, py) with subpixel jitter in [0,1)^2
    (Camera::getRayFromPixel, Camera.cpp:59-66). With `cam.use_dof`, the
    origin is jittered on a disk of radius 3*aperture and the direction
    points at the focus plane, unnormalized as in the reference.

    Returns (origins [N,3], directions [N,3]); directions are not normalized.
    """
    x = (px + jitter[..., 0])[..., None]
    y = (py + jitter[..., 1])[..., None]
    direction = (cam.bottom_left + x * cam.pixel_size * cam.axis_x
                 + y * cam.pixel_size * cam.axis_y - cam.position)
    origin = cam.position.expand_as(direction)

    if cam.use_dof:
        if dof_uniforms is None:
            raise ValueError("use_dof camera requires dof_uniforms")
        focus_point = cam.position + cam.focus_distance * direction
        r = cam.aperture * 3.0 * torch.sqrt(dof_uniforms[..., 0])
        phi = 2.0 * math.pi * dof_uniforms[..., 1]
        start = (cam.position + (r * torch.cos(phi))[..., None] * cam.axis_x
                 + (r * torch.sin(phi))[..., None] * cam.axis_y)
        direction = focus_point - start
        origin = start

    return origin, direction


