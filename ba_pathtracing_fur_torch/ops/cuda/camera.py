"""The camera wavefront (K7): each pixel's threefry key, its subpixel jitter,
its camera ray and the ray's initial state, as one CUDA kernel.

No counterpart among the TPU kernels: the JAX package's `camera_wavefront`
is plain JAX that XLA fuses. The port's plain version is the torch chain
below (`camera_rays_ref`): the keys by `core/rng.keys_for_pixels`, the
jitter by `rng.bounce_uniform` (or `rng.qmc_jitter`), the rays by
`core/camera.rays_from_pixels` and the state by `state_fields`, about 715
small launches a pass on the card. `csrc/camera.cu` makes the same keys,
rays and state bit for bit in one launch a sample.

`camera_rays` dispatches on the device: CUDA tensors launch the kernel, CPU
tensors run the torch chain. `CAMERA_LAUNCHES` counts the kernel's
launches, `CAMERA_REF_CALLS` the torch chain's calls.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ...core import camera as cam_mod, rng
from .shade import DRAW_INT_OPS, THREEFRY_INT_OPS

CAMERA_LAUNCHES = 0
CAMERA_REF_CALLS = 0

#: the tags of the camera draws at bounce -1 (`rng.bounce_uniform`)
JITTER_TAG, DOF_TAG = 7, 8


def state_fields(o: torch.Tensor, d: torch.Tensor) -> tuple:
    """The initial ray state of rays o, d [R, 3], in `RayState`'s field
    order: origin, direction, radiance 1, colour 0, flags 0, theta_i 0,
    prev_pdf -1."""
    r, dev = o.shape[0], o.device
    return (o.contiguous(), d.contiguous(),
            torch.ones((r, 3), dtype=torch.float32, device=dev),
            torch.zeros((r, 3), dtype=torch.float32, device=dev),
            torch.zeros((r,), dtype=torch.int32, device=dev),
            torch.zeros((r,), dtype=torch.float32, device=dev),
            torch.full((r,), -1.0, dtype=torch.float32, device=dev))


def camera_rays(camera: cam_mod.Camera, pixel_ids: torch.Tensor, key: torch.Tensor,
                sample_ids: Sequence[int], qmc: bool, spp: int) -> tuple:
    """The camera rays of samples `sample_ids` for the global `pixel_ids`, as
    one wavefront of len(sample_ids) * len(pixel_ids) rays (sample-major) ->
    (keys [S*R, 2] int64, `state_fields` of the rays). `qmc`: the Hammersley
    jitter of `rng.qmc_jitter` over `spp` samples, else the tag-7 draws.
    The kernel for CUDA tensors, the torch chain (`camera_rays_ref`) for
    CPU tensors."""
    dev = pixel_ids.device
    if dev.type == "cpu":
        return camera_rays_ref(camera, pixel_ids, key, sample_ids, qmc, spp)
    if dev.type != "cuda":
        raise ValueError(f"camera: no kernel for device {dev}")
    return _camera_cuda(camera, pixel_ids, key, sample_ids, qmc, spp)


def camera_rays_ref(camera: cam_mod.Camera, pixel_ids: torch.Tensor, key: torch.Tensor,
                    sample_ids: Sequence[int], qmc: bool, spp: int) -> tuple:
    """The kernel's plain version, on any device: the torch chain."""
    global CAMERA_REF_CALLS
    CAMERA_REF_CALLS += 1
    w, _ = camera.resolution
    key = key.to(pixel_ids.device)
    keys, jitter, dof_u = [], [], []
    for s in sample_ids:
        k = rng.keys_for_pixels(key, pixel_ids, s)
        keys.append(k)
        jitter.append(rng.qmc_jitter(key, pixel_ids, s, spp) if qmc
                      else rng.bounce_uniform(k, -1, 2, tag=JITTER_TAG))
        if camera.use_dof:
            dof_u.append(rng.bounce_uniform(k, -1, 2, tag=DOF_TAG))
    px = (pixel_ids % w).to(torch.float32).repeat(len(sample_ids))
    py = (pixel_ids // w).to(torch.float32).repeat(len(sample_ids))
    o, d = cam_mod.rays_from_pixels(camera, px, py, torch.cat(jitter),
                                    torch.cat(dof_u) if dof_u else None)
    return torch.cat(keys), state_fields(o, d)


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"camera: {name} must be a contiguous {dtype} {shape} tensor on "
                         f"{device}; got {x.dtype} {tuple(x.shape)} on {x.device}")


def _camera_cuda(camera: cam_mod.Camera, pixel_ids, key, sample_ids, qmc: bool, spp: int):
    from ...kernels import load_library

    global CAMERA_LAUNCHES
    dev = pixel_ids.device
    vecs = (camera.position, camera.bottom_left, camera.axis_x, camera.axis_y)
    if torch.is_grad_enabled() and any(v.requires_grad for v in vecs):
        raise ValueError("camera: the kernel has no backward; the camera's vectors must not "
                         "require grad")
    for name, v in zip(("position", "bottom_left", "axis_x", "axis_y"), vecs):
        _check(name, v, (3,), torch.float32, dev)
    ids = pixel_ids.to(torch.int64).contiguous()
    key = key.to(dev)
    r = ids.shape[0]
    _check("pixel_ids", ids, (r,), torch.int64, dev)
    _check("key", key, (2,), torch.int64, dev)
    n = r * len(sample_ids)
    f32 = torch.float32
    keys = torch.empty((n, 2), dtype=torch.int64, device=dev)
    o, d, radiance, color = (torch.empty((n, 3), dtype=f32, device=dev) for _ in range(4))
    flags = torch.empty((n,), dtype=torch.int32, device=dev)
    theta_i, prev_pdf = (torch.empty((n,), dtype=f32, device=dev) for _ in range(2))
    outs = (keys, o, d, radiance, color, flags, theta_i, prev_pdf)
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    lib = load_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for j, s in enumerate(sample_ids):
        # the Hammersley point as qmc_jitter makes it: on the CPU, in float32
        hx, hy = rng.hammersley2d(s, 1.0 / max(spp, 1)).tolist() if qmc else (0.0, 0.0)
        err = lib.camera_launch(
            ctypes.c_int(r), p(key), ctypes.c_uint(s & 0xFFFFFFFF), p(ids),
            ctypes.c_int(camera.resolution[0]), *map(p, vecs),
            ctypes.c_float(camera.pixel_size), ctypes.c_float(camera.focus_distance),
            ctypes.c_float(camera.aperture * 3.0), ctypes.c_int(camera.use_dof),
            ctypes.c_int(qmc), ctypes.c_float(hx), ctypes.c_float(hy), ctypes.c_int(j * r),
            *map(p, outs), stream)
        if err != 0:
            raise RuntimeError(f"camera kernel launch failed: CUDA error {err}")
        CAMERA_LAUNCHES += 1
    return keys, outs[1:]


def work_ref(n_rays: int, qmc: bool, use_dof: bool) -> dict:
    """What the kernel must do for `n_rays` camera rays (its bound): the
    bytes of each ray's int64 pixel id read once and of its key and state
    written once, and the integer operations of the threefry2x32 calls and
    draws a ray makes -> dict(bytes, int_ops, threefry: the calls a ray)."""
    # a ray: 8 B of pixel id in; 16 B of key, 4 x 12 B of o, d, radiance and
    # colour, 3 x 4 B of flags, theta_i and prev_pdf out
    n_bytes = n_rays * (8 + 16 + 4 * 12 + 3 * 4)
    # the key (2), the jitter's key (1, or 2 for qmc's rotation key) and its
    # 2 draws, and DoF's key and 2 draws
    threefry = 2 + (2 if qmc else 1) + 2 + (3 if use_dof else 0)
    draws = 2 + (2 if use_dof else 0)
    int_ops = n_rays * (threefry * THREEFRY_INT_OPS + draws * DRAW_INT_OPS)
    return dict(bytes=n_bytes, int_ops=int_ops, threefry=threefry)
