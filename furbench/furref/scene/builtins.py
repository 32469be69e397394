# Frozen copy of ba_pathtracing_fur_torch/scene/builtins.py at commit 24f22d1 (the benchmark's
# reference: kept as it was, so that later changes to the port cannot move it), cut to the
# hair ball with its fibers grown on the device.
"""The hair ball of the built-in scenes.

Counterpart of `ba_pathtracing_fur_tpu/scene/builtins.py`'s hair ball, with
the same geometry, materials, lights and camera. The scene lands on the
card unless the caller asks for another device (`device="cpu"`).

The hair ball's `on_device=True` fibers come from the port's threefry on
the scene's device. The JAX package mirrors the draws' cone centroids on
the host (`LAST_HAIRBALL_GEN`) so its TPU never pulls the pack over the
host link for the BVH split; the port's build reads the centroids where
the pack lies (`ops/traverse.attach_bvh`), so it has no such mirror.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.camera import make_camera
from . import mesh as mesh_mod
from .types import (
    BSDF_LAMBERT, DeviceScene, Environment, make_cone_pack_torch,
    make_light_pack, make_material_table, make_triangle_pack, scene_bsdfs_present,
    scene_has_hair, to_device,
)


def _dirs_from_u(u):
    """Uniform sphere directions from [N,2] uniforms."""
    phi = 2.0 * np.pi * u[:, 0]
    cos_t = 2.0 * u[:, 1] - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
    return torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)], -1)


def _hair_ball_cones_on_device(n_fibers, fiber_verts, fiber_radius, sphere_radius, seed,
                               device, lean: float = 0.25):
    """The fiber cone pack generated on `device` from the threefry draws of
    the JAX package's `_hair_ball_draws` (split key -> [N,2] sphere
    uniforms, [N,3] gaussian lean)."""
    ku, kl = rng.split(rng.key(seed, device), 2)
    u = rng.uniform(ku, (n_fibers, 2))
    lean_raw = rng.normal(kl, (n_fibers, 3)) * lean
    dirs = _dirs_from_u(u)
    fibers = mesh_mod.grow_fur_fibers_along_torch(dirs * sphere_radius, dirs, lean_raw,
                                                  fiber_verts, fiber_radius)
    b, a, r0, r1 = mesh_mod.fibers_to_cone_chain(fibers)
    return make_cone_pack_torch(b, a, r0, r1, torch.ones(b.shape[0], dtype=torch.int32,
                                                          device=device))


def hair_ball(resolution=(512, 512), n_fibers=10000, fiber_verts=10, fiber_radius=0.004,
              sphere_radius=0.5, bsdf="MarschnerHairBSDF", seed=0, on_device=True,
              device="cuda"):
    """Hair ball (bench config 5): a UV-sphere scalp of 768 triangles and
    radially grown fibers as cone chains, a quad light and a sun.

    The fibers grow on `device` from the ported threefry draws (the port's
    `on_device=True`; its numpy stream is left out). Returns (DeviceScene,
    Camera) on `device`."""
    if not on_device:
        raise ValueError("the reference grows the hair ball's fibers on the device only")
    n_lat, n_lon = 16, 24
    verts = []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append((sphere_radius * np.sin(th) * np.cos(ph),
                          sphere_radius * np.cos(th),
                          sphere_radius * np.sin(th) * np.sin(ph)))
    verts = np.asarray(verts, np.float32)
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            tris.append((verts[a], verts[b], verts[c]))
            tris.append((verts[b], verts[d], verts[c]))
    v = np.asarray(tris, np.float32)

    skin = dict(name="scalp", diffuse=(0.3, 0.2, 0.15), bsdf=BSDF_LAMBERT)
    fur_mat = dict(name="Fiber_Mat", diffuse=(0.545, 0.353, 0.169), ior=1.55, bsdf=bsdf)
    pack = make_triangle_pack(v[:, 0], v[:, 1], v[:, 2], mat_id=np.zeros(len(tris)))

    cones = _hair_ball_cones_on_device(n_fibers, fiber_verts, fiber_radius, sphere_radius,
                                       seed, device)

    lights = make_light_pack([
        dict(kind="quad", color=(12.0, 12.0, 12.0), position=(1.5, 2.0, 1.5),
             direction=(-0.5, -0.7, -0.5), size=(1.0, 1.0)),
        dict(kind="sun", color=(1.0, 1.0, 0.95), direction=(0.3, -1.0, 0.2), radius=0.05),
    ])
    mat_table = make_material_table([skin, fur_mat])
    scene = DeviceScene(
        tris=pack, cones=cones, materials=mat_table, lights=lights,
        env=Environment(color=torch.tensor([0.1, 0.1, 0.12]),
                        ambient=torch.tensor([0.05, 0.05, 0.05])),
        has_hair=scene_has_hair(mat_table), bsdfs_present=scene_bsdfs_present(mat_table))
    cam = make_camera(position=(0.0, 0.3, 2.2), look_at=(0.0, -0.1, -1.0),
                      up=(0.0, 1.0, 0.0), resolution=resolution, device=device)
    return to_device(scene, device), cam
