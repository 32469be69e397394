"""Built-in validation scenes.

Counterpart of `ba_pathtracing_fur_tpu/scene/builtins.py`: the Cornell box,
the textured terrain, the fur patch and the hair ball, with the same
geometry, materials, textures, lights and cameras. The scenes land on the
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
from .texture import build_atlas
from .types import (
    BSDF_GLASS, BSDF_LAMBERT, BSDF_SPECULAR_REFLECTION, DeviceScene, Environment,
    empty_cone_pack, make_cone_pack, make_cone_pack_torch, make_light_pack,
    make_material_table, make_triangle_pack, scene_bsdfs_present, scene_has_hair, to_device,
)


def _quad(a, b, c, d):
    """Two CCW triangles for quad corners a-b-c-d."""
    return [(a, b, c), (a, c, d)]


def _box(lo, hi):
    """12 triangles of an axis-aligned box, outward normals."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    p = {
        "000": (x0, y0, z0), "001": (x0, y0, z1), "010": (x0, y1, z0),
        "011": (x0, y1, z1), "100": (x1, y0, z0), "101": (x1, y0, z1),
        "110": (x1, y1, z0), "111": (x1, y1, z1),
    }
    tris = []
    tris += _quad(p["001"], p["101"], p["111"], p["011"])  # front +z
    tris += _quad(p["100"], p["000"], p["010"], p["110"])  # back -z
    tris += _quad(p["000"], p["001"], p["011"], p["010"])  # left -x
    tris += _quad(p["101"], p["100"], p["110"], p["111"])  # right +x
    tris += _quad(p["011"], p["111"], p["110"], p["010"])  # top +y
    tris += _quad(p["000"], p["100"], p["101"], p["001"])  # bottom -y
    return tris


def cornell_box(resolution=(256, 256), variant="diffuse", light_kind="quad",
                device="cuda"):
    """Cornell box. variant: 'diffuse' | 'glossy' (mirror + glass boxes).

    Returns (DeviceScene, Camera) on `device`."""
    white = dict(name="white", diffuse=(0.73, 0.73, 0.73), bsdf=BSDF_LAMBERT)
    red = dict(name="red", diffuse=(0.65, 0.05, 0.05), bsdf=BSDF_LAMBERT)
    green = dict(name="green", diffuse=(0.12, 0.45, 0.15), bsdf=BSDF_LAMBERT)
    mirror = dict(name="mirror", specular=(0.95, 0.95, 0.95), bsdf=BSDF_SPECULAR_REFLECTION)
    glass = dict(name="glass", volume=(1.0, 1.0, 1.0), specular=(1, 1, 1), ior=1.5,
                 bsdf=BSDF_GLASS)
    mats = [white, red, green, mirror, glass]

    tris = []
    mat_ids = []

    def add(triangles, mid):
        tris.extend(triangles)
        mat_ids.extend([mid] * len(triangles))

    s = 1.0
    # room interior, normals facing inward
    add(_quad((-s, -s, -s), (-s, -s, s), (s, -s, s), (s, -s, -s)), 0)  # floor +y
    add(_quad((-s, s, s), (-s, s, -s), (s, s, -s), (s, s, s)), 0)  # ceiling -y
    add(_quad((-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s)), 0)  # back +z
    add(_quad((-s, -s, s), (-s, -s, -s), (-s, s, -s), (-s, s, s)), 1)  # left +x red
    add(_quad((s, -s, -s), (s, -s, s), (s, s, s), (s, s, -s)), 2)  # right -x green

    if variant == "diffuse":
        add(_box((-0.55, -1.0, -0.6), (-0.05, -0.3, -0.1)), 0)
        add(_box((0.1, -1.0, -0.2), (0.6, -0.55, 0.35)), 0)
    else:
        add(_box((-0.55, -1.0, -0.6), (-0.05, -0.3, -0.1)), 3)  # mirror box
        add(_box((0.1, -1.0, -0.2), (0.6, -0.55, 0.35)), 4)  # glass box

    v = np.asarray(tris, np.float32)
    pack = make_triangle_pack(v[:, 0], v[:, 1], v[:, 2], mat_id=np.asarray(mat_ids))
    lights = make_light_pack([
        dict(kind=light_kind, color=(8.0, 8.0, 8.0), position=(0.0, 0.98, 0.0),
             direction=(0.0, -1.0, 0.0), size=(0.5, 0.5), radius=0.15,
             const_att=1.0),
    ])
    mat_table = make_material_table(mats)
    scene = DeviceScene(
        tris=pack, cones=empty_cone_pack(), materials=mat_table, lights=lights,
        env=Environment(color=torch.zeros(3), ambient=torch.zeros(3)),
        has_hair=False, bsdfs_present=scene_bsdfs_present(mat_table))
    cam = make_camera(position=(0.0, 0.0, 3.4), look_at=(0.0, 0.0, -1.0),
                      up=(0.0, 1.0, 0.0), resolution=resolution, device=device)
    return to_device(scene, device), cam


def tri_terrain(resolution=(512, 512), n_tris=100_000, seed=0, device="cuda"):
    """~n_tris-triangle fBm heightfield with a procedural diffuse texture on
    one of its two checker materials (the JAX package's bench config 3).
    Generated on the host in numpy exactly as the JAX package does it, then
    moved to `device`. Returns (DeviceScene, Camera)."""
    g = max(int(np.sqrt(n_tris / 2)), 2)  # g*g quads = 2g^2 triangles
    xs = np.linspace(-1.0, 1.0, g + 1, dtype=np.float32)
    zs = np.linspace(-1.0, 1.0, g + 1, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    # fBm heightfield from a sin lattice with random phases
    rs = np.random.RandomState(seed)
    yy = np.zeros_like(xx)
    amp, freq = 1.0, 3.0
    for _ in range(4):
        px, py = rs.uniform(0, 2 * np.pi, 2)
        yy += amp * np.sin(freq * xx + px) * np.cos(freq * zz + py)
        amp *= 0.5
        freq *= 2.0
    yy = (0.25 * yy / 1.875).astype(np.float32)
    v = np.stack([xx, yy, zz], axis=-1)  # [g+1, g+1, 3]

    a = v[:-1, :-1].reshape(-1, 3)
    b = v[1:, :-1].reshape(-1, 3)
    c = v[1:, 1:].reshape(-1, 3)
    d = v[:-1, 1:].reshape(-1, 3)
    v0 = np.concatenate([a, a])
    v1 = np.concatenate([b, c])
    v2 = np.concatenate([c, d])

    def uvs(p):  # uv from the xz position
        return (p[:, [0, 2]] + 1.0) * 0.5

    cx = ((v0[:, 0] + 1) * 4).astype(np.int64)
    cz = ((v0[:, 2] + 1) * 4).astype(np.int64)
    mat = ((cx + cz) % 2).astype(np.int64)  # checker material split

    # the 256^2 procedural diffuse texture of material A
    ty, tx = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    tex = np.stack([0.4 + 0.3 * np.sin(tx / 9.0) * np.sin(ty / 7.0),
                    0.45 + 0.2 * np.sin(tx / 13.0 + 1.0),
                    0.35 + 0.2 * np.sin(ty / 11.0 + 2.0)], axis=-1).astype(np.float32)
    mats = [dict(name="ground_a", diffuse=(0.65, 0.55, 0.40), bsdf=BSDF_LAMBERT,
                 diffuse_tex=0),
            dict(name="ground_b", diffuse=(0.30, 0.45, 0.25), bsdf=BSDF_LAMBERT)]
    pack = make_triangle_pack(v0, v1, v2, uv0=uvs(v0), uv1=uvs(v1), uv2=uvs(v2), mat_id=mat)
    lights = make_light_pack([
        dict(kind="sun", color=(2.2, 2.1, 1.9), direction=(-0.4, -1.0, -0.2), radius=0.05),
        dict(kind="quad", color=(6.0, 6.0, 6.0), position=(0.0, 1.6, 0.0),
             direction=(0.0, -1.0, 0.0), size=(0.8, 0.8)),
    ])
    mat_table = make_material_table(mats)
    scene = DeviceScene(
        tris=pack, cones=empty_cone_pack(), materials=mat_table, lights=lights,
        env=Environment(color=torch.tensor([0.25, 0.3, 0.4]),
                        ambient=torch.tensor([0.05, 0.05, 0.05])),
        textures=build_atlas([tex]), tex_slots=("diffuse",), has_hair=False,
        bsdfs_present=scene_bsdfs_present(mat_table))
    cam = make_camera(position=(0.0, 0.9, 1.8), look_at=(0.0, -0.1, -1.0),
                      up=(0.0, 1.0, 0.0), resolution=resolution, device=device)
    return to_device(scene, device), cam


def fur_patch(resolution=(256, 256), fibers_per_face=5, fiber_verts=10,
              fiber_radius=0.004, bsdf="MarschnerHairBSDF", seed=0,
              patch_halfsize=0.5, device="cuda"):
    """Fur skin patch: a 2-triangle ground plane and grown fibers as cone
    chains (the Fur_SmallSkinPatch default workload, Demo/main.cpp:207,235).

    Returns (DeviceScene, Camera) on `device`."""
    s = patch_halfsize
    ground = _quad((-s, 0.0, -s), (-s, 0.0, s), (s, 0.0, s), (s, 0.0, -s))
    v = np.asarray(ground, np.float32)

    skin = dict(name="skin", diffuse=(0.35, 0.25, 0.18), bsdf=BSDF_LAMBERT)
    # fur material defaults from CPU_Scene.cpp:115-117 (brown, ior 1.55)
    fur_mat = dict(name="Fiber_Mat", diffuse=(0.545, 0.353, 0.169), ior=1.55, bsdf=bsdf)
    pack = make_triangle_pack(v[:, 0], v[:, 1], v[:, 2], mat_id=np.zeros(len(ground)))

    faces = np.stack([v[:, 0], v[:, 1], v[:, 2]], axis=1)
    fibers = mesh_mod.grow_fur_fibers(faces, fibers_per_face, fiber_verts, fiber_radius,
                                      seed=seed)
    base, apex, r0, r1 = mesh_mod.fibers_to_cone_chain(fibers)
    cones = make_cone_pack(base, apex, r0, r1, np.ones(base.shape[0]))

    lights = make_light_pack([
        dict(kind="point", color=(10.0, 10.0, 10.0), position=(0.6, 1.2, 0.8),
             radius=0.05, const_att=1.0),
        dict(kind="sun", color=(1.5, 1.4, 1.2), direction=(-0.4, -1.0, -0.3), radius=0.05),
    ])
    mat_table = make_material_table([skin, fur_mat])
    scene = DeviceScene(
        tris=pack, cones=cones, materials=mat_table, lights=lights,
        env=Environment(color=torch.tensor([0.05, 0.06, 0.08]),
                        ambient=torch.tensor([0.08, 0.08, 0.08])),
        has_hair=scene_has_hair(mat_table), bsdfs_present=scene_bsdfs_present(mat_table))
    cam = make_camera(position=(0.0, 0.45, 1.1), look_at=(0.0, -0.35, -1.0),
                      up=(0.0, 1.0, 0.0), resolution=resolution, device=device)
    return to_device(scene, device), cam


def _dirs_from_u(u, xp):
    """Uniform sphere directions from [N,2] uniforms (numpy or torch)."""
    phi = 2.0 * np.pi * u[:, 0]
    cos_t = 2.0 * u[:, 1] - 1.0
    if xp is np:
        sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t ** 2))
    else:
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
    return xp.stack([sin_t * xp.cos(phi), cos_t, sin_t * xp.sin(phi)], -1)


def _hair_ball_cones_on_device(n_fibers, fiber_verts, fiber_radius, sphere_radius, seed,
                               device, lean: float = 0.25):
    """The fiber cone pack generated on `device` from the threefry draws of
    the JAX package's `_hair_ball_draws` (split key -> [N,2] sphere
    uniforms, [N,3] gaussian lean)."""
    ku, kl = rng.split(rng.key(seed, device), 2)
    u = rng.uniform(ku, (n_fibers, 2))
    lean_raw = rng.normal(kl, (n_fibers, 3)) * lean
    dirs = _dirs_from_u(u, torch)
    fibers = mesh_mod.grow_fur_fibers_along_torch(dirs * sphere_radius, dirs, lean_raw,
                                                  fiber_verts, fiber_radius)
    b, a, r0, r1 = mesh_mod.fibers_to_cone_chain(fibers)
    return make_cone_pack_torch(b, a, r0, r1, torch.ones(b.shape[0], dtype=torch.int32,
                                                          device=device))


def hair_ball(resolution=(512, 512), n_fibers=10000, fiber_verts=10, fiber_radius=0.004,
              sphere_radius=0.5, bsdf="MarschnerHairBSDF", seed=0, on_device=False,
              device="cuda"):
    """Hair ball (bench config 5): a UV-sphere scalp of 768 triangles and
    radially grown fibers as cone chains, a quad light and a sun.

    on_device=False grows the fibers on the host in numpy, bit-identical to
    the JAX package; on_device=True grows them on `device` from the ported
    threefry draws (another stream than numpy's, so other geometry at the
    same seed). Returns (DeviceScene, Camera) on `device`."""
    rs = np.random.RandomState(seed)
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

    if on_device:
        cones = _hair_ball_cones_on_device(n_fibers, fiber_verts, fiber_radius,
                                           sphere_radius, seed, device)
    else:
        dirs = _dirs_from_u(rs.rand(n_fibers, 2), np)
        fibers = mesh_mod.grow_fur_fibers_along(dirs * sphere_radius, dirs, fiber_verts,
                                                fiber_radius, seed=seed)
        base, apex, r0, r1 = mesh_mod.fibers_to_cone_chain(fibers)
        cones = make_cone_pack(base, apex, r0, r1, np.ones(base.shape[0]))

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
