"""Built-in validation scenes.

Counterpart of `ba_pathtracing_fur_tpu/scene/builtins.py`. Only the Cornell
box is ported so far; the fur patch, terrain and hair ball follow with the
fur slice (ROADMAP M3/M9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import make_camera
from .types import (
    BSDF_GLASS, BSDF_LAMBERT, BSDF_SPECULAR_REFLECTION, DeviceScene, Environment,
    empty_cone_pack, make_light_pack, make_material_table, make_triangle_pack,
    scene_bsdfs_present, to_device,
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
                device=None):
    """Cornell box. variant: 'diffuse' | 'glossy' (mirror + glass boxes).

    Returns (DeviceScene, Camera) on `device` (host tensors by default)."""
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
    return (scene if device is None else to_device(scene, device)), cam
