"""Flattened scene: dataclasses of tensors.

Counterpart of `ba_pathtracing_fur_tpu/scene/types.py`: the same ids and
flag bits, and the same pack layouts. Packs are built on the host with
numpy (`make_*`) and moved to a device in one call (`to_device`); the hair
ball's cone pack is built on its device (`make_cone_pack_torch`).
`scene_from_numpy` reads a host-built JAX-package scene field by field,
BVHs and texture atlas included, so both packages can render the very same
scene; like every entry point of the port it puts its tensors on the card
unless the caller asks for another device.

BSDF ids: 0 Lambert, 1 specular reflection, 2 specular transmission,
3 glossy, 4 glass, 5 milk glass, 6 Lambert transmission, 7 emission,
8 transparent, 9 Marschner hair, 10 d'Eon hair.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from .texture import TextureAtlas

if TYPE_CHECKING:
    from ..ops.bvh import BVH

BSDF_LAMBERT = 0
BSDF_SPECULAR_REFLECTION = 1
BSDF_SPECULAR_TRANSMISSION = 2
BSDF_GLOSSY = 3
BSDF_GLASS = 4
BSDF_MILK_GLASS = 5
BSDF_LAMBERT_TRANSMISSION = 6
BSDF_EMISSION = 7
BSDF_TRANSPARENT = 8
BSDF_MARSCHNER_HAIR = 9
BSDF_DEON_HAIR = 10

BSDF_NAMES = {
    "LambertianReflectionBSDF": BSDF_LAMBERT,
    "SpecularReflectionBSDF": BSDF_SPECULAR_REFLECTION,
    "SpecularTransmissionBSDF": BSDF_SPECULAR_TRANSMISSION,
    "GlossyBSDF": BSDF_GLOSSY,
    "GlassBSDF": BSDF_GLASS,
    "MilkGlassBSDF": BSDF_MILK_GLASS,
    "LambertianTransmissionBSDF": BSDF_LAMBERT_TRANSMISSION,
    "EmissionBSDF": BSDF_EMISSION,
    "TransparentBSDF": BSDF_TRANSPARENT,
    "MarschnerHairBSDF": BSDF_MARSCHNER_HAIR,
    "DEonHairBSDF": BSDF_DEON_HAIR,
}

BSDF_ID_TO_NAME = {v: k for k, v in BSDF_NAMES.items()}

SHADER_SIMPLE = 0
SHADER_MARSCHNER_HAIR = 1
SHADER_NAMES = {"SimpleShader": SHADER_SIMPLE, "MarschnerHairShader": SHADER_MARSCHNER_HAIR}

# Material-flag bits (BSDFHelper, Bsdf.h:18-22).
MATFLAG_TRANSPARENT_BOUNCE = 1 << 0
MATFLAG_SPECULAR_BOUNCE = 1 << 1
MATFLAG_EMISSIVE_BOUNCE = 1 << 2
MATFLAG_CYLINDER_T_BOUNCE = 1 << 3
MATFLAG_CYLINDER_TR_BOUNCE = 1 << 4

# Light kinds (Light.h:22-275).
LIGHT_POINT = 0
LIGHT_QUAD = 1
LIGHT_SPOT = 2
LIGHT_SUN = 3

# Environment kinds (Environment.h:18-100).
ENV_COLOR = 0
ENV_SPHERE_MAP = 1
ENV_CUBE_MAP = 2

TEXTURE_SLOTS = ("diffuse", "specular", "volume", "emission",
                 "transparency", "roughness", "normal", "bump")


def _to(obj, device):
    """Copy of a dataclass with every tensor field moved to `device`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass
class TrianglePack:
    """[T] triangles with vertex normals, uvs and a fiber frame."""

    v0: torch.Tensor  # [T,3]
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor  # [T,3] vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # [T,2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor  # [T] int32
    fiber_u: torch.Tensor  # [T,3]
    fiber_v: torch.Tensor
    fiber_w: torch.Tensor

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass
class ConePack:
    """[F] fur-fiber cones with the Cylinder-ctor local frame (u, v, w)."""

    base: torch.Tensor  # [F,3]
    apex: torch.Tensor
    r_base: torch.Tensor  # [F]
    r_apex: torch.Tensor
    u: torch.Tensor  # [F,3]
    v: torch.Tensor
    w: torch.Tensor
    slope: torch.Tensor  # [F]
    height: torch.Tensor
    base_d: torch.Tensor
    min_d: torch.Tensor
    max_d: torch.Tensor
    mat_id: torch.Tensor  # [F] int32

    @property
    def count(self) -> int:
        return self.base.shape[0]


@dataclasses.dataclass
class MaterialTable:
    """[M] dense material parameters (Material.h:60-83); texture slots are
    atlas indices, -1 = none."""

    diffuse: torch.Tensor  # [M,3]
    specular: torch.Tensor
    volume: torch.Tensor
    emission: torch.Tensor
    ior: torch.Tensor  # [M]
    transparency: torch.Tensor
    reflectivity: torch.Tensor
    roughness: torch.Tensor
    bsdf_id: torch.Tensor  # [M] int32
    shader_id: torch.Tensor  # [M] int32
    hair_alpha: torch.Tensor  # [M] degrees
    hair_beta: torch.Tensor  # [M] degrees
    diffuse_tex: torch.Tensor  # [M] int32
    specular_tex: torch.Tensor
    volume_tex: torch.Tensor
    emission_tex: torch.Tensor
    transparency_tex: torch.Tensor
    roughness_tex: torch.Tensor
    normal_tex: torch.Tensor
    bump_tex: torch.Tensor

    @property
    def count(self) -> int:
        return self.ior.shape[0]


@dataclasses.dataclass
class LightPack:
    """[L] lights of all four kinds in one table (Light.h/Light.cpp)."""

    kind: torch.Tensor  # [L] int32
    color: torch.Tensor  # [L,3]
    position: torch.Tensor  # [L,3]
    direction: torch.Tensor  # [L,3] normalized
    radius: torch.Tensor  # [L]
    const_att: torch.Tensor
    lin_att: torch.Tensor
    quad_att: torch.Tensor
    verts: torch.Tensor  # [L,4,3] quad corners (zeros otherwise)
    size: torch.Tensor  # [L,2]
    inner_angle: torch.Tensor  # [L] degrees (spot)
    outer_angle: torch.Tensor

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass
class Environment:
    """Background + ambient; `texture` is None for a constant colour."""

    kind: int = ENV_COLOR
    color: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(3))
    ambient: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(3))
    texture: Optional[torch.Tensor] = None


@dataclasses.dataclass
class DeviceScene:
    tris: TrianglePack
    cones: ConePack
    materials: MaterialTable
    lights: LightPack
    env: Environment
    textures: Optional[TextureAtlas] = None  # the scene's texture atlas, or None
    # any material routes to the hair shader (True is always safe)
    has_hair: bool = True
    # sorted tuple of the surface bsdf ids in the table; () = evaluate all
    bsdfs_present: tuple = ()
    # the material slots textured in this scene (a subset of TEXTURE_SLOTS):
    # only these pay the bilinear fetch in models/bsdf.gather_materials
    tex_slots: tuple = ()
    tri_bvh: Optional["BVH"] = None  # ops/bvh.BVH over the (reordered) triangles
    cone_bvh: Optional["BVH"] = None  # ops/bvh.BVH over the (reordered) cones

    @property
    def device(self) -> torch.device:
        return self.tris.v0.device


def scene_bsdfs_present(materials: MaterialTable) -> tuple:
    """Sorted tuple of the distinct bsdf ids in the table."""
    return tuple(sorted(int(b) for b in torch.unique(materials.bsdf_id.cpu())))


def scene_has_hair(materials: MaterialTable) -> bool:
    """Whether any material routes to the hair shader."""
    return bool((materials.shader_id.cpu() == SHADER_MARSCHNER_HAIR).any())


def to_device(scene: DeviceScene, device) -> DeviceScene:
    """The scene with every pack and BVH on `device`."""
    return dataclasses.replace(
        scene, tris=_to(scene.tris, device), cones=_to(scene.cones, device),
        materials=_to(scene.materials, device), lights=_to(scene.lights, device),
        env=_to(scene.env, device),
        textures=None if scene.textures is None else scene.textures.to(device),
        tri_bvh=None if scene.tri_bvh is None else _to(scene.tri_bvh, device),
        cone_bvh=None if scene.cone_bvh is None else _to(scene.cone_bvh, device))


# ---------------------------------------------------------------------------
# Builders (host-side numpy, then one tensor per field)
# ---------------------------------------------------------------------------

def _f32(x, shape=None) -> torch.Tensor:
    a = np.asarray(x, dtype=np.float32)
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(a))


def _i32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.int32).reshape(-1)))


def make_triangle_pack(v0, v1, v2, n0=None, n1=None, n2=None, uv0=None,
                       uv1=None, uv2=None, mat_id=None, fiber_u=None,
                       fiber_v=None, fiber_w=None) -> TrianglePack:
    v0, v1, v2 = (np.asarray(v, np.float32).reshape(-1, 3) for v in (v0, v1, v2))
    t = v0.shape[0]
    if n0 is None:
        # face normals from the winding
        fn = np.cross(v1 - v0, v2 - v0)
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
        n0 = n1 = n2 = fn
    zeros2 = np.zeros((t, 2), np.float32)
    frame = np.tile(np.eye(3, dtype=np.float32)[None], (t, 1, 1))

    def opt(x, default):
        return default if x is None else x

    return TrianglePack(
        v0=_f32(v0), v1=_f32(v1), v2=_f32(v2),
        n0=_f32(n0, (-1, 3)), n1=_f32(n1, (-1, 3)), n2=_f32(n2, (-1, 3)),
        uv0=_f32(opt(uv0, zeros2), (-1, 2)), uv1=_f32(opt(uv1, zeros2), (-1, 2)),
        uv2=_f32(opt(uv2, zeros2), (-1, 2)),
        mat_id=_i32(opt(mat_id, np.zeros(t))),
        fiber_u=_f32(opt(fiber_u, frame[:, 0]), (-1, 3)),
        fiber_v=_f32(opt(fiber_v, frame[:, 1]), (-1, 3)),
        fiber_w=_f32(opt(fiber_w, frame[:, 2]), (-1, 3)))


def empty_triangle_pack() -> TrianglePack:
    z3 = _f32(np.zeros((0, 3)))
    z2 = _f32(np.zeros((0, 2)))
    return TrianglePack(v0=z3, v1=z3, v2=z3, n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
                        mat_id=_i32(np.zeros((0,))), fiber_u=z3, fiber_v=z3, fiber_w=z3)


def make_cone_pack(base, apex, r_base, r_apex, mat_id) -> ConePack:
    """The per-cone local frame exactly as Cylinder's ctor builds it
    (Cylinder.cpp:5-43), for untransformed fibers, in host float32 numpy as
    the JAX package does it. w = normalize(cross(u, v)) is the invariant the
    packed traversal relies on."""
    base = np.asarray(base, np.float32).reshape(-1, 3)
    apex = np.asarray(apex, np.float32).reshape(-1, 3)
    r_base = np.asarray(r_base, np.float32).reshape(-1)
    r_apex = np.asarray(r_apex, np.float32).reshape(-1)
    local_v = apex - base
    height = np.maximum(np.linalg.norm(local_v, axis=-1), 1e-12)
    v = local_v / height[:, None]
    tmp = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (base.shape[0], 1))
    degenerate = 1.0 - np.abs(np.sum(tmp * v, axis=-1)) < 1e-4
    tmp[degenerate] = np.array([0.0, 0.0, 1.0], np.float32)
    u = np.cross(v, tmp)
    u /= np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
    w = np.cross(u, v)
    w /= np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
    slope = (r_base - r_apex) / height
    base_d = np.sum(base * v, axis=-1)
    apex_d = np.sum(apex * v, axis=-1)
    return ConePack(
        base=_f32(base), apex=_f32(apex), r_base=_f32(r_base), r_apex=_f32(r_apex),
        u=_f32(u), v=_f32(v), w=_f32(w), slope=_f32(slope), height=_f32(height),
        base_d=_f32(base_d), min_d=_f32(np.minimum(base_d, apex_d)),
        max_d=_f32(np.maximum(base_d, apex_d)), mat_id=_i32(mat_id))


def make_cone_pack_torch(base, apex, r_base, r_apex, mat_id) -> ConePack:
    """`make_cone_pack` on tensors, on their device (the JAX package's
    `make_cone_pack_jnp`): the same Cylinder-ctor frame and w invariant in
    float32 torch ops, so an on-card fiber pack never passes the host."""
    def norm(x):
        return torch.sqrt((x * x).sum(-1, keepdim=True))

    local_v = apex - base
    height = torch.clamp(norm(local_v)[:, 0], min=1e-12)
    v = local_v / height[:, None]
    up = torch.tensor([0.0, 1.0, 0.0], device=base.device)
    zax = torch.tensor([0.0, 0.0, 1.0], device=base.device)
    degenerate = (1.0 - v[:, 1].abs()) < 1e-4  # dot(up, v) = v.y
    tmp = torch.where(degenerate[:, None], zax, up)
    u = torch.linalg.cross(v, tmp)
    u = u / torch.clamp(norm(u), min=1e-12)
    w = torch.linalg.cross(u, v)
    w = w / torch.clamp(norm(w), min=1e-12)
    base_d = (base * v).sum(-1)
    apex_d = (apex * v).sum(-1)
    return ConePack(
        base=base.contiguous(), apex=apex.contiguous(), r_base=r_base.contiguous(),
        r_apex=r_apex.contiguous(), u=u, v=v, w=w, slope=(r_base - r_apex) / height,
        height=height, base_d=base_d, min_d=torch.minimum(base_d, apex_d),
        max_d=torch.maximum(base_d, apex_d),
        mat_id=torch.as_tensor(mat_id, dtype=torch.int32, device=base.device))


def empty_cone_pack() -> ConePack:
    z3 = _f32(np.zeros((0, 3)))
    z1 = _f32(np.zeros((0,)))
    return ConePack(base=z3, apex=z3, r_base=z1, r_apex=z1, u=z3, v=z3, w=z3,
                    slope=z1, height=z1, base_d=z1, min_d=z1, max_d=z1,
                    mat_id=_i32(np.zeros((0,))))


def make_material_table(materials: list[dict]) -> MaterialTable:
    """From a list of dicts with Material.h-default fallbacks."""

    def vec(k, d):
        return np.stack([np.asarray(m.get(k, d), np.float32)[:3] for m in materials]) \
            if materials else np.zeros((0, 3), np.float32)

    def f(k, d):
        return np.asarray([m.get(k, d) for m in materials], np.float32)

    def resolve_bsdf(m):
        b = m.get("bsdf", BSDF_LAMBERT)
        return BSDF_NAMES[b] if isinstance(b, str) else int(b)

    def resolve_shader(m):
        s = m.get("shader")
        if s is None:
            hair = resolve_bsdf(m) in (BSDF_MARSCHNER_HAIR, BSDF_DEON_HAIR)
            return SHADER_MARSCHNER_HAIR if hair else SHADER_SIMPLE
        return SHADER_NAMES[s] if isinstance(s, str) else int(s)

    return MaterialTable(
        diffuse=_f32(vec("diffuse", (1, 1, 1))), specular=_f32(vec("specular", (1, 1, 1))),
        volume=_f32(vec("volume", (1, 1, 1))), emission=_f32(vec("emission", (0, 0, 0))),
        ior=_f32(f("ior", 1.52)), transparency=_f32(f("transparency", 0.0)),
        reflectivity=_f32(f("reflectivity", 0.0)), roughness=_f32(f("roughness", 1.0)),
        bsdf_id=_i32([resolve_bsdf(m) for m in materials]),
        shader_id=_i32([resolve_shader(m) for m in materials]),
        hair_alpha=_f32(f("hair_alpha", -7.5)), hair_beta=_f32(f("hair_beta", 7.5)),
        **{f"{slot}_tex": _i32([m.get(f"{slot}_tex", -1) for m in materials])
           for slot in TEXTURE_SLOTS})


def make_light_pack(lights: list[dict]) -> LightPack:
    """Lights from dicts: kind point|quad|spot|sun plus per-kind parameters.
    Quad corners follow QuadLight::calcParams (Light.cpp:263-276)."""
    kinds = {"point": LIGHT_POINT, "quad": LIGHT_QUAD, "spot": LIGHT_SPOT, "sun": LIGHT_SUN}

    def one(li):
        kind = li["kind"] if isinstance(li["kind"], int) else kinds[li["kind"]]
        color = np.asarray(li.get("color", (1, 1, 1)), np.float32)[:3]
        pos = np.asarray(li.get("position", (0, 0, 0)), np.float32)
        direction = np.asarray(li.get("direction", (0, -1, 0)), np.float32)
        nd = np.linalg.norm(direction)
        direction = direction / nd if nd > 0 else np.array([1.0, 0, 0], np.float32)
        radius = float(li.get("radius", 0.0))
        size = np.asarray(li.get("size", (1.0, 1.0)), np.float32)
        verts = np.zeros((4, 3), np.float32)
        if kind == LIGHT_QUAD:
            nrm = direction
            s = (np.array([-nrm[2], 0, nrm[0]]) / np.sqrt(max(nrm[0] ** 2 + nrm[2] ** 2, 1e-12))
                 if abs(nrm[0]) > abs(nrm[1]) else
                 np.array([0, nrm[2], -nrm[1]]) / np.sqrt(max(nrm[1] ** 2 + nrm[2] ** 2, 1e-12)))
            t = np.cross(nrm, s)
            verts[0] = pos - s * size[0] / 2 - t * size[1] / 2
            verts[1] = pos + s * size[0] / 2 - t * size[1] / 2
            verts[2] = pos + s * size[0] / 2 + t * size[1] / 2
            verts[3] = pos - s * size[0] / 2 + t * size[1] / 2
            radius = float(np.sqrt(size[0] * size[1] / np.pi))
        return (kind, color, pos, direction, radius,
                float(li.get("const_att", 1.0)), float(li.get("lin_att", 0.0)),
                float(li.get("quad_att", 0.0)), verts, size,
                float(li.get("inner_angle", 30.0)), float(li.get("outer_angle", 45.0)))

    rows = [one(li) for li in lights]
    if not rows:
        z1, z3 = np.zeros((0,)), np.zeros((0, 3))
        return LightPack(kind=_i32(z1), color=_f32(z3), position=_f32(z3),
                         direction=_f32(z3), radius=_f32(z1), const_att=_f32(z1),
                         lin_att=_f32(z1), quad_att=_f32(z1),
                         verts=_f32(np.zeros((0, 4, 3))), size=_f32(np.zeros((0, 2))),
                         inner_angle=_f32(z1), outer_angle=_f32(z1))
    cols = list(zip(*rows))
    return LightPack(
        kind=_i32(cols[0]), color=_f32(np.stack(cols[1])), position=_f32(np.stack(cols[2])),
        direction=_f32(np.stack(cols[3])), radius=_f32(cols[4]), const_att=_f32(cols[5]),
        lin_att=_f32(cols[6]), quad_att=_f32(cols[7]), verts=_f32(np.stack(cols[8])),
        size=_f32(np.stack(cols[9])), inner_angle=_f32(cols[10]), outer_angle=_f32(cols[11]))


def _read_fields(cls, obj):
    """Build `cls` from the same-named fields of a JAX-package pack."""
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(getattr(obj, f.name))
        out[f.name] = _i32(a) if a.dtype.kind in "iu" else _f32(a)
    return cls(**out)


def _read_bvh(bvh):
    """The port's BVH from a JAX-package one: the heap boxes, the slot
    permutation and the packed leaf geometry, as numpy -> tensors."""
    from ..ops.bvh import BVH

    if bvh is None:
        return None
    return BVH(bmin=_f32(bvh.bmin), bmax=_f32(bvh.bmax), perm=_i32(bvh.perm),
               packed=None if bvh.packed is None else _f32(bvh.packed),
               n_leaves=int(bvh.n_leaves), leaf_size=int(bvh.leaf_size),
               fanout=int(bvh.fanout))


def _read_atlas(textures) -> Optional[TextureAtlas]:
    """The port's atlas from a JAX-package one: a `TextureAtlas(images,
    sizes)`, a bare `[NT, H, W, C]` array (addressed at the atlas' own size)
    or None."""
    if textures is None:
        return None
    if hasattr(textures, "images"):
        return TextureAtlas(images=_f32(textures.images),
                            sizes=torch.from_numpy(np.ascontiguousarray(
                                np.asarray(textures.sizes, dtype=np.int32).reshape(-1, 2))))
    return TextureAtlas(images=_f32(textures), sizes=None)


def scene_from_numpy(scene, device="cuda") -> DeviceScene:
    """Read a JAX-package `DeviceScene` field by field, BVHs and texture
    atlas included (with the port's kernel layouts made on `device`), into
    the port's scene on `device` (the card unless the caller asks for
    another). The JAX object is passed in, so no jax import is needed."""
    from ..ops.traverse import kernel_layouts

    env = scene.env
    out = DeviceScene(
        tris=_read_fields(TrianglePack, scene.tris),
        cones=_read_fields(ConePack, scene.cones),
        materials=_read_fields(MaterialTable, scene.materials),
        lights=_read_fields(LightPack, scene.lights),
        env=Environment(kind=int(env.kind), color=_f32(env.color, (3,)),
                        ambient=_f32(env.ambient, (3,)),
                        texture=None if env.texture is None else _f32(env.texture)),
        textures=_read_atlas(scene.textures), tex_slots=tuple(scene.tex_slots),
        has_hair=bool(scene.has_hair), bsdfs_present=tuple(scene.bsdfs_present),
        tri_bvh=_read_bvh(scene.tri_bvh), cone_bvh=_read_bvh(scene.cone_bvh))
    out = to_device(out, device)
    return dataclasses.replace(
        out, tri_bvh=kernel_layouts(out.tri_bvh, "tri", out.tris),
        cone_bvh=kernel_layouts(out.cone_bvh, "cone", out.cones))
