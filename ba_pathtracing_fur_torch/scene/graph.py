"""Host-side scene graph: a transform tree flattened into a DeviceScene.

Counterpart of `ba_pathtracing_fur_tpu/scene/graph.py` (KIRK::SceneGraph /
SceneNode, SceneGraph.{h,cpp}, SceneNode.{h,cpp}, and the CPU::Scene
flattener, CPU_Scene.cpp:73-230): an N-ary TRS tree with typed payloads
(MESH/LIGHT/CAMERA/EMPTY, SceneNode.h:42) that flattens into world-space
triangle packs, fur fibers as cone chains (CPU_Scene.cpp:104-145) or
triangle tubes (fiberToTriangles, :232-345), the lights and the active
camera.

Everything up to the packs is the JAX package's numpy, call for call, so
both packages flatten a graph to the same bits; the packs, the material
and light tables and the texture atlas then go to the device in one
`to_device` at the end of `flatten`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.camera import Camera, make_camera
from . import mesh as mesh_mod
from .types import (
    DeviceScene, Environment, empty_cone_pack, empty_triangle_pack, make_cone_pack,
    make_light_pack, make_material_table, make_triangle_pack, scene_bsdfs_present,
    scene_has_hair, to_device,
)

EMPTY, MESH, LIGHT, CAMERA = "empty", "mesh", "light", "camera"


@dataclasses.dataclass
class HostMesh:
    """KIRK::Mesh (Mesh.h:28-66): indexed geometry, material slots and
    optional fur fibers."""

    vertices: np.ndarray  # [V,3]
    faces: np.ndarray  # [F,3] int vertex indices
    normals: Optional[np.ndarray] = None  # [V,3]
    uvs: Optional[np.ndarray] = None  # [V,2]
    face_material: Optional[np.ndarray] = None  # [F] local material slot
    material_ids: Optional[List[int]] = None  # slot -> scene material index
    # the mesh file's per-slot material dicts (.mtl), used when the node
    # names no material_ids (createMeshFromAi, SceneGraph.cpp:145-180)
    material_defs: Optional[List[dict]] = None
    fur: Optional[mesh_mod.FurFibers] = None
    fur_material_id: Optional[int] = None
    name: str = "mesh"

    def compute_smooth_normals(self) -> None:
        """Area-weighted vertex normals (aiProcess_GenSmoothNormals,
        SceneGraph.cpp:199)."""
        v, f = self.vertices, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, f[:, k], fn)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        self.normals = (n / np.maximum(ln, 1e-12)).astype(np.float32)

    def add_fur_to_faces(self, fibers_per_face: int, fiber_verts: int, fiber_radius: float,
                         seed: int = 0) -> None:
        """Mesh::addFurToFaces (Mesh.cpp:82-148)."""
        corners = self.vertices[self.faces]  # [F,3,3]
        self.fur = mesh_mod.grow_fur_fibers(corners, fibers_per_face, fiber_verts,
                                            fiber_radius, seed)


@dataclasses.dataclass
class LightDesc:
    kind: str = "point"  # point|quad|spot|sun
    color: tuple = (1.0, 1.0, 1.0)
    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, -1.0, 0.0)
    radius: float = 0.0
    size: tuple = (1.0, 1.0)
    const_att: float = 1.0
    lin_att: float = 0.0
    quad_att: float = 0.0
    inner_angle: float = 30.0
    outer_angle: float = 45.0
    name: str = "light"


@dataclasses.dataclass
class CameraDesc:
    position: tuple = (0.0, 0.0, 0.0)
    # the view direction ("look_at" in files is a point; the loader takes
    # the difference, jsonin.cpp:492-495)
    direction: tuple = (0.0, 0.0, -1.0)
    up: tuple = (0.0, 1.0, 0.0)
    resolution: tuple = (512, 512)
    sensor_size: tuple = (0.036, 0.024)
    focal_length: float = 0.0415
    f_stop: float = 1.8
    focus_distance: float = 11.0
    use_dof: bool = False
    name: str = "camera"


def trs_matrix(translation=(0, 0, 0), rotation=(1, 0, 0, 0), scale=(1, 1, 1)) -> np.ndarray:
    """A node's transform R * (T scaled), as jsonin builds it
    (jsonin.cpp:158-160): rotMatrix * scale(translate(I, t), s); rotation
    is a (w, x, y, z) quaternion."""
    w, x, y, z = np.asarray(rotation, np.float64)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n > 0:
        w, x, y, z = w / n, x / n, y / n, z / n
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), 0],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), 0],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), 0],
        [0, 0, 0, 1]], np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = translation
    s = np.diag(list(scale) + [1.0]).astype(np.float32)
    return rot @ (t @ s)


class SceneNode:
    """SceneNode.h:20-60: a transform, a typed payload and children."""

    def __init__(self, data=None, data_type: str = EMPTY, transform=None, name: str = "node"):
        self.data = data
        self.data_type = data_type
        self.transform = (np.eye(4, dtype=np.float32) if transform is None
                          else np.asarray(transform, np.float32))
        self.children: List["SceneNode"] = []
        self.name = name

    def attach(self, child: "SceneNode") -> "SceneNode":
        self.children.append(child)
        return child


class SceneGraph:
    """SceneGraph.h:30-80."""

    def __init__(self):
        self.root = SceneNode(name="root")
        self.active_camera: Optional[CameraDesc] = None
        self.environment: dict = {"color": (0.0, 0.0, 0.0), "ambient": (0.0, 0.0, 0.0)}
        self.materials: List[dict] = []
        # the fur growth parameters (the "Fur" JSON section), kept so that
        # save_scene_json writes them back
        self.fur: Optional[dict] = None

    def nodes(self):
        """Depth-first (node, world transform) pairs (SceneNodeIterator)."""
        stack = [(self.root, np.eye(4, dtype=np.float32))]
        while stack:
            node, xf = stack.pop()
            world = xf @ node.transform
            yield node, world
            for c in node.children:
                stack.append((c, world))

    def meshes(self):
        for node, world in self.nodes():
            if node.data_type == MESH:
                yield node.data, world

    def add_default_light(self):
        """createDefaultLight (SceneGraph.cpp:278-287)."""
        self.root.attach(SceneNode(LightDesc(kind="point", position=(0.0, 4.0, 0.0),
                                             color=(1.0, 1.0, 1.0), radius=2.0), LIGHT))

    def add_fur_fibers_to_all_meshes(self, fibers_per_face: int, fiber_verts: int,
                                     fiber_radius: float, seed: int = 0) -> None:
        """SceneGraph::addFurFibersToAllMeshes (SceneGraph.cpp:315-321)."""
        self.fur = dict(fibers_per_face=fibers_per_face, fiber_verts=fiber_verts,
                        radius=fiber_radius, seed=seed)
        for m, _ in self.meshes():
            m.add_fur_to_faces(fibers_per_face, fiber_verts, fiber_radius, seed)


# ---------------------------------------------------------------------------
# Flattener (CPU::Scene)
# ---------------------------------------------------------------------------

#: the fur material's defaults (CPU_Scene.cpp:115-117)
FUR_MATERIAL = dict(name="Fiber_Mat", diffuse=(0.545, 0.353, 0.169), ior=1.55,
                    bsdf="MarschnerHairBSDF")

#: slots whose images are display-encoded (decoded sRGB -> linear at load,
#: as the JAX package does; the reference samples the bytes raw); the
#: other slots are data maps, read linearly
_COLOR_SLOTS = ("diffuse", "specular", "volume", "emission")


def _resolve_material_textures(materials: list) -> tuple:
    """Load every `{slot}_map` image the material dicts name (a file path or
    an in-memory [H,W,C] array) into one TextureAtlas and write each
    `{slot}_tex` atlas index into its dict: the load-time half of
    Material::fetchParameterColor (Material.h:60-78). -> (TextureAtlas on
    the CPU or None, the textured slots)."""
    from ..utils import film
    from .texture import build_atlas
    from .types import TEXTURE_SLOTS

    images: list = []
    index: dict = {}  # cache key -> atlas index
    used: set = set()

    def load(value, gamma: float):
        if isinstance(value, str):
            key = (value, gamma)
            if key not in index:
                img = film.read_image(value, gamma)
                if img is None:
                    return None
                index[key] = len(images)
                images.append(img)
            return index[key]
        key = (id(value), gamma)
        if key not in index:
            index[key] = len(images)
            images.append(np.asarray(value, np.float32))
        return index[key]

    for m in materials:
        for slot in TEXTURE_SLOTS:
            val = m.get(f"{slot}_map")
            if val is None:
                continue
            gamma = 2.2 if slot in _COLOR_SLOTS else 1.0
            idx = load(val, gamma)
            if idx is not None:
                m[f"{slot}_tex"] = idx
                used.add(slot)
    if not images:
        return None, ()
    return build_atlas(images), tuple(s for s in TEXTURE_SLOTS if s in used)


def flatten(graph: SceneGraph, fiber_as_cylinder: bool = True, tube_resolution: int = 5,
            device="cuda") -> tuple[DeviceScene, Optional[Camera]]:
    """CPU::Scene's constructor and flattenNode (CPU_Scene.cpp:11-162):
    world-space primitive packs, fur as cone chains (`fiber_as_cylinder`)
    or triangle tubes of `tube_resolution` sides, the lights, the camera.
    -> (DeviceScene on `device`, Camera on `device` or None); the card
    unless the caller asks for another device."""
    materials = list(graph.materials)
    if not materials:
        materials = [dict(name="default")]

    tri_v0, tri_v1, tri_v2 = [], [], []
    tri_n0, tri_n1, tri_n2 = [], [], []
    tri_uv0, tri_uv1, tri_uv2 = [], [], []
    tri_mat, tri_fu, tri_fv, tri_fw = [], [], [], []
    cone_base, cone_apex, cone_rb, cone_ra, cone_mat = [], [], [], [], []
    lights = []
    fur_mat_id = None

    def world_points(m4, pts):
        return pts @ m4[:3, :3].T + m4[:3, 3]

    def world_normals(m4, ns):
        nm = np.linalg.inv(m4[:3, :3]).T
        out = ns @ nm.T
        return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)

    for node, world in graph.nodes():
        if node.data_type == MESH:
            m: HostMesh = node.data
            if m.normals is None:
                m.compute_smooth_normals()
            v = world_points(world, m.vertices.astype(np.float32))
            n = world_normals(world, m.normals.astype(np.float32))
            f = m.faces
            tri_v0.append(v[f[:, 0]]); tri_v1.append(v[f[:, 1]]); tri_v2.append(v[f[:, 2]])
            tri_n0.append(n[f[:, 0]]); tri_n1.append(n[f[:, 1]]); tri_n2.append(n[f[:, 2]])
            uv = m.uvs if m.uvs is not None else np.zeros((v.shape[0], 2), np.float32)
            tri_uv0.append(uv[f[:, 0]]); tri_uv1.append(uv[f[:, 1]])
            tri_uv2.append(uv[f[:, 2]])
            if m.material_ids is not None:
                slots = m.material_ids
            elif m.material_defs:
                # the mesh file's materials become scene materials, deduped
                # by name across meshes that share a .mtl
                slots = []
                for d in m.material_defs:
                    nm = d.get("name")
                    idx = next((i for i, e in enumerate(materials)
                                if nm and e.get("name") == nm), None)
                    if idx is None:
                        idx = len(materials)
                        materials.append(dict(d))
                    slots.append(idx)
            else:
                slots = [0]
            fm = (m.face_material if m.face_material is not None
                  else np.zeros(len(f), np.int64))
            # a node's material_id list may be shorter than the mesh's slot
            # count (one scene material for all .mtl slots): clamp
            fm = np.minimum(fm, len(slots) - 1)
            tri_mat.append(np.asarray(slots)[fm])
            eye = np.tile(np.eye(3, dtype=np.float32)[None], (len(f), 1, 1))
            tri_fu.append(eye[:, 0]); tri_fv.append(eye[:, 1]); tri_fw.append(eye[:, 2])

            if m.fur is not None:
                if m.fur_material_id is None:
                    if fur_mat_id is None:
                        fur_mat_id = len(materials)
                        materials.append(dict(FUR_MATERIAL))
                    mat_id = fur_mat_id
                else:
                    mat_id = m.fur_material_id
                pos = world_points(world, m.fur.positions.reshape(-1, 3)) \
                    .reshape(m.fur.positions.shape)
                fibers = mesh_mod.FurFibers(pos.astype(np.float32), m.fur.radii)
                if fiber_as_cylinder:
                    b, a, rb, ra = mesh_mod.fibers_to_cone_chain(fibers)
                    cone_base.append(b); cone_apex.append(a)
                    cone_rb.append(rb); cone_ra.append(ra)
                    cone_mat.append(np.full(b.shape[0], mat_id, np.int64))
                else:
                    t0, t1, t2, fu, fv, fw = mesh_mod.fibers_to_triangle_tubes(
                        fibers, tube_resolution)
                    cnt = t0.shape[0]
                    tri_v0.append(t0); tri_v1.append(t1); tri_v2.append(t2)
                    fn = np.cross(t1 - t0, t2 - t0)
                    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
                    tri_n0.append(fn); tri_n1.append(fn); tri_n2.append(fn)
                    z2 = np.zeros((cnt, 2), np.float32)
                    tri_uv0.append(z2); tri_uv1.append(z2); tri_uv2.append(z2)
                    tri_mat.append(np.full(cnt, mat_id, np.int64))
                    tri_fu.append(fu); tri_fv.append(fv); tri_fw.append(fw)

        elif node.data_type == LIGHT:
            li: LightDesc = node.data
            pos = world_points(world, np.asarray([li.position], np.float32))[0]
            dirn = world_normals(world, np.asarray([li.direction], np.float32))[0]
            lights.append(dict(kind=li.kind, color=li.color, position=tuple(pos),
                               direction=tuple(dirn), radius=li.radius, size=li.size,
                               const_att=li.const_att, lin_att=li.lin_att,
                               quad_att=li.quad_att, inner_angle=li.inner_angle,
                               outer_angle=li.outer_angle))
        elif node.data_type == CAMERA and graph.active_camera is None:
            graph.active_camera = node.data

    if tri_v0:
        def cat(xs):
            return np.concatenate([np.asarray(x, np.float32).reshape(len(x), -1) for x in xs],
                                  axis=0)

        tris = make_triangle_pack(
            cat(tri_v0), cat(tri_v1), cat(tri_v2), n0=cat(tri_n0), n1=cat(tri_n1),
            n2=cat(tri_n2), uv0=cat(tri_uv0), uv1=cat(tri_uv1), uv2=cat(tri_uv2),
            mat_id=np.concatenate(tri_mat), fiber_u=cat(tri_fu), fiber_v=cat(tri_fv),
            fiber_w=cat(tri_fw))
    else:
        tris = empty_triangle_pack()

    if cone_base:
        cones = make_cone_pack(np.concatenate(cone_base), np.concatenate(cone_apex),
                               np.concatenate(cone_rb), np.concatenate(cone_ra),
                               np.concatenate(cone_mat))
    else:
        cones = empty_cone_pack()

    env_cfg = graph.environment
    tex = env_cfg.get("texture")
    env = Environment(
        kind=env_cfg.get("kind", 0),
        color=torch.from_numpy(np.asarray(env_cfg.get("color", (0, 0, 0)), np.float32)),
        ambient=torch.from_numpy(np.asarray(env_cfg.get("ambient", (0, 0, 0)), np.float32)),
        texture=None if tex is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(tex, np.float32))))

    atlas, tex_slots = _resolve_material_textures(materials)
    mat_table = make_material_table(materials)
    scene = DeviceScene(tris=tris, cones=cones, materials=mat_table,
                        lights=make_light_pack(lights), env=env, textures=atlas,
                        tex_slots=tex_slots, has_hair=scene_has_hair(mat_table),
                        bsdfs_present=scene_bsdfs_present(mat_table))

    cam = None
    if graph.active_camera is not None:
        cd = graph.active_camera
        cam = make_camera(position=cd.position, look_at=cd.direction, up=cd.up,
                          resolution=tuple(cd.resolution), sensor_size=tuple(cd.sensor_size),
                          focal_length=cd.focal_length, f_stop=cd.f_stop,
                          focus_distance=cd.focus_distance, use_dof=cd.use_dof, device=device)
    return to_device(scene, device), cam
