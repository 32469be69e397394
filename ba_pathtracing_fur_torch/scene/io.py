"""JSON scene I/O: the jsonin/jsonout counterpart.

Counterpart of `ba_pathtracing_fur_tpu/scene/io.py`, line for line: both
packages read a scene file to the same graph and write a graph to the same
bytes. The schema is the reference's (jsonin.cpp:89-600, jsonout.cpp:
14-301), with these top-level sections:

  "Material":    [{name, diffuse, specular, volume, emission, ior,
                   transparency, reflectivity, roughness, bsdf, shader,
                   diffuse_map, ...}, ...]   (bsdf/shader by factory name,
                   jsonin.cpp:468-476; or {"path": "mat.json"})
  "Mesh":        [{path: "model.obj" | "model.ply" | "model.b3df"}, ...]
  "Node":        [{object: empty|camera|light|mesh, object_id, parent_id?,
                   translation, rotation (w,x,y,z quaternion), scale or
                   transform (16 floats), mesh_id/material_id (mesh),
                   kind + light parameters (light), position/direction|
                   look_at/up_vector/resolution (camera), name}, ...]
  "Environment": {color | kind: "cube"/"sphere" + map paths, light: ambient}

and the JAX package's extension "Fur": {fibers_per_face, fiber_verts,
radius, seed} (the reference grows fur in code, Demo/main.cpp:235).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .graph import (
    CAMERA, LIGHT, MESH, CameraDesc, HostMesh, LightDesc, SceneGraph,
    SceneNode, trs_matrix,
)

_LIGHT_KEYS = {"constant": "const_att", "linear": "lin_att",
               "quadratic": "quad_att", "inner": "inner_angle",
               "outer": "outer_angle"}


def _vec(obj, key, default):
    v = obj.get(key)
    return tuple(v) if v is not None else tuple(default)


def _load_mesh_entry(entry: dict, directory: str) -> HostMesh:
    path = entry.get("path", "")
    real = os.path.join(directory, path)
    ext = os.path.splitext(real)[1].lower()
    if ext == ".obj":
        from .obj import load_obj
        return load_obj(real)
    if ext in (".b3df", ".bin"):
        from .binmesh import load_binary_mesh
        return load_binary_mesh(real)
    if ext == ".ply":
        from .ply import load_ply
        return load_ply(real)
    # The reference loads any Assimp format (SceneGraph.cpp:85-139); this
    # build supports OBJ + PLY + its own binary format. Reject anything
    # else loudly instead of misparsing it (e.g. Collada .dae is XML).
    raise ValueError(
        f"unsupported mesh format {ext!r} ({real}): supported are .obj, "
        f".ply and .b3df/.bin — convert Collada/FBX/etc. to OBJ first")


def _parse_light(entry: dict) -> LightDesc:
    kw = dict(kind=entry.get("kind", "point"),
              color=tuple(entry.get("color", (1, 1, 1))[:3]),
              position=_vec(entry, "position", (0, 0, 0)),
              direction=_vec(entry, "direction", (0, -1, 0)),
              radius=float(entry.get("radius", 0.0)),
              size=tuple(entry.get("size", (1.0, 1.0))),
              name=entry.get("name", "light"))
    for src, dst in _LIGHT_KEYS.items():
        if src in entry:
            kw[dst] = float(entry[src])
    return LightDesc(**kw)


def _parse_camera(entry: dict) -> CameraDesc:
    position = _vec(entry, "position", (0, 0, 0))
    direction = _vec(entry, "direction", (0, 0, 0))
    if not any(direction):
        look = _vec(entry, "look_at", (0, 0, 0))
        direction = tuple(np.asarray(look) - np.asarray(position))
    up = _vec(entry, "up_vector", (0, 1, 0))
    cd = CameraDesc(position=position, direction=direction, up=up,
                    name=entry.get("name", "camera"))
    if "resolution" in entry:
        cd.resolution = tuple(entry["resolution"])
    for k in ("focal_length", "f_stop", "focus_distance"):
        if k in entry:
            setattr(cd, k, float(entry[k]))
    return cd


def load_scene_json(path: str) -> SceneGraph:
    """jsonio::makeSceneGraph (jsonin.cpp:89-367)."""
    directory = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        data = json.load(fh)

    graph = SceneGraph()

    # Materials: by-value or by-path indirection (jsonin.cpp:371-386);
    # *_map texture refs (jsonin.cpp:403-465) are resolved to absolute
    # paths here and loaded into the atlas at flatten time.
    from .types import TEXTURE_SLOTS
    for m in data.get("Material", []):
        if "path" in m:
            try:
                with open(os.path.join(directory, m["path"])) as mf:
                    m = json.load(mf)
            except OSError:
                m = {"name": "default"}
        m = dict(m)
        for slot in TEXTURE_SLOTS:
            p = m.get(f"{slot}_map")
            if isinstance(p, str) and p:
                m[f"{slot}_map"] = os.path.join(directory, p)
        graph.materials.append(m)

    meshes = [_load_mesh_entry(e, directory) for e in data.get("Mesh", [])]

    nodes: dict = {}
    for entry in data.get("Node", []):
        kind = entry.get("object", "empty")
        xf = _maybe_load_transform(entry)
        if xf is None:
            xf = trs_matrix(_vec(entry, "translation", (0, 0, 0)),
                            _vec(entry, "rotation", (1, 0, 0, 0)),
                            _vec(entry, "scale", (1, 1, 1)))
        name = entry.get("name", "no_name")
        if kind == "empty":
            node = SceneNode(transform=xf, name=name)
        elif kind == "camera":
            cd = _parse_camera(entry)
            node = SceneNode(cd, CAMERA, transform=xf, name=name)
            graph.active_camera = cd  # last camera wins (jsonin.cpp:216)
        elif kind == "light":
            node = SceneNode(_parse_light(entry), LIGHT, transform=xf, name=name)
        elif kind == "mesh":
            mesh = meshes[int(entry["mesh_id"])]
            if "material_id" in entry:
                # node-level override (jsonin.cpp mesh nodes reference scene
                # materials); absent, the mesh file's own .mtl materials
                # flow through flatten (createMeshFromAi semantics)
                mat_id = entry["material_id"]
                ids = (list(mat_id) if isinstance(mat_id, list)
                       else [int(mat_id)])
                mesh.material_ids = ids
            elif not getattr(mesh, "material_defs", None):
                mesh.material_ids = [0]
            node = SceneNode(mesh, MESH, transform=xf, name=name)
        else:
            raise ValueError(f"unknown node object kind: {kind}")

        parent = nodes.get(entry.get("parent_id"), graph.root)
        parent.attach(node)
        if "object_id" in entry:
            nodes[int(entry["object_id"])] = node

    env = data.get("Environment", {})
    if "color" in env:
        graph.environment["color"] = tuple(env["color"][:3])
    if env.get("kind") == "sphere" and env.get("path"):
        from ..utils import film
        img = film.read_image(os.path.join(directory, env["path"]))
        if img is not None:
            graph.environment["kind"] = 1  # ENV_SPHERE_MAP
            graph.environment["texture"] = np.asarray(img, np.float32)
            graph.environment["texture_paths"] = {
                "path": os.path.join(directory, env["path"])}
    elif env.get("kind") == "cube":
        # six-face cube map (jsonin.cpp:308-328 / Environment::loadCubeMap);
        # shading face order is +x,+y,-z,-x,-y,+z (models/shading.py
        # environment_color side computation)
        from ..utils import film
        keys = ("posx", "posy", "negz", "negx", "negy", "posz")
        faces = [film.read_image(os.path.join(directory, env.get(k, "")))
                 for k in keys]
        if all(f is not None for f in faces):
            h = min(f.shape[0] for f in faces)
            w = min(f.shape[1] for f in faces)
            graph.environment["kind"] = 2  # ENV_CUBE_MAP
            graph.environment["texture"] = np.stack(
                [np.asarray(f[:h, :w], np.float32) for f in faces])
            graph.environment["texture_paths"] = {
                k: os.path.join(directory, env[k])
                for k in ("posx", "posy", "posz",
                          "negx", "negy", "negz") if k in env}
    if "light" in env:
        graph.environment["ambient"] = tuple(env["light"][:3])

    fur = data.get("Fur")
    if fur:
        graph.add_fur_fibers_to_all_meshes(
            int(fur.get("fibers_per_face", 5)), int(fur.get("fiber_verts", 10)),
            float(fur.get("radius", 0.004)), int(fur.get("seed", 0)))
    return graph


def save_scene_json(graph: SceneGraph, path: str,
                    mesh_dir: Optional[str] = None) -> None:
    """jsonio::writeScene (jsonout.cpp:14-301): emits Material/Mesh/Node/
    Environment; meshes are written as .b3df next to the scene file."""
    directory = os.path.dirname(os.path.abspath(path))
    mesh_dir = mesh_dir or directory

    def rel_materials():
        """Texture refs are written relative to the scene file (the
        reference writes into a textures/ dir, jsonout.cpp:183-216);
        internal `*_tex` atlas indices are stripped — they are rebuilt at
        load."""
        from .types import TEXTURE_SLOTS
        mats = []
        for m in graph.materials:
            m = dict(m)
            for slot in TEXTURE_SLOTS:
                m.pop(f"{slot}_tex", None)
                p = m.get(f"{slot}_map")
                if isinstance(p, str) and os.path.isabs(p):
                    m[f"{slot}_map"] = os.path.relpath(p, directory)
                elif p is not None and not isinstance(p, str):
                    # in-memory image: persist it next to the scene
                    from ..utils import film
                    fname = f"{m.get('name', 'mat')}_{slot}.png"
                    film.write_png(os.path.join(directory, fname),
                                   np.asarray(p, np.float32))
                    m[f"{slot}_map"] = fname
            mats.append(m)
        return mats

    out: dict = {"Material": rel_materials(), "Mesh": [], "Node": []}
    mesh_paths: dict = {}
    next_id = [0]

    def walk(node: SceneNode, parent_id: Optional[int]):
        entry: dict = {"object": node.data_type if node.data_type != "empty" else "empty",
                       "object_id": next_id[0], "name": node.name}
        nid = next_id[0]
        next_id[0] += 1
        if parent_id is not None:
            entry["parent_id"] = parent_id
        # decompose is lossy; store the matrix verbatim as an extension and
        # identity TRS for reference-compat readers
        entry["transform"] = np.asarray(node.transform, np.float32).reshape(16).tolist()
        if node.data_type == MESH:
            m: HostMesh = node.data
            if id(m) not in mesh_paths:
                from .binmesh import save_binary_mesh
                fname = f"{m.name or 'mesh'}_{len(mesh_paths)}.b3df"
                save_binary_mesh(os.path.join(mesh_dir, fname), m)
                mesh_paths[id(m)] = len(out["Mesh"])
                out["Mesh"].append({"path": fname})
            entry["mesh_id"] = mesh_paths[id(m)]
            entry["material_id"] = (m.material_ids if m.material_ids else [0])
        elif node.data_type == LIGHT:
            li: LightDesc = node.data
            entry.update(kind=li.kind, color=list(li.color),
                         position=list(li.position), direction=list(li.direction),
                         radius=li.radius, size=list(li.size),
                         constant=li.const_att, linear=li.lin_att,
                         quadratic=li.quad_att, inner=li.inner_angle,
                         outer=li.outer_angle)
        elif node.data_type == CAMERA:
            cd: CameraDesc = node.data
            entry.update(position=list(cd.position), direction=list(cd.direction),
                         up_vector=list(cd.up), resolution=list(cd.resolution))
        if node is not graph.root:
            out["Node"].append(entry)
        for c in node.children:
            walk(c, nid if node is not graph.root else None)

    walk(graph.root, None)
    env_out: dict = {"light": list(graph.environment.get("ambient", (0, 0, 0)))}
    kind = graph.environment.get("kind", 0)
    tex = graph.environment.get("texture")
    tex_paths = graph.environment.get("texture_paths")
    if kind == 1 and tex is not None:  # sphere map
        env_out["kind"] = "sphere"
        if tex_paths and "path" in tex_paths:
            env_out["path"] = os.path.relpath(tex_paths["path"], directory)
        else:
            from ..utils import film
            film.write_png(os.path.join(directory, "environment_sphere.png"),
                           np.asarray(tex, np.float32))
            env_out["path"] = "environment_sphere.png"
    elif kind == 2 and tex is not None:  # cube map
        env_out["kind"] = "cube"
        names = ("posx", "posy", "posz", "negx", "negy", "negz")
        if tex_paths and all(k in tex_paths for k in names):
            env_out.update({k: os.path.relpath(tex_paths[k], directory)
                            for k in names})
        else:
            from ..utils import film
            # stack order is +x,+y,-z,-x,-y,+z (see load_scene_json)
            stack_of = {"posx": 0, "posy": 1, "negz": 2,
                        "negx": 3, "negy": 4, "posz": 5}
            for k in names:
                fname = f"environment_{k}.png"
                film.write_png(os.path.join(directory, fname),
                               np.asarray(tex[stack_of[k]], np.float32))
                env_out[k] = fname
    else:
        env_out["color"] = list(graph.environment.get("color", (0, 0, 0)))
    out["Environment"] = env_out
    if graph.fur:
        out["Fur"] = dict(graph.fur)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)


def _maybe_load_transform(entry: dict):
    """Reader support for the writer's verbatim-matrix extension."""
    if "transform" in entry:
        return np.asarray(entry["transform"], np.float32).reshape(4, 4)
    return None
