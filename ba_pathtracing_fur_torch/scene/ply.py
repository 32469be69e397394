"""Stanford PLY loader (ascii, binary little- and big-endian) in plain
Python and numpy.

Counterpart of `ba_pathtracing_fur_tpu/scene/ply.py`, line for line, its
two reference quirks kept: every file's material is named `ply_default`
(so `graph.flatten` dedupes the materials of several PLY meshes into one),
and a binary face list is read one row at a time. The second interchange
format beside OBJ: the reference imports arbitrary formats through Assimp
(SceneGraph.cpp:85-139); PLY is
the lingua franca of scanned-geometry assets (bunny/dragon class scenes).
Parity with createMeshFromAi's post-processing (SceneGraph.cpp:145-256):
n-gon faces are fan-triangulated (:196-216), smooth vertex normals are
generated when the file has none (aiProcess_GenSmoothNormals analog — the
same area-weighted accumulation obj.py uses), texcoords imported when
present, and the single material slot gets the reference's fixed defaults
reflectivity=0.2, roughness=0.1, ior=1.56 (:175-179), with per-vertex
colors (red/green/blue properties) averaged into the diffuse color when
the file carries them.
"""

from __future__ import annotations

import numpy as np

from .graph import HostMesh

_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


class _Property:
    def __init__(self, name, dtype, list_count_dtype=None):
        self.name = name
        self.dtype = dtype
        self.list_count_dtype = list_count_dtype  # None = scalar


def _parse_header(fh):
    """-> (format, [(element_name, count, [properties])], header_len)."""
    magic = fh.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements = []
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]  # ascii / binary_little_endian / binary_big_endian
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if not elements:
                raise ValueError("property before any element")
            props = elements[-1][2]
            if tokens[1] == "list":
                props.append(_Property(tokens[4], _DTYPES[tokens[3]],
                                       _DTYPES[tokens[2]]))
            else:
                props.append(_Property(tokens[2], _DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return fmt, elements


def _read_ascii_element(fh, count, props):
    rows = {p.name: [] for p in props}
    for _ in range(count):
        tokens = fh.readline().split()
        i = 0
        for p in props:
            if p.list_count_dtype is not None:
                n = int(tokens[i]); i += 1
                rows[p.name].append(
                    np.array(tokens[i:i + n], dtype=p.dtype))
                i += n
            else:
                rows[p.name].append(np.dtype(p.dtype).type(tokens[i]))
                i += 1
    return rows


def _read_binary_element(fh, count, props, endian):
    pre = "<" if endian == "little" else ">"
    if all(p.list_count_dtype is None for p in props):
        dt = np.dtype([(p.name, pre + p.dtype) for p in props])
        data = np.frombuffer(fh.read(dt.itemsize * count), dtype=dt,
                             count=count)
        return {p.name: data[p.name] for p in props}
    rows = {p.name: [] for p in props}
    for _ in range(count):
        for p in props:
            if p.list_count_dtype is not None:
                cdt = np.dtype(pre + p.list_count_dtype)
                n = int(np.frombuffer(fh.read(cdt.itemsize), cdt, 1)[0])
                idt = np.dtype(pre + p.dtype)
                rows[p.name].append(
                    np.frombuffer(fh.read(idt.itemsize * n), idt, n))
            else:
                idt = np.dtype(pre + p.dtype)
                rows[p.name].append(
                    np.frombuffer(fh.read(idt.itemsize), idt, 1)[0])
    return rows


def _smooth_normals(vertices, faces):
    """Area-weighted vertex normals (aiProcess_GenSmoothNormals analog —
    identical to obj.py's generation so both loaders shade alike)."""
    v0 = vertices[faces[:, 0]]
    fn = np.cross(vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0)
    normals = np.zeros_like(vertices)
    for c in range(3):
        np.add.at(normals, faces[:, c], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(lens, 1e-12)


def load_ply(path: str, material: dict | None = None) -> HostMesh:
    """Load a .ply mesh (ascii or binary) -> HostMesh with fan-triangulated
    faces, smooth normals (generated when absent), uvs when present, and
    one material slot carrying the reference import defaults."""
    with open(path, "rb") as fh:
        fmt, elements = _parse_header(fh)
        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data[name] = _read_ascii_element(fh, count, props)
            else:
                endian = "little" if fmt == "binary_little_endian" else "big"
                data[name] = _read_binary_element(fh, count, props, endian)

    if "vertex" not in data:
        raise ValueError("PLY has no vertex element")
    vtx = data["vertex"]
    for axis in ("x", "y", "z"):
        if axis not in vtx:
            raise ValueError(f"PLY vertex element lacks '{axis}'")
    vertices = np.stack([np.asarray(vtx["x"], np.float32),
                         np.asarray(vtx["y"], np.float32),
                         np.asarray(vtx["z"], np.float32)], axis=1)

    faces = []
    face_el = data.get("face", {})
    idx_lists = (face_el.get("vertex_indices")
                 if "vertex_indices" in face_el
                 else face_el.get("vertex_index"))
    if idx_lists is None:
        raise ValueError("PLY has no face element with vertex indices")
    for poly in idx_lists:
        poly = np.asarray(poly, np.int64)
        for k in range(1, len(poly) - 1):  # triangle fan (SceneGraph
            faces.append((poly[0], poly[k], poly[k + 1]))  # .cpp:196-216)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)

    if "nx" in vtx and "ny" in vtx and "nz" in vtx:
        normals = np.stack([np.asarray(vtx["nx"], np.float32),
                            np.asarray(vtx["ny"], np.float32),
                            np.asarray(vtx["nz"], np.float32)], axis=1)
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(lens, 1e-12)
    else:
        normals = _smooth_normals(vertices, faces).astype(np.float32)

    uvs = None
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ukey in vtx and vkey in vtx:
            uvs = np.stack([np.asarray(vtx[ukey], np.float32),
                            np.asarray(vtx[vkey], np.float32)], axis=1)
            break

    mat = dict(name="ply_default", diffuse=(0.7, 0.7, 0.7),
               reflectivity=0.2, roughness=0.1, ior=1.56)
    if all(c in vtx for c in ("red", "green", "blue")):
        scale = 255.0 if np.asarray(vtx["red"]).dtype.kind == "u" else 1.0
        mat["diffuse"] = tuple(
            float(np.mean(np.asarray(vtx[c], np.float32)) / scale)
            for c in ("red", "green", "blue"))
    if material:
        mat.update(material)

    return HostMesh(vertices=vertices, faces=faces, normals=normals,
                    uvs=uvs,
                    face_material=np.zeros(faces.shape[0], np.int32),
                    material_defs=[mat])
