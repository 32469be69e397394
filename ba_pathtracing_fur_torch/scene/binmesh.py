"""Binary mesh format: the `.b3df` counterpart.

Counterpart of `ba_pathtracing_fur_tpu/scene/binmesh.py`: the same bytes
for the same mesh. KIRK::BinaryModelUtils (BinaryModelUtils.h:13-27) and
the objToBinaryConverter executable (main.cpp:14-44): a binary cache of
converted OBJ meshes, optionally zlib-compressed. It keeps no materials:
a mesh node of a JSON scene names its scene material by `material_id`.

Format (magic b"B3DF", version 2, little-endian):
    u32 magic | u32 version | u8 compressed
    then a zlib-or-raw blob of:
    u64 V | u64 F | u8 has_normals | u8 has_uvs | u8 has_face_mat
    f32 vertices [V,3] | i64 faces [F,3] | [f32 normals [V,3]]
    [f32 uvs [V,2]] | [i64 face_material [F]]
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .graph import HostMesh

MAGIC = b"B3DF"
VERSION = 2


def save_binary_mesh(path: str, mesh: HostMesh, compress: bool = True) -> None:
    parts = [struct.pack("<QQBBB", mesh.vertices.shape[0], mesh.faces.shape[0],
                         mesh.normals is not None, mesh.uvs is not None,
                         mesh.face_material is not None)]
    parts.append(np.ascontiguousarray(mesh.vertices, np.float32).tobytes())
    parts.append(np.ascontiguousarray(mesh.faces, np.int64).tobytes())
    if mesh.normals is not None:
        parts.append(np.ascontiguousarray(mesh.normals, np.float32).tobytes())
    if mesh.uvs is not None:
        parts.append(np.ascontiguousarray(mesh.uvs, np.float32).tobytes())
    if mesh.face_material is not None:
        parts.append(np.ascontiguousarray(mesh.face_material, np.int64).tobytes())
    blob = b"".join(parts)
    if compress:
        blob = zlib.compress(blob, 6)
    with open(path, "wb") as fh:
        fh.write(MAGIC + struct.pack("<IB", VERSION, compress))
        fh.write(blob)


def load_binary_mesh(path: str) -> HostMesh:
    with open(path, "rb") as fh:
        head = fh.read(9)
        if head[:4] != MAGIC:
            raise ValueError(f"{path}: not a B3DF file")
        version, compressed = struct.unpack("<IB", head[4:])
        if version != VERSION:
            raise ValueError(f"{path}: unsupported B3DF version {version}")
        blob = fh.read()
    if compressed:
        blob = zlib.decompress(blob)
    off = struct.calcsize("<QQBBB")
    nv, nf, has_n, has_uv, has_fm = struct.unpack("<QQBBB", blob[:off])

    def take(count, dtype, cols):
        nonlocal off
        n_bytes = count * cols * np.dtype(dtype).itemsize
        arr = np.frombuffer(blob[off:off + n_bytes], dtype=dtype)
        off += n_bytes
        return arr.reshape(count, cols) if cols > 1 else arr

    vertices = take(nv, np.float32, 3).copy()
    faces = take(nf, np.int64, 3).copy()
    normals = take(nv, np.float32, 3).copy() if has_n else None
    uvs = take(nv, np.float32, 2).copy() if has_uv else None
    face_mat = take(nf, np.int64, 1).copy() if has_fm else None
    return HostMesh(vertices=vertices, faces=faces, normals=normals, uvs=uvs,
                    face_material=face_mat, name=path.rsplit("/", 1)[-1])


def convert_obj(obj_path: str, out_path: str, compress: bool = True) -> None:
    """objToBinaryConverter main loop body (main.cpp:14-44)."""
    from .obj import load_obj
    save_binary_mesh(out_path, load_obj(obj_path), compress)
