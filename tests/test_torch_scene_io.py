"""The port's scene files and host tools against the JAX package's, on the
same files made here from seeded numpy data:

* film: the PNG reader on every filter type and on RGBA, PPM, .npy,
  `read_image`, `mse`, `relative_l1`: bit-equal;
* the log's `%` substitution and its file sink; `noise` (value, fBm,
  texture) within 1e-6 (XLA contracts the lerps into FMAs);
* OBJ + MTL (fan triangulation, negative and partial indices, usemtl
  slots, map paths), PLY (ASCII, binary little- and big-endian, vertex
  colours, normals, uvs), b3df (the written bytes, compressed and raw, and
  the loaded mesh): equal;
* `load_scene_json` (materials by value and by path, `*_map` paths, OBJ,
  PLY and b3df meshes, node TRS, `transform` and parents, a camera by
  look_at, the four light kinds, colour / sphere / cube environments, the
  "Fur" section) gives the same graph, and `save_scene_json` the same
  bytes (its b3df files too);
* `flatten` gives the same packs, material table, lights, environment,
  atlas, `tex_slots` and camera, fur as cone chains and as triangle tubes.
"""

import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.scene import binmesh as jbinmesh, graph as jgraph, io as jio, \
    noise as jnoise, obj as jobj, ply as jply
from ba_pathtracing_fur_tpu.utils import film as jfilm, log as jlog
from ba_pathtracing_fur_torch.scene import binmesh, graph, io, noise, obj, ply
from ba_pathtracing_fur_torch.utils import film, log

torch.set_num_threads(2)

CPU = "cpu"


# ---------------------------------------------------------------------------
# Film, log, noise
# ---------------------------------------------------------------------------

def _filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of img [H,W,C] (C 3 or 4) with row y encoded by filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, ch = img.shape
    stride = w * ch
    rows = img.reshape(h, stride).astype(np.int64)
    prev = np.zeros(stride, np.int64)
    raw = b""
    for y in range(h):
        f = filters[y % len(filters)]
        row = rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), row[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        if f == 0:
            pred = np.zeros(stride, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_film_reads_equal_jax(tmp_path, channels):
    rs = np.random.RandomState(channels)
    img = rs.randint(0, 256, (9, 7, channels)).astype(np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_filtered_png(img, (0, 1, 2, 3, 4)))
    for gamma in (2.2, 1.0):
        a, b = jfilm.read_png(str(p), gamma), film.read_png(str(p), gamma)
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(film.read_png(str(p), 1.0),
                                  img[..., :3].astype(np.float32) / 255.0)
    lin = rs.rand(6, 5, 3).astype(np.float32)
    film.write_ppm(str(tmp_path / "a.ppm"), lin)
    jfilm.write_ppm(str(tmp_path / "b.ppm"), lin)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()
    np.save(tmp_path / "c.npy", lin)
    for name in ("f.png", "a.ppm", "c.npy"):
        np.testing.assert_array_equal(film.read_image(str(tmp_path / name)),
                                      jfilm.read_image(str(tmp_path / name)))
    assert film.read_image(str(tmp_path / "missing.xyz")) is None
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(AssertionError, match="not a PNG"):
        film.read_png(str(bad))
    x, y = rs.rand(4, 4, 3), rs.rand(4, 4, 3)
    assert film.mse(x, y) == jfilm.mse(x, y)
    assert film.relative_l1(x, y) == jfilm.relative_l1(x, y)
    assert film.relative_l1(x, np.zeros_like(y)) == jfilm.relative_l1(x, np.zeros_like(y))


def test_log_substitution_and_file_sink(tmp_path):
    for fmt, args in (("render %/% samples (% pct)", (3, 10, 30.0)), ("no args %", ()),
                      ("% % %", (1, "a")), ("%s done", (0.5,)), ("100%", (7,))):
        assert log._subst(fmt, *args) == jlog._subst(fmt, *args)
    log.init_log_file(str(tmp_path / "run"))
    log.log_info("wrote % in % s", "x.png", 1.5)
    log.log_debug("hidden %", 1)
    for h in log.get_logger().handlers:
        h.flush()
    text = (tmp_path / "run.log").read_text()
    assert "wrote x.png in 1.5 s" in text and "hidden" not in text
    log.get_logger().removeHandler(log.get_logger().handlers[-1])


@pytest.mark.parametrize("shape,scale,seed", [((32, 24), 8.0, 0), ((17, 45), 5.3, 3),
                                              ((16, 16), 2.0, 12345)])
def test_noise_matches_jax(shape, scale, seed):
    np.testing.assert_allclose(noise.value_noise(shape, scale, seed, device=CPU).numpy(),
                               np.asarray(jnoise.value_noise(shape, scale, seed)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(noise.fbm_noise(shape, 3, scale, seed=seed, device=CPU).numpy(),
                               np.asarray(jnoise.fbm_noise(shape, 3, scale, seed=seed)),
                               rtol=0, atol=1e-6)
    kw = dict(octaves=4, scale=scale, color_lo=(0.1, 0.2, 0.3), color_hi=(0.9, 0.5, 0.7),
              seed=seed)
    a = noise.noise_texture(shape[0], device=CPU, **kw).numpy()
    assert a.shape == (shape[0], shape[0], 3) and a.dtype == np.float32
    np.testing.assert_allclose(a, np.asarray(jnoise.noise_texture(shape[0], **kw)), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Mesh files
# ---------------------------------------------------------------------------

def _assert_mesh_equal(a, b, what=""):
    for f in ("vertices", "faces", "normals", "uvs", "face_material"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f"{what} {f}"
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f"{what} {f}"
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{what} {f}")
    for f in ("material_ids", "material_defs", "fur_material_id", "name"):
        assert getattr(a, f) == getattr(b, f), f"{what} {f}"
    assert (a.fur is None) == (b.fur is None)
    if a.fur is not None:
        np.testing.assert_array_equal(a.fur.positions, b.fur.positions)
        np.testing.assert_array_equal(a.fur.radii, b.fur.radii)


def _write_obj(d, rs, with_normals=True):
    """quad.obj + quad.mtl: a grid of quads, a pentagon, negative and
    partial indices, two usemtl slots (one with map paths), normals."""
    (d / "quad.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\nKs 0.2 0.2 0.2\nNs 250\nNi 1.4\nd 0.75\n"
        "map_Kd -bm 1.0 tex.png\nmap_Ns rough.png\n"
        "newmtl glow\nKe 2 2 1\nTr 0.1\n")
    lines = ["mtllib quad.mtl", "o quad"]
    g = rs.rand(4, 4).astype(np.float32) * 0.1
    for i in range(4):
        for j in range(4):
            lines.append(f"v {i / 3:.6f} {g[i, j]:.6f} {j / 3:.6f}")
            lines.append(f"vt {i / 2 - 0.5:.6f} {j / 2:.6f}")
            if with_normals:
                lines.append(f"vn {g[i, j]:.4f} 1 0")
    lines.append("usemtl red")
    for i in range(3):
        for j in range(2):
            a, b = i * 4 + j + 1, i * 4 + j + 2
            c, e = (i + 1) * 4 + j + 2, (i + 1) * 4 + j + 1
            fmt = "{0}/{0}/{0}" if with_normals else "{0}/{0}"
            lines.append("f " + " ".join(fmt.format(k) for k in (a, b, c, e)))
    lines.append("usemtl glow")
    lines.append("f -1 -2 -3 -5 -6")  # a pentagon by negative indices
    lines.append("f 3//3 4//4 8//8" if with_normals else "f 3 4 8")
    (d / "quad.obj").write_text("\n".join(lines) + "\n")
    return d / "quad.obj"


@pytest.mark.parametrize("with_normals", [True, False])
def test_obj_mtl_and_b3df_equal_jax(tmp_path, with_normals):
    rs = np.random.RandomState(1)
    p = _write_obj(tmp_path, rs, with_normals)
    a, b = obj.load_obj(str(p)), jobj.load_obj(str(p))
    _assert_mesh_equal(a, b, "obj")
    assert a.material_slot_names == b.material_slot_names == ["default", "red", "glow"]
    assert obj.load_mtl(str(tmp_path / "quad.mtl")) == jobj.load_mtl(str(tmp_path / "quad.mtl"))
    assert obj.load_mtl(str(tmp_path / "none.mtl")) == {}
    for compress in (True, False):
        binmesh.save_binary_mesh(str(tmp_path / "a.b3df"), a, compress)
        jbinmesh.save_binary_mesh(str(tmp_path / "b.b3df"), b, compress)
        assert (tmp_path / "a.b3df").read_bytes() == (tmp_path / "b.b3df").read_bytes()
        _assert_mesh_equal(binmesh.load_binary_mesh(str(tmp_path / "a.b3df")),
                           jbinmesh.load_binary_mesh(str(tmp_path / "a.b3df")), "b3df")
    binmesh.convert_obj(str(p), str(tmp_path / "c.b3df"))
    jbinmesh.convert_obj(str(p), str(tmp_path / "d.b3df"))
    assert (tmp_path / "c.b3df").read_bytes() == (tmp_path / "d.b3df").read_bytes()
    obj.save_obj(str(tmp_path / "a.obj"), a)
    jobj.save_obj(str(tmp_path / "b.obj"), b)
    ta, tb = ((tmp_path / n).read_text().splitlines() for n in ("a.obj", "b.obj"))
    assert ta[1:] == tb[1:]  # the header line names the package
    _assert_mesh_equal(obj.load_obj(str(tmp_path / "a.obj"), name="x"),
                       jobj.load_obj(str(tmp_path / "a.obj"), name="x"), "round trip")
    (tmp_path / "bad.b3df").write_bytes(b"XXXX" + bytes(5))
    with pytest.raises(ValueError, match="not a B3DF"):
        binmesh.load_binary_mesh(str(tmp_path / "bad.b3df"))


def _ply(fmt: str, rs, colours=True, normals=False, uvs=True) -> bytes:
    """A PLY of a 3x3 vertex grid with two quads and two triangles."""
    n_v = 9
    xyz = rs.rand(n_v, 3).astype(np.float32)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if normals:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if uvs:
        props += [("s", "f4"), ("t", "f4")]
    if colours:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    faces = [(0, 1, 4, 3), (1, 2, 5), (3, 4, 7, 6), (4, 5, 8)]
    names = {"f4": "float", "u1": "uchar"}
    head = ["ply", f"format {fmt} 1.0", "comment made by the tests", f"element vertex {n_v}"]
    head += [f"property {names[t]} {n}" for n, t in props]
    head += [f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    cols = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    if normals:
        nrm = rs.rand(n_v, 3).astype(np.float32) + 0.1
        cols.update(nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2])
    if uvs:
        cols.update(s=rs.rand(n_v).astype(np.float32), t=rs.rand(n_v).astype(np.float32))
    if colours:
        for c in ("red", "green", "blue"):
            cols[c] = rs.randint(0, 256, n_v).astype(np.uint8)
    out = ("\n".join(head) + "\n").encode()
    if fmt == "ascii":
        for i in range(n_v):
            out += (" ".join(repr(float(cols[n][i])) if t == "f4" else str(int(cols[n][i]))
                             for n, t in props) + "\n").encode()
        for f in faces:
            out += (f"{len(f)} " + " ".join(map(str, f)) + "\n").encode()
        return out
    pre = "<" if fmt == "binary_little_endian" else ">"
    dt = np.dtype([(n, pre + t) for n, t in props])
    rec = np.zeros(n_v, dt)
    for n, _ in props:
        rec[n] = cols[n]
    out += rec.tobytes()
    for f in faces:
        out += bytes([len(f)]) + np.asarray(f, pre + "i4").tobytes()
    return out


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
@pytest.mark.parametrize("normals", [False, True])
def test_ply_equal_jax(tmp_path, fmt, normals):
    p = tmp_path / "m.ply"
    p.write_bytes(_ply(fmt, np.random.RandomState(2), normals=normals, uvs=not normals))
    a, b = ply.load_ply(str(p)), jply.load_ply(str(p))
    _assert_mesh_equal(a, b, fmt)
    assert a.faces.shape == (6, 3) and a.material_defs[0]["name"] == "ply_default"
    p.write_bytes(b"plx\n")
    with pytest.raises(ValueError, match="not a PLY"):
        ply.load_ply(str(p))


# ---------------------------------------------------------------------------
# JSON scenes, graphs and flatten
# ---------------------------------------------------------------------------

def _write_scene(d, env: str = "color", fur: bool = True) -> str:
    """A scene file using every section the loader reads, with its meshes
    and images; `env` is "color", "sphere" or "cube"."""
    rs = np.random.RandomState(7)
    film.write_png(str(d / "tex.png"), rs.rand(8, 6, 3).astype(np.float32))
    film.write_png(str(d / "rough.png"), rs.rand(4, 4, 3).astype(np.float32))
    film.write_png(str(d / "spec.png"), rs.rand(5, 3, 3).astype(np.float32))
    _write_obj(d, rs)
    (d / "m.ply").write_bytes(_ply("binary_little_endian", rs))
    jbinmesh.convert_obj(str(d / "quad.obj"), str(d / "quad.b3df"))
    (d / "glossy.json").write_text(json.dumps(dict(
        name="glossy", bsdf="GlossyBSDF", specular=[0.9, 0.8, 0.7], roughness=0.3,
        specular_map="spec.png")))
    scene = {
        "Material": [
            dict(name="skin", diffuse=[0.35, 0.25, 0.18], bsdf="LambertianReflectionBSDF",
                 diffuse_map="tex.png", roughness_map="rough.png", transparency=0.1),
            {"path": "glossy.json"},
            {"path": "missing.json"},
            dict(name="glass", bsdf="GlassBSDF", ior=1.5),
        ],
        "Mesh": [{"path": "quad.obj"}, {"path": "m.ply"}, {"path": "quad.b3df"}],
        "Node": [
            dict(object="empty", object_id=0, translation=[0.1, 0.2, -0.3],
                 rotation=[0.9, 0.1, 0.3, 0.0], scale=[1.5, 1.0, 0.5], name="group"),
            dict(object="mesh", object_id=1, parent_id=0, mesh_id=0, name="obj-own-mtl"),
            dict(object="mesh", object_id=2, parent_id=0, mesh_id=1, material_id=[3],
                 translation=[0.0, 0.5, 0.0], name="ply"),
            dict(object="mesh", object_id=3, mesh_id=2, material_id=0,
                 transform=[1, 0, 0, 0.2, 0, 1, 0, 0, 0, 0, 1, -0.4, 0, 0, 0, 1], name="b3df"),
            dict(object="camera", object_id=4, position=[0.3, 1.0, 2.0],
                 look_at=[0.3, 0.0, 0.0], up_vector=[0, 1, 0], resolution=[12, 10],
                 focal_length=0.05, f_stop=2.8, name="cam"),
            dict(object="light", object_id=5, kind="point", color=[5, 5, 5],
                 position=[0, 2, 1], radius=0.1, constant=1.0, linear=0.2, quadratic=0.1),
            dict(object="light", object_id=6, parent_id=0, kind="quad", color=[3, 3, 3, 1],
                 position=[0, 1.5, 0], direction=[0, -1, 0], size=[0.4, 0.3]),
            dict(object="light", object_id=7, kind="spot", color=[4, 4, 2],
                 position=[1, 1, 1], direction=[-1, -1, -1], inner=20, outer=35),
            dict(object="light", object_id=8, kind="sun", color=[1.5, 1.4, 1.2],
                 direction=[-0.4, -1.0, -0.3], radius=0.05),
        ],
        "Environment": {"light": [0.05, 0.06, 0.07]},
    }
    if env == "color":
        scene["Environment"]["color"] = [0.1, 0.2, 0.3]
    elif env == "sphere":
        film.write_png(str(d / "sky.png"), rs.rand(6, 12, 3).astype(np.float32))
        scene["Environment"].update(kind="sphere", path="sky.png")
    else:
        for k in ("posx", "posy", "posz", "negx", "negy", "negz"):
            film.write_png(str(d / f"{k}.png"), rs.rand(4, 4, 3).astype(np.float32))
        scene["Environment"].update(kind="cube", **{k: f"{k}.png" for k in (
            "posx", "posy", "posz", "negx", "negy", "negz")})
    if fur:
        scene["Fur"] = dict(fibers_per_face=3, fiber_verts=5, radius=0.01, seed=4)
    p = d / "scene.json"
    p.write_text(json.dumps(scene))
    return str(p)


def _assert_value_equal(a, b, what):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            _assert_value_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    else:
        assert a == b, what


def _assert_graph_equal(a, b):
    na, nb = list(a.nodes()), list(b.nodes())
    assert len(na) == len(nb)
    for (x, wx), (y, wy) in zip(na, nb):
        assert (x.name, x.data_type, len(x.children)) == (y.name, y.data_type, len(y.children))
        np.testing.assert_array_equal(x.transform, y.transform)
        np.testing.assert_array_equal(wx, wy)
        if x.data_type == graph.MESH:
            _assert_mesh_equal(x.data, y.data, x.name)
        elif x.data is not None:
            assert dataclasses.asdict(x.data) == dataclasses.asdict(y.data), x.name
    _assert_value_equal(a.materials, b.materials, "materials")
    _assert_value_equal(a.environment, b.environment, "environment")
    assert a.fur == b.fur
    assert (a.active_camera is None) == (b.active_camera is None)
    if a.active_camera is not None:
        assert dataclasses.asdict(a.active_camera) == dataclasses.asdict(b.active_camera)


@pytest.mark.parametrize("env", ["color", "sphere", "cube"])
def test_load_and_save_scene_json_equal_jax(tmp_path, env):
    p = _write_scene(tmp_path, env)
    a, b = io.load_scene_json(p), jio.load_scene_json(p)
    _assert_graph_equal(a, b)
    assert a.materials[2] == {"name": "default"} and a.fur["fibers_per_face"] == 3
    for pkg, g in (("port", a), ("jax", b)):
        (tmp_path / pkg).mkdir()
    io.save_scene_json(a, str(tmp_path / "port" / "out.json"))
    jio.save_scene_json(b, str(tmp_path / "jax" / "out.json"))
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files and "out.json" in files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    # the written scene reads back to the same graph in both packages
    _assert_graph_equal(io.load_scene_json(str(tmp_path / "port" / "out.json")),
                        jio.load_scene_json(str(tmp_path / "port" / "out.json")))


def _assert_flat_equal(ts, tc, js, jc):
    for part in ("tris", "cones", "materials", "lights"):
        tp, jp = getattr(ts, part), getattr(js, part)
        for f in dataclasses.fields(tp):
            x, y = getattr(tp, f.name).numpy(), np.asarray(getattr(jp, f.name))
            assert x.dtype == y.dtype or (x.dtype == np.int32 and y.dtype.kind == "i"), \
                f"{part}.{f.name}"
            np.testing.assert_array_equal(x, y, err_msg=f"{part}.{f.name}")
    assert ts.env.kind == js.env.kind
    np.testing.assert_array_equal(ts.env.color.numpy(), np.asarray(js.env.color))
    np.testing.assert_array_equal(ts.env.ambient.numpy(), np.asarray(js.env.ambient))
    assert (ts.env.texture is None) == (js.env.texture is None)
    if ts.env.texture is not None:
        np.testing.assert_array_equal(ts.env.texture.numpy(), np.asarray(js.env.texture))
    assert (ts.textures is None) == (js.textures is None)
    if ts.textures is not None:
        np.testing.assert_array_equal(ts.textures.images.numpy(),
                                      np.asarray(js.textures.images))
        np.testing.assert_array_equal(ts.textures.sizes.numpy(), np.asarray(js.textures.sizes))
    assert (ts.tex_slots, ts.has_hair, ts.bsdfs_present) == \
        (tuple(js.tex_slots), js.has_hair, tuple(js.bsdfs_present))
    for f in ("position", "axis_x", "axis_y", "axis_z", "bottom_left"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    for f in ("pixel_size", "aperture", "focus_distance"):
        assert getattr(tc, f) == float(np.float32(getattr(jc, f))), f
    assert tuple(tc.resolution) == tuple(jc.resolution) and tc.use_dof == jc.use_dof


@pytest.mark.parametrize("env", ["color", "sphere", "cube"])
@pytest.mark.parametrize("cylinders", [True, False])
def test_flatten_equals_jax(tmp_path, env, cylinders):
    """Every pack field, the material table (with the atlas ids), lights,
    the environment, the atlas, tex_slots and the camera; the fur as cone
    chains or as triangle tubes of 4 sides."""
    p = _write_scene(tmp_path, env)
    ts, tc = graph.flatten(io.load_scene_json(p), fiber_as_cylinder=cylinders,
                           tube_resolution=4, device=CPU)
    js, jc = jgraph.flatten(jio.load_scene_json(p), fiber_as_cylinder=cylinders,
                            tube_resolution=4)
    _assert_flat_equal(ts, tc, js, jc)
    assert ts.tris.v0.device.type == "cpu"
    assert (ts.cones.count > 0) == cylinders and ts.textures is not None
    assert set(ts.tex_slots) == {"diffuse", "specular", "roughness"}


def test_flatten_of_a_graph_built_in_code_equals_jax():
    """A graph built through the classes: the default light, fur on every
    mesh (the default fur material), no camera, a mesh without materials,
    an in-memory texture, and an empty graph's defaults."""
    rs = np.random.RandomState(3)
    v = rs.rand(6, 3).astype(np.float32)
    f = np.array([[0, 1, 2], [3, 4, 5], [0, 2, 4]])
    img = rs.rand(5, 4, 3).astype(np.float32)
    out = []
    for mod in (graph, jgraph):
        g = mod.SceneGraph()
        g.materials.append(dict(name="m", diffuse_map=img, emission_map=img))
        g.root.attach(mod.SceneNode(mod.HostMesh(vertices=v.copy(), faces=f), mod.MESH,
                                    transform=mod.trs_matrix((0, 1, 0), (0.5, 0.5, 0.5, 0.5),
                                                             (2, 2, 2))))
        g.add_default_light()
        g.add_fur_fibers_to_all_meshes(4, 4, 0.02, seed=1)
        out.append(g)
    ts, tc = graph.flatten(out[0], device=CPU)
    js, jc = jgraph.flatten(out[1])
    assert tc is None and jc is None
    for part in ("tris", "cones", "materials", "lights"):
        for fd in dataclasses.fields(getattr(ts, part)):
            np.testing.assert_array_equal(getattr(getattr(ts, part), fd.name).numpy(),
                                          np.asarray(getattr(getattr(js, part), fd.name)))
    np.testing.assert_array_equal(ts.textures.images.numpy(), np.asarray(js.textures.images))
    assert ts.tex_slots == tuple(js.tex_slots) == ("diffuse", "emission")
    es, _ = graph.flatten(graph.SceneGraph(), device=CPU)
    ej, _ = jgraph.flatten(jgraph.SceneGraph())
    assert es.tris.count == 0 == ej.tris.count and es.materials.count == 1 == ej.materials.count
