"""The port's fur slice against the JAX package on the CPU.

* `scene/builtins.fur_patch` (fibers, cone frames, materials, lights,
  camera) equals JAX `fur_patch` field by field.
* The hair automaton of the shading body: `ops/cuda/shade.shade_bounce_ref`
  against JAX `shade_bounce(mode="xla")` and the Pallas `_shade_kernel`
  (`mode="kernel"`, interpret mode) on fur-patch hits, Marschner and
  d'Eon, with `hair_p_random` and MIS on and off, under the per-field gate
  of tests/test_fused_shade.py::test_fused_single_bounce_exact. The port
  takes each ray's key and material id; JAX takes the draws
  `rng.bounce_uniform` makes from the same keys and its own gather.
* The slice end to end: a BVH-less fur-patch render against JAX
  `render_image(fused_shading=True)` under the image gate of
  tests/test_fused_shade.py::_compare (the BVH render is in
  test_torch_traverse.py, so the two JAX compiles run on two workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.core import camera as jcam, rng as jrng
from ba_pathtracing_fur_tpu.models import bsdf as jbsdf, pathtracer as jpt
from ba_pathtracing_fur_tpu.models.shade_core import CoreCfg as JCoreCfg
from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
from ba_pathtracing_fur_tpu.ops.pallas import shade as jshade
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins, mesh as jmesh
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
from ba_pathtracing_fur_torch.models import pathtracer as pt, shade_core as sc
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, traverse as ctraverse
from ba_pathtracing_fur_torch.scene import builtins, mesh, types
from test_torch_scene import _assert_scene_equal

torch.set_num_threads(2)

CPU = "cpu"
RES = (16, 16)
STATE_FIELDS = ("origin", "direction", "radiance", "color", "flags", "theta_i", "prev_pdf")
SHADOW_FIELDS = ("shadow_tmax", "direct_rgb")
MAT_FIELDS = ("diffuse", "specular", "volume", "emission", "ior", "transparency",
              "reflectivity", "roughness", "bsdf_id", "shader_id", "hair_alpha", "hair_beta")


def _gate(a, b, what, where=None):
    """The gate of test_fused_single_bounce_exact: < 2% of values off by
    more than 1e-4 + 1e-4|a| (isolated float-boundary decision flips)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    if where is not None:
        a, b = a[where], b[where]
        if not a.size:
            return
    bad = np.abs(a - b) > 1e-4 + 1e-4 * np.abs(a)
    assert bad.mean() < 0.02, f"{what}: {bad.mean():.4f} mismatched"


def test_environment_color_equals_jax():
    """The constant environment colour, as JAX gives it per ray, comes back
    as a broadcast of its 3 floats (row stride 0: the shade kernel reads it
    once)."""
    from ba_pathtracing_fur_tpu.models import shading as jshading
    from ba_pathtracing_fur_torch.models import shading

    js, _ = jbuiltins.fur_patch(resolution=(4, 4), fibers_per_face=4)
    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=4, device=CPU)
    dirs = np.random.default_rng(5).normal(size=(37, 3)).astype(np.float32)
    got = shading.environment_color(ts.env, torch.from_numpy(dirs))
    assert got.shape == (37, 3) and got.stride(0) == 0
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jshading.environment_color(js.env, jnp.asarray(dirs))))


def test_fibers_equal_jax():
    faces = np.random.default_rng(0).random((3, 3, 3)).astype(np.float32)
    a = mesh.grow_fur_fibers(faces, 7, 6, 0.01, seed=3)
    b = jmesh.grow_fur_fibers(faces, 7, 6, 0.01, seed=3)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.radii, b.radii)
    for x, y in zip(mesh.fibers_to_cone_chain(a), jmesh.fibers_to_cone_chain(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bsdf", ["MarschnerHairBSDF", "DEonHairBSDF"])
def test_fur_patch_equals_jax(bsdf):
    kw = dict(resolution=(24, 16), fibers_per_face=9, fiber_verts=7, bsdf=bsdf, seed=2)
    js, jc = jbuiltins.fur_patch(**kw)
    ts, tc = builtins.fur_patch(**kw, device=CPU)
    _assert_scene_equal(ts, types.scene_from_numpy(js, device=CPU))
    assert ts.cones.count == 2 * 9 * 6 and ts.has_hair
    ref = camera_from_numpy(jc, device=CPU)
    for f in ("position", "axis_x", "axis_y", "axis_z", "bottom_left"):
        assert torch.equal(getattr(tc, f), getattr(ref, f)), f
    assert (tc.pixel_size, tc.resolution) == (ref.pixel_size, ref.resolution)


def _hair_cases(bsdf, mis, p_random, bounces=3):
    """Bounces of a hair walk over fur-patch hits: JAX inputs for the shade
    stage of each bounce, made from a numpy seed, with the draws of tags
    0-4 from per-pixel keys (the port gets the keys, the bounce, the hits'
    material ids and its material table). Bounce 0 starts from a mid-path
    state in every walk state; later bounces start from JAX's outputs of
    the bounce before, so rays that entered a fiber meet its inside as the
    walk does."""
    js, jc = jbuiltins.fur_patch(resolution=RES, fibers_per_face=150, fiber_verts=6,
                                 fiber_radius=0.012, bsdf=bsdf)
    w, h = RES
    r = w * h
    rs = np.random.default_rng(11)
    ids = np.arange(r)
    o, d = jcam.rays_from_pixels(jc, jnp.asarray(ids % w, jnp.float32),
                                 jnp.asarray(ids // w, jnp.float32),
                                 jnp.asarray(rs.random((r, 2), np.float32)))
    # a mid-path state: some dead rays, every walk state, MIS pdfs
    state = dict(
        origin=np.asarray(o), direction=np.asarray(d),
        radiance=rs.random((r, 3), np.float32) * (rs.random((r, 1)) > 0.1),
        color=rs.random((r, 3), np.float32) * 0.1,
        flags=rs.choice([0, 0, 8, 16, 24, 2], r).astype(np.int32),
        theta_i=rs.random(r, np.float32),
        prev_pdf=np.where(rs.random(r) < 0.3, -1.0, rs.random(r) * 3.0).astype(np.float32))
    jkeys = jrng.keys_for_pixels(jax.random.key(11), jnp.asarray(ids), 0)
    keys = rng.keys_for_pixels(rng.key(11, CPU), torch.from_numpy(ids), 0)
    mats = cshade.pack_mats_table(types.scene_from_numpy(js, device=CPU).materials)
    cases = []
    for bounce in range(bounces):
        u = {k: np.asarray(jrng.bounce_uniform(jkeys, bounce, n, tag=tag)).reshape(r, -1)
             .squeeze(-1 if n == 1 else ()) for k, n, tag in (
                 ("u_bsdf", 2, 0), ("u_pick", 1, 1), ("u_light", 2, 2), ("u_hairp", 1, 3),
                 ("u_rr", 1, 4))}
        alive = np.any(state["radiance"] != 0, -1) & np.any(state["direction"] != 0, -1)
        hit = jtraverse.closest_hit(jnp.asarray(state["origin"]),
                                    jnp.asarray(state["direction"]), js,
                                    t_max=jnp.where(alive, 3.4e38, 0.0))
        mp = jbsdf.gather_materials(js.materials, hit.mat_id, hit.uv, js.textures,
                                    js.tex_slots)
        hit_np = {k: np.asarray(getattr(hit, k)) for k in (
            "t", "valid", "position", "normal", "fiber_u", "fiber_v", "fiber_w")}
        case = dict(
            state=state, hit=hit_np, mp={k: np.asarray(getattr(mp, k)) for k in MAT_FIELDS},
            lights=np.array(jshade.pack_lights_smem(js.lights)),
            env_color=np.broadcast_to(np.asarray(js.env.color, np.float32), (r, 3)).copy(),
            env_ambient=np.asarray(js.env.ambient, np.float32), u=u,
            keys=keys, bounce=bounce, mat_id=np.asarray(hit.mat_id), mats=mats,
            n_lights=js.lights.count,
            cfg=dict(n_lights=js.lights.count, mis=mis, rr=mis, has_hair=True,
                     hair_p_random=p_random, bsdfs_present=js.bsdfs_present),
            cone=hit_np["valid"] & (np.asarray(hit.prim_type) == 1))
        cases.append(case)
        out = _jax_shade(case, "xla")
        state = {k: np.array(out[k]) for k in state}
    # the walk must exercise the automaton: cone hits in every walk state
    assert cases[0]["cone"].mean() > 0.2
    for f in (0, 8, 16, 24):
        assert any((c["cone"] & (c["state"]["flags"] == f)).any() for c in cases)
    return cases


def _jax_shade(a, mode):
    t = {k: jnp.asarray(v) for k, v in a["state"].items()}
    h = {k: jnp.asarray(v) for k, v in a["hit"].items()}
    return jshade.shade_bounce(
        **t, hit_t=h["t"], hit_valid=h["valid"], hit_pos=h["position"], hit_normal=h["normal"],
        fib_u=h["fiber_u"], fib_v=h["fiber_v"], fib_w=h["fiber_w"],
        mp_fields={k: jnp.asarray(v) for k, v in a["mp"].items()},
        env_color=jnp.asarray(a["env_color"]), env_ambient=jnp.asarray(a["env_ambient"]),
        lights_table=jnp.asarray(a["lights"]), n_lights=a["n_lights"],
        **{k: jnp.asarray(v) for k, v in a["u"].items()},
        rr_gate=jnp.ones((a["state"]["origin"].shape[0],), jnp.float32),
        cfg=JCoreCfg(**a["cfg"]), mode=mode)


def _port_shade(a):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    h = {k: t(v) for k, v in a["hit"].items()}
    return cshade.shade_bounce(
        **{k: t(v) for k, v in a["state"].items()}, hit_t=h["t"], hit_valid=h["valid"],
        hit_pos=h["position"], hit_normal=h["normal"], fib_u=h["fiber_u"],
        fib_v=h["fiber_v"], fib_w=h["fiber_w"],
        mat_id=t(a["mat_id"]), mats_table=a["mats"], keys=a["keys"], bounce=a["bounce"],
        env_color=t(a["env_color"]), env_ambient=t(a["env_ambient"]),
        lights_table=t(a["lights"]), n_lights=a["n_lights"], rr_gate=True,
        cfg=sc.CoreCfg(**a["cfg"]))


def _compare_shade(want, got, what, case=None):
    for f in STATE_FIELDS + SHADOW_FIELDS:
        _gate(want[f], got[f].numpy(), f"{what} {f}")
    # the shadow ray is defined where it is traced
    live = np.asarray(want["shadow_tmax"]) > 0
    for f in ("shadow_o", "shadow_d"):
        _gate(want[f], got[f].numpy(), f"{what} {f}", where=live)
    if case is None:
        return
    # each walk state of the automaton on its own, so that a lobe wrong on
    # a few rays cannot hide under the 2% of the whole wavefront
    cone = case["hit"]["valid"] & case["cone"]
    for state in (0, 8, 16, 24):
        rows = cone & (case["state"]["flags"] == state)
        for f in ("origin", "direction", "radiance", "flags", "theta_i"):
            _gate(want[f], got[f].numpy(), f"{what} walk state {state} {f}", where=rows)


@pytest.mark.parametrize("bsdf", ["MarschnerHairBSDF", "DEonHairBSDF"])
@pytest.mark.parametrize("mis", [False, True])
@pytest.mark.parametrize("p_random", [False, True])
def test_hair_shading_matches_jax_xla(bsdf, mis, p_random):
    for b, a in enumerate(_hair_cases(bsdf, mis, p_random)):
        refs = cshade.SHADE_REF_CALLS
        got = _port_shade(a)
        assert cshade.SHADE_REF_CALLS == refs + 1
        _compare_shade(_jax_shade(a, "xla"), got,
                       f"{bsdf} mis={mis} p_random={p_random} bounce {b}", a)


@pytest.mark.parametrize("bsdf", ["MarschnerHairBSDF", "DEonHairBSDF"])
def test_hair_shading_matches_jax_pallas_kernel(bsdf):
    for b, a in enumerate(_hair_cases(bsdf, True, True, bounces=2)):
        _compare_shade(_jax_shade(a, "kernel"), _port_shade(a), f"{bsdf} pallas bounce {b}",
                       a)


@pytest.mark.parametrize("bsdf_id", [9, 10])  # Marschner, d'Eon
def test_hair_automaton_matches_jax(bsdf_id):
    """One step of the walk (`sample_hair`) against JAX `sample_hair3` on
    random directions, normals and fiber frames, in every walk state and
    walk choice: refl, wo, pdf, flags and theta_i under the per-field gate,
    state by state (the fur-patch geometry above rarely leaves the TT and
    TRT exits a non-zero lobe)."""
    from ba_pathtracing_fur_tpu.models import shade_core as jsc

    n = 4096
    rs = np.random.default_rng(bsdf_id)

    def unit(k):
        v = rs.normal(size=(k, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    wi, nrm, fv = unit(n), unit(n), unit(n)
    fu = np.cross(fv, unit(n)).astype(np.float32)
    fu /= np.linalg.norm(fu, axis=-1, keepdims=True)
    fw = np.cross(fu, fv).astype(np.float32)
    mat = dict(diffuse=rs.uniform(0.05, 0.9, (n, 3)).astype(np.float32),
               ior=rs.uniform(1.3, 1.8, n).astype(np.float32),
               hair_alpha=rs.uniform(-10, -2, n).astype(np.float32),
               hair_beta=rs.uniform(2, 12, n).astype(np.float32),
               bsdf_id=np.full(n, bsdf_id, np.int32), shader_id=np.ones(n, np.int32))
    flags = rs.choice([0, 8, 16, 24], n).astype(np.int32)
    p_choice = rs.integers(0, 3, n).astype(np.int32)
    zeros3, zeros = np.zeros((n, 3), np.float32), np.zeros(n, np.float32)
    full = dict(specular=zeros3, volume=zeros3, emission=zeros3, transparency=zeros,
                reflectivity=zeros, roughness=zeros, **mat)

    def jv(a):
        return jsc.V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

    jm = jsc.CoreMat(**{k: jv(v) if v.ndim == 2 else jnp.asarray(v) for k, v in full.items()})
    want = jsc.sample_hair3(jm, jv(wi), jv(nrm), jv(fu), jv(fv), jv(fw), jnp.asarray(flags),
                            jnp.asarray(p_choice))
    tm = sc.CoreMat(**{k: torch.from_numpy(v) for k, v in full.items()})
    t = torch.from_numpy
    got = sc.sample_hair(tm, t(wi), t(nrm), t(fu), t(fv), t(fw), t(flags), t(p_choice))
    names = ("refl", "wo", "pdf", "flags", "theta_i")
    for name, a, b in zip(names, want, got):
        a = np.stack([a.x, a.y, a.z], -1) if isinstance(a, jsc.V3) else np.asarray(a)
        b = b.numpy()
        for state in (0, 8, 16, 24):
            rows = flags == state
            # the lobes are not all zero (TR is a pure internal reflection,
            # and d'Eon's narrow TT/TRT M terms vanish off the specular cone)
            if name == "refl" and state in ((0, 8, 24) if bsdf_id == 9 else (0,)):
                assert (np.abs(a[rows]) > 0).any(-1).mean() > 0.2, state
            _gate(a, b, f"bsdf {bsdf_id} walk state {state} {name}", where=rows)


def test_fur_patch_render_matches_jax():
    """16x16, depth 3, spp 2, no BVH: every hit through the dense grids."""
    kw = dict(depth=3, spp=2, compact=False, fused_shading=True)
    js, jc = jbuiltins.fur_patch(resolution=RES, fibers_per_face=8, fiber_verts=6)
    a = np.asarray(jpt.render_image(js, jc, jax.random.key(0),
                                    jpt.RenderConfig(**kw, ray_chunk=256)))
    refs, trav = cshade.SHADE_REF_CALLS, ctraverse.REF_CALLS
    b = pt.render_image(types.scene_from_numpy(js, device=CPU),
                        camera_from_numpy(jc, device=CPU), rng.key(0, CPU),
                        pt.RenderConfig(**kw)).numpy()
    assert cshade.SHADE_REF_CALLS - refs == kw["spp"] * kw["depth"]
    assert ctraverse.REF_CALLS == trav  # no BVH: no traversal
    _compare_images(a, b)


def _compare_images(a, b, atol_mean=5e-3, flip_frac=0.02):
    assert b.shape == a.shape and b.dtype == np.float32
    assert np.all(np.isfinite(b)) and b.max() > 0.01
    d = np.abs(a - b)
    assert np.mean(d) < atol_mean, f"mean {np.mean(d)}"
    assert np.mean(d.max(-1) > 1e-3) <= flip_frac, f"flips {np.mean(d.max(-1) > 1e-3)}"
