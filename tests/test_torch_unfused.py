"""The port's unfused bounce, function by function, against the JAX
package's on the CPU (inputs from a numpy seed, atol = rtol = 1e-5 unless
a test says otherwise):

* `models/bsdf`: the textured `gather_materials` (colour and float slots,
  ids -1 and M), `sample_surface` per BSDF id with walk flags, `eval_pdf`,
  `sample_pdf` and `evaluate_light`;
* `ops/intersect.light_hit_grid` on the four light kinds, and the light
  helpers of `models/shading`;
* `calc_direct_light` and `calc_direct_light_mis` on a SAH terrain lit by
  all four kinds (K2's any-hit twin inside);
* the sphere- and cube-map `environment_color`;
* `models/fur.sample_hair` with p_choice 0-2 in every walk state;
* one `trace_bounce`, field by field, on the terrain and the fur patch.

Two things keep a few values from 1e-5, and the tests that meet them say
so. (a) torch's and XLA's transcendentals (atan2, acos, exp) differ by an
ulp, and the reference's conditioning amplifies that in places: the
1/|cos| of a BSDF sampled at grazing, and the hair lobes' Gaussians fed
degree-valued angles (their exponent is ~(theta / beta)^2 with theta in
the tens of radians). There `_close_most` holds 99.5% of the values at
1e-5 and all of them at 1e-3. (b) A decision on a float boundary: the
non-MIS shadow ray ends on the light's own surface, so the picked light's
hit ties with t_max (ROADMAP Queue 3); those rays are counted, not held.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.core import camera as jcam, rng as jrng
from ba_pathtracing_fur_tpu.models import (
    bsdf as jbsdf, fur as jfur, pathtracer as jpt, shading as jshading,
)
from ba_pathtracing_fur_tpu.ops import intersect as jisect, traverse as jtraverse
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins, texture as jtexture, \
    types as jtypes
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import bsdf, fur, pathtracer as pt, shading
from ba_pathtracing_fur_torch.ops import bruteforce, intersect
from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse
from ba_pathtracing_fur_torch.scene import texture, types

torch.set_num_threads(2)

CPU = "cpu"
N = 2048
TOL = dict(rtol=1e-5, atol=1e-5)
MAT_FIELDS = ("diffuse", "specular", "volume", "emission", "ior", "transparency",
              "reflectivity", "roughness", "bsdf_id", "shader_id", "hair_alpha", "hair_beta")
STATE_FIELDS = ("origin", "direction", "radiance", "color", "flags", "theta_i", "prev_pdf")
HIT_FIELDS = ("t", "valid", "prim_type", "prim_id", "mat_id", "position", "normal", "uv",
              "enter", "fiber_u", "fiber_v", "fiber_w")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what,
                               **(tol or TOL))


def _close_most(got, want, what, frac=0.005):
    """At most `frac` of the values past 1e-5 (see the module doc, a), and
    every value within 1e-3."""
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    _close(a, b, what, rtol=1e-3, atol=1e-5)
    bad = np.abs(a - b) > 1e-5 + 1e-5 * np.abs(b)
    assert bad.mean() <= frac, f"{what}: {bad.mean():.4f} of the values past 1e-5"


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _mats(rs, n, bsdf_id):
    """Random per-ray material parameters, all with `bsdf_id` (an int or an
    [n] array) -> (JAX MatParams, the port's MatParams)."""
    f = {k: rs.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
         for k in ("diffuse", "specular", "volume", "emission")}
    f.update(ior=rs.uniform(1.2, 1.9, n).astype(np.float32),
             transparency=rs.uniform(0, 1, n).astype(np.float32),
             reflectivity=rs.uniform(0, 1, n).astype(np.float32),
             roughness=rs.choice([0.0, 5e-4, 0.05, 0.3, 0.9], n).astype(np.float32),
             bsdf_id=np.broadcast_to(np.asarray(bsdf_id, np.int32), (n,)).copy(),
             hair_alpha=rs.uniform(-10, -2, n).astype(np.float32),
             hair_beta=rs.uniform(2, 12, n).astype(np.float32))
    f["shader_id"] = (f["bsdf_id"] >= 9).astype(np.int32)
    return (jbsdf.MatParams(**{k: jnp.asarray(v) for k, v in f.items()}),
            bsdf.MatParams(**{k: _t(v) for k, v in f.items()}))


# ---------------------------------------------------------------------------
# Materials and BSDFs
# ---------------------------------------------------------------------------

def _textured_table():
    rs = np.random.default_rng(1)
    imgs = [rs.uniform(0, 1, (7, 9, 3)).astype(np.float32),
            rs.integers(0, 256, (12, 5, 4)).astype(np.uint8),
            rs.uniform(0, 1, (4, 4)).astype(np.float32)]
    mats = [dict(diffuse=(0.5, 0.4, 0.3), diffuse_tex=0, roughness_tex=2),
            dict(specular=(0.9, 0.8, 0.7), specular_tex=1, transparency=0.3,
                 transparency_tex=1, bsdf=3, roughness=0.2),
            dict(volume=(0.2, 0.3, 0.4), volume_tex=2, emission_tex=0, bsdf=4),
            dict(diffuse=(0.1, 0.2, 0.3))]
    return jtypes.make_material_table(mats), jtexture.build_atlas(imgs)


@pytest.mark.parametrize("slots", [bsdf.CONSUMED_TEX_SLOTS, ("diffuse",), ("roughness",
                                                                           "transparency")])
def test_textured_gather_materials_equals_jax(slots):
    table, atlas = _textured_table()
    rs = np.random.default_rng(2)
    m = table.ior.shape[0]
    mat_id = rs.integers(-1, m + 1, N).astype(np.int32)
    uv = rs.uniform(-3, 3, (N, 2)).astype(np.float32)
    want = jbsdf.gather_materials(jax.tree.map(jnp.asarray, table), jnp.asarray(mat_id),
                                  jnp.asarray(uv), atlas, slots)
    got = bsdf.gather_materials(
        types._read_fields(types.MaterialTable, table), _t(mat_id), _t(uv),
        texture.TextureAtlas(_t(atlas.images), _t(atlas.sizes)), slots)
    for f in MAT_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        _close(a, b, f, rtol=0, atol=1e-6)
    # the fetch ran: textured rows differ from the untextured table rows
    plain = bsdf.gather_materials(types._read_fields(types.MaterialTable, table), _t(mat_id))
    assert not torch.equal(plain.diffuse, got.diffuse) or "diffuse" not in slots


@pytest.mark.parametrize("bsdf_id", range(11))
def test_sample_surface_equals_jax(bsdf_id):
    """Every surface BSDF (ids 9 and 10, hair, fall through to Lambert)
    with walk flags in, with and without the `present` filter."""
    rs = np.random.default_rng(10 + bsdf_id)
    jm, tm = _mats(rs, N, bsdf_id)
    wi, n = _unit(rs, N), _unit(rs, N)
    wi[:4] = np.cross(n[:4], _unit(rs, 4))  # grazing: zero reflectance
    u = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    flags = rs.choice([0, 1, 2, 4, 8, 16, 24], N).astype(np.int32)
    for present in ((), (0, bsdf_id), (5,)):
        want = jbsdf.sample_surface(jm, jnp.asarray(wi), jnp.asarray(n), jnp.asarray(u),
                                    jnp.asarray(flags), present=present)
        got = bsdf.sample_surface(tm, _t(wi), _t(n), _t(u), _t(flags), present=present)
        for name, a, b in zip(want._fields, got, want):
            _close_most(a.numpy(), b, f"bsdf {bsdf_id} present {present} {name}")
        assert got.flags.dtype == torch.int32


def test_eval_pdf_sample_pdf_evaluate_light_equal_jax():
    rs = np.random.default_rng(3)
    jm, tm = _mats(rs, N, rs.integers(0, 11, N))
    n, wi, wo = (_unit(rs, N) for _ in range(3))
    j = [jnp.asarray(x) for x in (n, wi, wo)]
    t = [_t(x) for x in (n, wi, wo)]
    f_want, p_want = jbsdf.eval_pdf(jm, *j)
    f_got, p_got = bsdf.eval_pdf(tm, *t)
    _close(f_got, f_want, "eval_pdf f")
    _close(p_got, p_want, "eval_pdf pdf")
    assert (np.asarray(p_want) > 0).mean() > 0.05
    _close(bsdf.sample_pdf(tm, *t), jbsdf.sample_pdf(jm, *j), "sample_pdf")
    np.testing.assert_array_equal(bsdf.is_delta(tm).numpy(), np.asarray(jbsdf.is_delta(jm)))
    _close(bsdf.evaluate_light(tm, *t), jbsdf.evaluate_light(jm, *j), "evaluate_light")


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------

ALL_KINDS = [
    dict(kind="point", color=(5.0, 4.0, 3.0), position=(0.3, 1.0, -0.2), radius=0.2,
         const_att=1.0, lin_att=0.5, quad_att=0.25),
    dict(kind="quad", color=(6.0, 6.0, 6.0), position=(-0.4, 1.2, 0.1),
         direction=(0.2, -1.0, 0.1), size=(0.8, 0.5), const_att=0.0),
    dict(kind="spot", color=(3.0, 3.5, 4.0), position=(0.6, 0.9, 0.5),
         direction=(-0.3, -1.0, -0.4), radius=0.3, inner_angle=20.0, outer_angle=50.0,
         const_att=2.0),
    dict(kind="sun", color=(1.5, 1.4, 1.2), direction=(-0.4, -1.0, -0.3), radius=0.05),
]


def _lights():
    jl = jtypes.make_light_pack(ALL_KINDS)
    return jl, types._read_fields(types.LightPack, jl)


def test_light_hit_grid_equals_jax_on_four_kinds():
    """Rays from random points toward jittered points of each light (and
    random ones): t and valid per (ray, light) against JAX."""
    jl, tl = _lights()
    rs = np.random.default_rng(4)
    o = rs.uniform(-1, 1, (N, 3)).astype(np.float32)
    target = np.asarray(jl.position)[rs.integers(0, 4, N)] + rs.normal(0, 0.25, (N, 3))
    d = (target - o).astype(np.float32)
    d[::5] = _unit(rs, d[::5].shape[0])
    t_want, v_want = jisect.light_hit_grid(jnp.asarray(o), jnp.asarray(d), jl)
    t_got, v_got = intersect.light_hit_grid(_t(o), _t(d), tl)
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_want))
    _close(t_got, t_want, "light t")
    hits = np.asarray(v_want).mean(0)
    assert hits[0] > 0.05 and hits[1] > 0.05 and hits[2] > 0.05 and hits[3] == 0.0


def test_light_helpers_equal_jax():
    """sample_light_dir, light_emitted_radiance, distance_attenuation,
    quad_area, light_solid_angle_pdf and power_heuristic on every kind."""
    jl, tl = _lights()
    rs = np.random.default_rng(5)
    idx = rs.integers(0, 4, N).astype(np.int32)
    pos = rs.uniform(-1, 1, (N, 3)).astype(np.float32)
    u = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    d = _unit(rs, N)
    dist = rs.uniform(0.1, 4.0, N).astype(np.float32)
    ji, ti = jnp.asarray(idx), _t(idx)
    want = jshading.sample_light_dir(jl, ji, jnp.asarray(pos), jnp.asarray(u))
    got = shading.sample_light_dir(tl, ti, _t(pos), _t(u))
    _close(got.target, want.target, "target", rtol=1e-5, atol=1e-4)  # the sun at 1e16
    _close(got.attenuation, want.attenuation, "attenuation")
    _close(shading.light_emitted_radiance(tl, ti, _t(d)),
           jshading.light_emitted_radiance(jl, ji, jnp.asarray(d)), "emitted")
    _close(shading.distance_attenuation(tl, ti.long(), _t(dist)),
           jshading.distance_attenuation(jl, ji, jnp.asarray(dist)), "distance_attenuation")
    _close(shading.quad_area(tl, ti), jshading.quad_area(jl, ji), "quad_area")
    _close(shading.light_solid_angle_pdf(tl, ti, _t(d), _t(dist)),
           jshading.light_solid_angle_pdf(jl, ji, jnp.asarray(d), jnp.asarray(dist)), "pdf")
    pf, pg = rs.uniform(0, 5, N).astype(np.float32), rs.uniform(0, 5, N).astype(np.float32)
    _close(shading.power_heuristic(_t(pf), _t(pg)),
           jshading.power_heuristic(jnp.asarray(pf), jnp.asarray(pg)), "power_heuristic")


def _terrain_hits(lights=ALL_KINDS):
    """A 32x32 SAH terrain (2,000 triangles) lit by `lights`, its camera
    wavefront's hits in both packages, the hit fields of misses made
    finite as trace_bounce does -> (jax scene, port scene, jax hit, port
    hit, ray dirs, active)."""
    js, jc = jbuiltins.tri_terrain(resolution=(32, 32), n_tris=2000)
    js = jtraverse.attach_bvh(js.replace(lights=jtypes.make_light_pack(lights)),
                              method="sah", min_prims=1)
    ts = types.scene_from_numpy(js, device=CPU)
    w, h = jc.resolution
    ids = jnp.arange(w * h)
    keys = jrng.keys_for_pixels(jax.random.key(0), ids, 0)
    o, d = jcam.rays_from_pixels(jc, (ids % w).astype(jnp.float32),
                                 (ids // w).astype(jnp.float32),
                                 jrng.bounce_uniform(keys, -1, 2, tag=7))
    jh = jtraverse.closest_hit(o, d, js)
    v3 = jh.valid[:, None]
    jh = jh.replace(normal=jnp.where(v3, jh.normal, jnp.array([0.0, 1.0, 0.0])),
                    position=jnp.where(v3, jh.position, 0.0))
    th = bruteforce.Hit(**{f: _t(getattr(jh, f)) for f in HIT_FIELDS})
    return js, ts, jh, th, d, jh.valid


@pytest.mark.parametrize("mis", [False, True])
def test_calc_direct_light_equals_jax(mis):
    """NEE on the terrain's camera hits with one light of each kind: the
    picked light's sample, the scene occlusion (K2's any-hit twin) and the
    light-geometry occlusion. Non-MIS: on the rays whose shadow ray ends on
    a quad or spot light the picked light's own hit ties with t_max, so
    those rays are only counted (JAX blocks most of them; the port may
    resolve a few of the ties the other way); every other ray is held at
    1e-5."""
    js, ts, jh, th, d, active = _terrain_hits()
    rs = np.random.default_rng(6 + mis)
    n = d.shape[0]
    u_pick = rs.uniform(0, 1, n).astype(np.float32)
    u_light = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    mp = jbsdf.gather_materials(js.materials, jh.mat_id, jh.uv, js.textures, js.tex_slots)
    tmp = bsdf.gather_materials(ts.materials, th.mat_id, th.uv, ts.textures, ts.tex_slots)
    jfn = jshading.calc_direct_light_mis if mis else jshading.calc_direct_light
    tfn = shading.calc_direct_light_mis if mis else shading.calc_direct_light
    want = np.asarray(jfn(js, mp, jh, d, jnp.asarray(u_pick), jnp.asarray(u_light),
                          active=active))
    refs = ctraverse.REF_CALLS
    got = tfn(ts, tmp, th, _t(d), _t(u_pick), _t(u_light), active=_t(active)).numpy()
    assert ctraverse.REF_CALLS == refs + 1  # the shadow rays' any hit on the BVH
    pick = np.minimum((u_pick * 4).astype(np.int32), 3)
    tie = np.zeros(n, bool) if mis else np.isin(pick, (1, 2))
    _close(got[~tie], want[~tie], "direct")
    lit = (want > 0).any(-1)
    assert lit[~tie].mean() > 0.1 and (np.abs(got - want).max(-1) > 1e-4).mean() < 0.02


def test_environment_maps_equal_jax():
    rs = np.random.default_rng(8)
    d = _unit(rs, N)
    d[:6] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, 0, -1]]
    d[6:9] = [[0.6, 0.6, 0.0], [0.0, 0.6, -0.6], [0.6, 0.0, 0.6]]  # face ties
    sphere = rs.uniform(0, 1, (9, 17, 3)).astype(np.float32)
    cube = rs.uniform(0, 1, (6, 8, 11, 3)).astype(np.float32)
    for kind, tex in ((jtypes.ENV_SPHERE_MAP, sphere), (jtypes.ENV_CUBE_MAP, cube)):
        want = jshading.environment_color(
            jtypes.Environment(kind=kind, texture=jnp.asarray(tex)), jnp.asarray(d))
        got = shading.environment_color(types.Environment(kind=kind, texture=_t(tex)), _t(d))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(kind))


@pytest.mark.parametrize("bsdf_id", [9, 10])  # Marschner, d'Eon
def test_sample_hair_equals_jax_fur(bsdf_id):
    """One step of the walk against JAX models/fur.sample_hair (native
    trig, the unfused path's): p_choice 0-2 in every walk state (flags 0,
    T, TR, T|TR)."""
    rs = np.random.default_rng(20 + bsdf_id)
    jm, tm = _mats(rs, N, bsdf_id)
    wi, n, fv = _unit(rs, N), _unit(rs, N), _unit(rs, N)
    fu = np.cross(fv, _unit(rs, N))
    fu = (fu / np.linalg.norm(fu, axis=-1, keepdims=True)).astype(np.float32)
    fw = np.cross(fu, fv).astype(np.float32)
    flags = rs.choice([0, 8, 16, 24], N).astype(np.int32)
    p_choice = rs.integers(0, 3, N).astype(np.int32)
    args = (wi, n, fu, fv, fw, flags, p_choice)
    want = jfur.sample_hair(jm, *(jnp.asarray(a) for a in args))
    got = fur.sample_hair(tm, *(_t(a) for a in args))
    for name, a, b in zip(want._fields, got, want):
        _close_most(a.numpy(), b, f"bsdf {bsdf_id} {name}")
    assert (np.abs(np.asarray(want.reflectance)) > 0).any(-1).mean() > 0.1
    for fn, jfn in ((fur.marschner_sample, jfur.marschner_sample),
                    (fur.deon_sample, jfur.deon_sample)):
        _close_most(fn(tm, *(_t(a) for a in args)).wo,
                    jfn(jm, *(jnp.asarray(a) for a in args)).wo, fn.__name__)


# ---------------------------------------------------------------------------
# One bounce
# ---------------------------------------------------------------------------

def _bounce_inputs(js, jc, cfg, bounce):
    """The state and keys of `bounce` of a sample (JAX's bounces before it),
    in both packages."""
    w, h = jc.resolution
    ids = jnp.arange(w * h)
    keys = jrng.keys_for_pixels(jax.random.key(0), ids, 0)
    o, d = jcam.rays_from_pixels(jc, (ids % w).astype(jnp.float32),
                                 (ids // w).astype(jnp.float32),
                                 jrng.bounce_uniform(keys, -1, 2, tag=7))
    state = jpt.init_state(o, d)
    for b in range(bounce):
        state = jpt.trace_bounce(state, js, keys, b, cfg)
    tstate = pt.RayState(**{f: _t(getattr(state, f)) for f in STATE_FIELDS})
    tkeys = rng.keys_for_pixels(rng.key(0, CPU), torch.arange(w * h), 0)
    return state, keys, tstate, tkeys


@pytest.mark.parametrize("scene,bounce,opts", [
    ("terrain", 0, {}), ("terrain", 1, dict(mis=True, rr=True)),
    ("fur", 0, dict(hair_p_random=True)), ("fur", 1, dict(hair_p_random=True, mis=True))])
def test_trace_bounce_equals_jax(scene, bounce, opts):
    """One unfused bounce, field by field, from the same state and keys.
    Non-MIS NEE's tie (see the module doc) moves a few rays' colour: the
    colour is held at 1e-5 on 98% of the rays, every other field on all."""
    if scene == "terrain":
        js, jc = jbuiltins.tri_terrain(resolution=(24, 24), n_tris=2000)
        js = jtraverse.attach_bvh(js, method="sah", min_prims=1)
    else:
        js, jc = jbuiltins.fur_patch(resolution=(16, 16), fibers_per_face=8, fiber_verts=6)
    cfg_kw = dict(depth=4, spp=1, compact=False, **opts)
    jcfg = jpt.RenderConfig(**cfg_kw, ray_chunk=1024)
    state, jkeys, tstate, tkeys = _bounce_inputs(js, jc, jcfg, bounce)
    want = jpt.trace_bounce(state, js, jkeys, bounce, jcfg)
    ts = types.scene_from_numpy(js, device=CPU)
    got = pt.trace_bounce(tstate, ts, tkeys, bounce, pt.RenderConfig(**cfg_kw))
    for f in STATE_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        if f == "color" and not opts.get("mis"):
            bad = (np.abs(a - b) > 1e-5 + 1e-5 * np.abs(b)).reshape(a.shape[0], -1).any(-1)
            assert bad.mean() <= 0.02, f"{f}: {bad.mean()}"
        else:
            _close(a, b, f)
    assert (np.asarray(want.color) > 0).any(-1).mean() > 0.2


def test_trace_bounce_runs_the_traversal_twin_on_a_bvh():
    """On a BVH the bounce's closest hit and its NEE any-hit each run K2's
    twin once (CPU tensors), and no shade stage."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins

    ts, tc = builtins.tri_terrain(resolution=(8, 8), n_tris=2000, device=CPU)
    ts = dataclasses.replace(ts, lights=types._to(types.make_light_pack(ALL_KINDS), CPU))
    from ba_pathtracing_fur_torch.ops import traverse
    ts = traverse.attach_bvh(ts, method="sah", min_prims=1)
    cfg = pt.RenderConfig(depth=3, spp=2, compact=False)
    counts = (ctraverse.REF_CALLS, cshade.SHADE_REF_CALLS, cshade.REF_CALLS)
    img = pt.render_image(ts, tc, rng.key(0, CPU), cfg)
    assert ctraverse.REF_CALLS - counts[0] == 2 * cfg.spp * cfg.depth
    assert (cshade.SHADE_REF_CALLS, cshade.REF_CALLS) == counts[1:]
    assert torch.isfinite(img).all() and img.max() > 0.01
