"""The port's plain-torch shading body and full bounce against the JAX package.

* `models/shade_core.shade_bounce_core` vs JAX `shade_bounce(mode="xla")`,
  field by field, from the same hits, materials, ray state and uniforms
  (made from a numpy seed), on the Cornell materials and on a table of all
  nine surface BSDFs lit by a quad, a point, a spot and a sun light.
* `ops/cuda/shade.shade_bounce_full_ref` vs JAX `shade_bounce_full` (the
  Pallas kernel in interpret mode) for bounces 0-2 from a camera wavefront,
  with the per-field gate of tests/test_fused_shade.py.
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
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins, types as jtypes
from ba_pathtracing_fur_torch.models import shade_core as sc
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
from ba_pathtracing_fur_torch.scene.types import scene_from_numpy

torch.set_num_threads(2)

RES = (16, 16)
STATE_FIELDS = ("origin", "direction", "radiance", "color", "flags", "theta_i", "prev_pdf")
SHADOW_FIELDS = ("shadow_o", "shadow_d", "shadow_tmax", "direct_rgb")


def _gate(a, b, what):
    """The gate of test_fused_single_bounce_exact: < 2% of values off by
    more than 1e-4 + 1e-4|a| (isolated float-boundary decision flips)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    bad = np.abs(a - b) > 1e-4 + 1e-4 * np.abs(a)
    assert bad.mean() < 0.02, f"{what}: {bad.mean():.4f} mismatched"


def _all_bsdf_scene():
    """Cornell geometry with all nine surface BSDFs and four light kinds."""
    js, jc = jbuiltins.cornell_box(resolution=RES)
    mats = [dict(bsdf=b, diffuse=(0.7, 0.5, 0.3), specular=(0.9, 0.8, 0.7),
                 volume=(0.8, 0.9, 1.0), emission=(2.0, 1.5, 1.0), ior=1.45,
                 roughness=0.35) for b in range(9)]
    table = jtypes.make_material_table(mats)
    mat_id = np.random.default_rng(4).integers(0, 9, js.tris.count).astype(np.int32)
    lights = jtypes.make_light_pack([
        dict(kind="quad", color=(6.0, 6.0, 6.0), position=(0.0, 0.98, 0.0),
             direction=(0.0, -1.0, 0.0), size=(0.5, 0.5)),
        dict(kind="point", color=(2.0, 1.0, 1.0), position=(-0.5, 0.5, 0.3), radius=0.1),
        dict(kind="spot", color=(1.0, 2.0, 1.0), position=(0.5, 0.8, 0.2),
             direction=(-0.2, -1.0, 0.0), radius=0.2, inner_angle=20.0, outer_angle=40.0),
        dict(kind="sun", color=(0.3, 0.3, 0.5), direction=(0.3, -1.0, 0.2), radius=0.05),
    ])
    js = js.replace(tris=js.tris.replace(mat_id=mat_id), materials=table, lights=lights,
                    env=jtypes.Environment(color=np.array([0.2, 0.3, 0.4], np.float32),
                                           ambient=np.array([0.1, 0.1, 0.1], np.float32)),
                    bsdfs_present=jtypes.scene_bsdfs_present(table))
    return js, jc


def _scene(name):
    if name == "all_bsdfs":
        return _all_bsdf_scene()
    return jbuiltins.cornell_box(resolution=RES, variant=name)


@pytest.mark.parametrize("name,mis,rr", [
    ("diffuse", False, False), ("glossy", True, True),
    ("all_bsdfs", False, False), ("all_bsdfs", True, True)])
def test_shade_core_matches_jax_xla(name, mis, rr):
    js, jc = _scene(name)
    w, h = RES
    r = w * h
    rs = np.random.default_rng(7)
    ids = np.arange(r)
    o, d = jcam.rays_from_pixels(jc, jnp.asarray(ids % w, jnp.float32),
                                 jnp.asarray(ids // w, jnp.float32),
                                 jnp.asarray(rs.random((r, 2), np.float32)))
    # a mid-path state: some dead rays, mixed flags and MIS pdfs
    radiance = rs.random((r, 3), np.float32) * (rs.random((r, 1)) > 0.1)
    color = rs.random((r, 3), np.float32) * 0.1
    flags = rs.choice([0, 1, 2, 3], r).astype(np.int32)
    theta_i = rs.random(r, np.float32)
    prev_pdf = np.where(rs.random(r) < 0.3, -1.0, rs.random(r) * 3.0).astype(np.float32)
    u = {k: rs.random(shape, np.float32) for k, shape in (
        ("u_bsdf", (r, 2)), ("u_pick", (r,)), ("u_light", (r, 2)), ("u_hairp", (r,)),
        ("u_rr", (r,)))}

    do_trace = np.any(radiance != 0, -1)
    hit = jtraverse.closest_hit(o, d, js, t_max=jnp.where(do_trace, 3.4e38, 0.0))
    mp = jbsdf.gather_materials(js.materials, hit.mat_id, hit.uv, js.textures, js.tex_slots)
    mp_fields = {k: np.asarray(getattr(mp, k)) for k in (
        "diffuse", "specular", "volume", "emission", "ior", "transparency", "reflectivity",
        "roughness", "bsdf_id", "shader_id", "hair_alpha", "hair_beta")}
    lights_table = np.array(jshade.pack_lights_smem(js.lights))
    env_color = np.broadcast_to(np.asarray(js.env.color, np.float32), (r, 3)).copy()
    env_ambient = np.asarray(js.env.ambient, np.float32)
    hit_np = {k: np.asarray(getattr(hit, k)) for k in (
        "t", "valid", "position", "normal", "fiber_u", "fiber_v", "fiber_w")}
    state = dict(origin=np.asarray(o), direction=np.asarray(d), radiance=radiance,
                 color=color, flags=flags, theta_i=theta_i, prev_pdf=prev_pdf)

    want = jshade.shade_bounce(
        **{k: jnp.asarray(v) for k, v in state.items()},
        hit_t=jnp.asarray(hit_np["t"]), hit_valid=jnp.asarray(hit_np["valid"]),
        hit_pos=jnp.asarray(hit_np["position"]), hit_normal=jnp.asarray(hit_np["normal"]),
        fib_u=jnp.asarray(hit_np["fiber_u"]), fib_v=jnp.asarray(hit_np["fiber_v"]),
        fib_w=jnp.asarray(hit_np["fiber_w"]),
        mp_fields={k: jnp.asarray(v) for k, v in mp_fields.items()},
        env_color=jnp.asarray(env_color), env_ambient=jnp.asarray(env_ambient),
        lights_table=jnp.asarray(lights_table), n_lights=js.lights.count,
        **{k: jnp.asarray(v) for k, v in u.items()}, rr_gate=jnp.ones((r,), jnp.float32),
        cfg=JCoreCfg(n_lights=js.lights.count, mis=mis, rr=rr, has_hair=False,
                     bsdfs_present=js.bsdfs_present),
        mode="xla")

    t = {k: torch.from_numpy(np.array(v)) for k, v in
         {**state, **hit_np, **mp_fields, **u}.items()}
    got = sc.shade_bounce_core(
        **{k: t[k] for k in STATE_FIELDS}, hit_t=t["t"], hit_valid=t["valid"],
        hit_pos=t["position"], hit_normal=t["normal"],
        mp=sc.CoreMat(**{k: t[k] for k in mp_fields}),
        env_color=torch.from_numpy(env_color), env_ambient=torch.from_numpy(env_ambient),
        lights=cshade.core_lights(torch.from_numpy(lights_table)),
        u_bsdf1=t["u_bsdf"][:, 0], u_bsdf2=t["u_bsdf"][:, 1], u_pick=t["u_pick"],
        u_light1=t["u_light"][:, 0], u_light2=t["u_light"][:, 1], u_rr=t["u_rr"],
        rr_gate=True, cfg=sc.CoreCfg(n_lights=js.lights.count, mis=mis, rr=rr,
                                     bsdfs_present=js.bsdfs_present))
    assert np.asarray(hit_np["valid"]).mean() > 0.5
    for f in STATE_FIELDS + SHADOW_FIELDS:
        _gate(want[f], getattr(got, f).numpy(), f"{name} {f}")


def test_hair_raises_naming_roadmap():
    with pytest.raises(NotImplementedError, match="K1"):
        sc.shade_bounce_core(
            origin=None, direction=None, radiance=None, color=None, flags=None,
            theta_i=None, prev_pdf=None, hit_t=None, hit_valid=None, hit_pos=None,
            hit_normal=None, mp=None, env_color=None, env_ambient=None, lights=[],
            u_bsdf1=None, u_bsdf2=None, u_pick=None, u_light1=None, u_light2=None,
            u_rr=None, rr_gate=False, cfg=sc.CoreCfg(n_lights=0, has_hair=True))


def test_full_bounce_ref_matches_jax_pallas():
    """Bounces 0-2 from a camera wavefront on the glossy Cornell with MIS
    and RR: the plain full bounce vs the JAX Pallas kernel (interpret mode)
    on the same state and uniforms. The diffuse path is held to JAX by the
    render test in test_torch_pathtracer.py."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    js, jc = jbuiltins.cornell_box(resolution=(12, 12), variant="glossy")
    ts = scene_from_numpy(js)
    r = 144
    ids = jnp.arange(r)
    keys = jrng.keys_for_pixels(jax.random.key(3), ids, 0)
    o, d = jcam.rays_from_pixels(jc, (ids % 12).astype(jnp.float32),
                                 (ids // 12).astype(jnp.float32),
                                 jrng.bounce_uniform(keys, -1, 2, tag=7))
    st = jpt.init_state(o, d)
    kw = dict(depth=3, spp=1, compact=False, fused_shading=True, mis=True, rr=True)
    cfg, tcfg = jpt.RenderConfig(**kw), pt.RenderConfig(**kw)
    tkeys = rng.keys_for_pixels(rng.key(3), torch.arange(r), 0)
    # the Pallas kernel; a traced bounce compiles the interpret-mode kernel once
    jax_bounce = jax.jit(lambda s, b: jpt.trace_bounce_fused(s, js, keys, b, cfg))
    for bounce in range(3):
        want = jax_bounce(st, jnp.int32(bounce))
        tst = pt.RayState(**{f: torch.from_numpy(np.array(getattr(st, f)))
                             for f in STATE_FIELDS})
        before = cshade.REF_CALLS
        got = pt.trace_bounce_fused(tst, ts, tkeys, bounce, tcfg)
        assert cshade.REF_CALLS == before + 1
        for f in STATE_FIELDS:
            _gate(getattr(want, f), getattr(got, f).numpy(), f"bounce {bounce} {f}")
        st = want
