"""The shade stage K1 takes keys and material ids: its plain version
against the JAX package on the CPU.

* `ops/cuda/shade.shade_bounce_ref`, which draws the bounce's uniforms from
  each ray's threefry key and reads each ray's material row itself, against
  JAX `ops/pallas/shade.shade_bounce(mode="xla")` fed the draws
  `rng.bounce_uniform` makes from the same keys (tags 0-4) and the rows of
  `bsdf.gather_materials`: fur-patch wavefronts, bounces 0-2, Marschner and
  d'Eon, `hair_p_random`, MIS and RR on and off, under the per-field gate
  of tests/test_torch_shade.py::_gate.
* Material ids at -1, 0, M-1 and M: the port's gathers (`gather_rows` of
  the packed table, `gather_materials` of the MaterialTable), and the shade
  stage on them, against JAX's jnp gather (a negative id wraps, one past the end
  clamps).
* `models/pathtracer.shade_inputs` makes no threefry draw and no material
  gather: both happen inside the shade stage.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.core import rng as jrng
from ba_pathtracing_fur_tpu.models import bsdf as jbsdf
from ba_pathtracing_fur_tpu.models.shade_core import CoreCfg as JCoreCfg
from ba_pathtracing_fur_tpu.ops.pallas import shade as jshade
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import bsdf, pathtracer as pt
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
from ba_pathtracing_fur_torch.scene import builtins

torch.set_num_threads(2)

CPU = "cpu"
RES = (16, 16)
FUR = dict(resolution=RES, fibers_per_face=200)
STATE_FIELDS = ("origin", "direction", "radiance", "color", "flags", "theta_i", "prev_pdf")
MAT_FIELDS = ("diffuse", "specular", "volume", "emission", "ior", "transparency",
              "reflectivity", "roughness", "bsdf_id", "shader_id", "hair_alpha", "hair_beta")
#: JAX's gather as its render runs it: jitted, so the ids index as jnp does
JAX_GATHER = jax.jit(jbsdf.gather_materials)
HIT_ARGS = dict(hit_t="t", hit_valid="valid", hit_pos="position", hit_normal="normal",
                fib_u="fiber_u", fib_v="fiber_v", fib_w="fiber_w")


def _gate(a, b, what, where=None):
    """The gate of test_fused_single_bounce_exact: < 2% of values off by
    more than 1e-4 + 1e-4|a| (isolated float-boundary decision flips)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    if where is not None:
        a, b = a[where], b[where]
    bad = np.abs(a - b) > 1e-4 + 1e-4 * np.abs(a)
    assert not bad.size or bad.mean() < 0.02, f"{what}: {bad.mean():.4f} mismatched"


def _jax_draws(jkeys, bounce, rr):
    """The draws of JAX's general branch (models/pathtracer.py:366-371)."""
    def draw(n, tag):
        return jrng.bounce_uniform(jkeys, bounce, n, tag=tag)

    u_pick = draw(1, 1)[:, 0]
    return dict(u_bsdf=draw(2, 0), u_pick=u_pick, u_light=draw(2, 2),
                u_hairp=draw(1, 3)[:, 0], u_rr=draw(1, 4)[:, 0] if rr else jnp.zeros_like(u_pick))


def _jax_shade(kw, js, jkeys, cfg):
    """JAX's shade stage on the port's inputs `kw`, with its own draws from
    `jkeys` and its own gather of the hits' material ids."""
    n = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    r = kw["origin"].shape[0]
    mp = JAX_GATHER(js.materials, n(kw["mat_id"]))
    env = kw["env_color"].expand(r, 3).contiguous()
    return jshade.shade_bounce(
        **{f: n(kw[f]) for f in STATE_FIELDS}, **{a: n(kw[a]) for a in HIT_ARGS},
        mp_fields={f: getattr(mp, f) for f in MAT_FIELDS}, env_color=n(env),
        env_ambient=n(kw["env_ambient"]), lights_table=jshade.pack_lights_smem(js.lights),
        n_lights=js.lights.count, **_jax_draws(jkeys, kw["bounce"], cfg.rr),
        rr_gate=jnp.full((r,), 1.0 if kw["rr_gate"] else 0.0, jnp.float32),
        cfg=JCoreCfg(n_lights=js.lights.count, mis=cfg.mis, rr=cfg.rr, has_hair=True,
                     hair_p_random=cfg.hair_p_random, bsdfs_present=js.bsdfs_present),
        mode="xla")


def _compare(want, got, what):
    for f in STATE_FIELDS + ("shadow_tmax", "direct_rgb"):
        _gate(want[f], got[f].numpy(), f"{what} {f}")
    live = np.asarray(want["shadow_tmax"]) > 0  # the shadow ray where it is traced
    for f in ("shadow_o", "shadow_d"):
        _gate(want[f], got[f].numpy(), f"{what} {f}", where=live)


def _fur(bsdf_name):
    """The fur patch in both packages, the port's with its cone BVH."""
    js, _ = jbuiltins.fur_patch(**FUR, bsdf=bsdf_name)
    ts, cam = builtins.fur_patch(**FUR, bsdf=bsdf_name, device=CPU)
    return js, traverse.attach_bvh(ts), cam


@pytest.mark.parametrize("bsdf_name", ["MarschnerHairBSDF", "DEonHairBSDF"])
@pytest.mark.parametrize("mis,rr", [(False, False), (True, False), (False, True),
                                    (True, True)])
@pytest.mark.parametrize("p_random", [False, True])
def test_shade_from_keys_matches_jax(bsdf_name, mis, rr, p_random):
    """Bounces 0-2 of a fur-patch wavefront from the camera (RR gated on
    from bounce 1): the port's shade stage from keys and material ids
    against JAX's from its own draws and gather of the same keys and hits."""
    js, ts, cam = _fur(bsdf_name)
    cfg = pt.RenderConfig(depth=3, spp=1, compact=False, fused_shading=True, mis=mis, rr=rr,
                          rr_start=1, hair_p_random=p_random)
    ids = torch.arange(RES[0] * RES[1])
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, CPU), [0], cfg)
    jkeys = jrng.keys_for_pixels(jax.random.key(0), jnp.asarray(ids.numpy()), 0)
    tables = pt.BounceTables.of(ts)
    cones = 0
    for bounce in range(3):
        alive = (state.radiance != 0).any(-1) & (state.direction != 0).any(-1)
        hit = traverse.closest_hit(state.origin, state.direction, ts,
                                   t_max=torch.where(alive, traverse.INF, 0.0))
        cones += int((hit.valid & (hit.prim_type == 1)).sum())
        kw = pt.shade_inputs(state, ts, keys, bounce, cfg, hit, tables)
        refs = cshade.SHADE_REF_CALLS
        got = cshade.shade_bounce(**kw)
        assert cshade.SHADE_REF_CALLS == refs + 1
        _compare(_jax_shade(kw, js, jkeys, cfg), got, f"{bsdf_name} bounce {bounce}")
        state = pt.RayState(**{f: got[f] for f in STATE_FIELDS})
    assert cones > 0.2 * RES[0] * RES[1]  # the walk runs on fiber hits


def _edge_ids(m):
    return torch.tensor([-1, 0, m - 1, m, 0, -1, m, m - 1] * 8, dtype=torch.int32)


def test_material_ids_follow_jax_gather():
    """Ids -1, 0, M-1 and M read the rows JAX's jnp gather reads."""
    js, ts, _ = _fur("MarschnerHairBSDF")
    table = pt.BounceTables.of(ts).mats
    ids = _edge_ids(table.shape[0])
    want = JAX_GATHER(js.materials, jnp.asarray(ids.numpy()))
    assert table.shape[0] == js.materials.bsdf_id.shape[0] > 1
    for got in (bsdf.gather_rows(table, ids), bsdf.gather_materials(ts.materials, ids)):
        for f in MAT_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
    assert bsdf.material_index(ids, table.shape[0]).tolist()[:4] == [
        table.shape[0] - 1, 0, table.shape[0] - 1, table.shape[0] - 1]


def test_shade_with_edge_material_ids_matches_jax():
    """The shade stage on hits whose ids sit at -1, 0, M-1 and M (the main
    path's Hit assembly gives 0 on a miss and never reaches them) against
    JAX on the same ids."""
    js, ts, cam = _fur("MarschnerHairBSDF")
    cfg = pt.RenderConfig(depth=1, spp=1, compact=False, fused_shading=True, mis=True)
    ids = torch.arange(RES[0] * RES[1])
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, CPU), [0], cfg)
    jkeys = jrng.keys_for_pixels(jax.random.key(0), jnp.asarray(ids.numpy()), 0)
    tables = pt.BounceTables.of(ts)
    hit = traverse.closest_hit(state.origin, state.direction, ts)
    m = tables.mats.shape[0]
    hit = dataclasses.replace(hit, mat_id=_edge_ids(m).repeat(ids.shape[0] // 64))
    kw = pt.shade_inputs(state, ts, keys, 0, cfg, hit, tables)
    _compare(_jax_shade(kw, js, jkeys, cfg), cshade.shade_bounce(**kw), "edge ids")


def test_shade_inputs_make_no_draws_and_no_gather(monkeypatch):
    """The general branch hands the shade stage keys, the bounce, material
    ids and the material table: no threefry draw and no gather before it."""
    _, ts, cam = _fur("MarschnerHairBSDF")
    cfg = pt.RenderConfig(depth=1, spp=1, compact=False, fused_shading=True, rr=True)
    state, keys = pt.camera_wavefront(cam, torch.arange(RES[0] * RES[1]), rng.key(0, CPU),
                                      [0], cfg)
    hit = traverse.closest_hit(state.origin, state.direction, ts)
    tables = pt.BounceTables.of(ts)

    def refuse(*a, **k):
        raise AssertionError("drawn or gathered before the shade stage")

    for mod, name in ((rng, "bounce_uniforms"), (rng, "bounce_uniform"), (rng, "uniform"),
                      (bsdf, "gather_materials"), (bsdf, "gather_rows")):
        monkeypatch.setattr(mod, name, refuse)
    kw = pt.shade_inputs(state, ts, keys, 2, cfg, hit, tables)
    assert kw["keys"] is keys and kw["bounce"] == 2 and kw["mats_table"] is tables.mats
    assert torch.equal(kw["mat_id"], hit.mat_id)
    assert not {"mp", "u_bsdf", "u_pick", "u_light", "u_hairp", "u_rr"} & set(kw)


def test_work_ref_counts_hit_bytes_only_where_read():
    """K1's bound (`cshade.work_ref`) reads the hit's t and flag on live rays
    and its point, normal, id, key and fiber frame on geometry hits only;
    with every ray dead it counts no per-ray hit byte and no draw."""
    _, ts, cam = _fur("MarschnerHairBSDF")
    cfg = pt.RenderConfig(depth=1, spp=1, compact=False, fused_shading=True, rr=True)
    r = RES[0] * RES[1]
    state, keys = pt.camera_wavefront(cam, torch.arange(r), rng.key(0, CPU), [0], cfg)
    hit = traverse.closest_hit(state.origin, state.direction, ts)
    tables = pt.BounceTables.of(ts)
    kw = pt.shade_inputs(state, ts, keys, 0, cfg, hit, tables)
    cls = cshade.branch_classes(kw)
    w = cshade.work_ref(kw, cshade.shade_bounce(**kw))
    assert sum(w["classes"].values()) == r and w["classes"]["miss"] > 0
    live, geom = int((cls != cshade.DEAD).sum()), int((cls >= cshade.SURFACE).sum())
    assert 0 < geom < live
    # t 4 + valid 1; point, normal 12 each, id 4, key 16, fiber frame 36
    assert w["all_bytes"] - w["bytes"] == (r - live) * 5 + (r - geom) * 80
    dead = dict(kw, radiance=torch.zeros_like(kw["radiance"]))
    wd = cshade.work_ref(dead, cshade.shade_bounce(**dead))
    assert wd["classes"]["dead"] == r and wd["int_ops"] == 0
    assert wd["all_bytes"] - wd["bytes"] == r * 85
