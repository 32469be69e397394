"""The port's multi-device layer (`parallel/`) on a mesh of CPU devices.

* The sharded render against the port's unsharded `render_image`, at the
  JAX package's tolerance (tests/test_parallel.py: rtol 2e-5, atol 2e-6) on
  its cases: dp 8 and dp 2 x geo 4 on a 32x32 Cornell, the fur patch at geo
  2, a replicated BVH, per-shard BVHs (also through the fused bounce), and
  the capacity axis (`required_geo` == 2, and its ValueError past max_geo).
* Against the JAX package: one sharded render under the image gate of
  tests/test_fused_shade.py::_compare, and exactly: `_merge_hits_over_geo`
  on crafted Hits with triangle/cone ties across shards, `pad_scene_geo`'s
  and `shard_scene_bvh`'s packs and stacked BVH arrays, `scene_geo_bytes`.
* `train_step`: the loss falls over 2 steps; `loss_fn`'s gradients equal
  those of the unsharded render's loss within 1e-6 of the largest.
* `make_mesh`, `multihost_initialize`, `measure_scaling` and the scaling
  module's command line.

The JAX package is imported inside the tests that compare with it, so the
`cuda`-marked test (the geo merge on the card) runs where there is no jax:
`python -m pytest tests/test_torch_parallel.py -m cuda --noconftest -p no:cacheprovider`.
"""

import dataclasses
import json
import socket

import numpy as np
import pytest
import torch

from ba_pathtracing_fur_torch import parallel as par
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import bruteforce, traverse
from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, traverse as ctraverse
from ba_pathtracing_fur_torch.parallel import render as prender, scaling
from ba_pathtracing_fur_torch.scene import builtins

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = pt.RenderConfig(depth=3, spp=2, ray_chunk=4096)
FUR_CFG = pt.RenderConfig(depth=3, spp=1, ray_chunk=1024)
RTOL, ATOL = 2e-5, 2e-6


def _mesh(n, geo):
    return par.make_mesh(n, geo=geo, devices=[CPU] * 8)


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def cornell():
    return builtins.cornell_box(resolution=(32, 32), device=CPU)


@pytest.mark.parametrize("dp_geo", [(8, 1), (2, 4)])
def test_cornell_sharded_matches_unsharded(cornell, dp_geo):
    scene, cam = cornell
    key = rng.key(3, CPU)
    ref = pt.render_image(scene, cam, key, CFG)
    dp, geo = dp_geo
    mesh = _mesh(dp * geo, geo)
    assert mesh.shape == {"dp": dp, "geo": geo}
    _close(par.render_image_sharded(scene, cam, key, CFG, mesh), ref)


def _fur(fibers_per_face, fiber_verts):
    return builtins.fur_patch(resolution=(16, 16), fibers_per_face=fibers_per_face,
                              fiber_verts=fiber_verts, device=CPU)


def test_fur_geo2_matches_unsharded():
    scene, cam = _fur(2, 3)
    key = rng.key(11, CPU)
    ref = pt.render_image(scene, cam, key, FUR_CFG)
    _close(par.render_image_sharded(scene, cam, key, FUR_CFG, _mesh(8, 2)), ref)


def test_dp_with_replicated_bvh_matches_unsharded():
    scene, cam = _fur(8, 4)
    scene = traverse.attach_bvh(scene, method="median", min_prims=1)
    key = rng.key(5, CPU)
    ref = pt.render_image(scene, cam, key, FUR_CFG)
    _close(par.render_image_sharded(scene, cam, key, FUR_CFG, _mesh(8, 1)), ref)


@pytest.mark.parametrize("fused", [False, True])
def test_geo_with_per_shard_bvhs_matches_unsharded(fused):
    scene, cam = _fur(8, 4)
    cfg = dataclasses.replace(FUR_CFG, fused_shading=fused)
    key = rng.key(5, CPU)
    ref = pt.render_image(traverse.attach_bvh(scene, method="median", min_prims=1), cam, key,
                          cfg)
    sharded = prender.shard_scene_bvh(scene, 4, method="median")
    assert sharded.cone_bvh is not None and sharded.cone_bvh.geo_stacked
    assert sharded.cone_bvh.bmin.shape[0] == 4
    assert prender.scene_partition_specs(sharded)["cone_bvh"] == par.GEO_AXIS
    _close(par.render_image_sharded(sharded, cam, key, cfg, _mesh(8, 4)), ref)


def test_geo_capacity_axis():
    scene, cam = _fur(16, 4)
    need = prender.scene_geo_bytes(scene)
    budget = need // 2 + 1024
    assert need > budget
    g = prender.required_geo(scene, budget)
    assert g == 2
    half = dataclasses.replace(scene, tris=prender._slice_pack(scene.tris, 0, 1),
                               cones=prender._slice_pack(scene.cones, 0,
                                                         scene.cones.count // g))
    assert prender.scene_geo_bytes(half) <= budget
    key = rng.key(5, CPU)
    cfg = pt.RenderConfig(depth=2, spp=1, ray_chunk=1024)
    ref = pt.render_image(scene, cam, key, cfg)
    _close(par.render_image_sharded(scene, cam, key, cfg, _mesh(8, g)), ref)
    with pytest.raises(ValueError):
        prender.required_geo(scene, 1024, max_geo=4)


@pytest.mark.parametrize("bvh", [False, True])
def test_merged_hit_equals_the_unsharded_hit(bvh):
    """The merged camera-wavefront Hit of 3 geo shards (the 64-cone pack
    padded by two inert cones) against the unsharded scene's: every field
    bit for bit, prim_id global, without BVHs (K5's twin or the dense grid
    a shard) and with one a shard (against a BVH over the whole scene)."""
    scene, cam = _fur(8, 5)
    ref_scene = traverse.attach_bvh(scene, method="median", min_prims=1) if bvh else scene
    sharded = prender.shard_scene_bvh(scene, 3) if bvh else prender.pad_scene_geo(scene, 3)
    assert prender.pad_scene_geo(scene, 3).cones.count == scene.cones.count + 2
    state, _ = pt.camera_wavefront(cam, torch.arange(16 * 16), rng.key(1, CPU), [0], FUR_CFG)
    o, d = state.origin, state.direction
    want = traverse.closest_hit(o, d, ref_scene)
    got = prender.geo_closest_fn(prender.geo_shards(sharded, 3))(o, d, None)
    assert want.valid.any() and (want.prim_type == bruteforce.PRIM_CONE).any()
    for f in dataclasses.fields(bruteforce.Hit):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


def test_a_replicated_bvh_cannot_be_split_over_geo():
    scene, cam = _fur(8, 4)
    scene = traverse.attach_bvh(scene, method="median", min_prims=1)
    with pytest.raises(ValueError, match="shard_scene_bvh"):
        par.render_image_sharded(scene, cam, rng.key(0, CPU), FUR_CFG, _mesh(2, 2))


def test_sharded_render_matches_jax_under_the_image_gate(cornell):
    """dp 2 x geo 4 against the JAX package's `render_image` of the same
    Cornell box and key (tests/test_fused_shade.py::_compare's gate)."""
    import jax

    from ba_pathtracing_fur_tpu.models import pathtracer as jpt
    from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins

    js, jc = jbuiltins.cornell_box(resolution=(32, 32))
    jcfg = jpt.RenderConfig(depth=3, spp=2, ray_chunk=4096)
    want = np.asarray(jpt.render_image(js, jc, jax.random.key(3), jcfg))
    scene, cam = cornell
    got = par.render_image_sharded(scene, cam, rng.key(3, CPU), CFG, _mesh(8, 4)).numpy()
    assert np.all(np.isfinite(got))
    d = np.abs(got - want)
    assert np.mean(d) < 5e-3, np.mean(d)
    assert np.mean(d.max(-1) > 1e-3) <= 0.02, np.mean(d.max(-1) > 1e-3)


def _crafted_hits(n_geo=4, r=64, seed=0):
    """Per-shard Hits as numpy: t drawn from few values so shards tie, ties
    between a triangle and a cone in different shards, misses (t = INF)."""
    rs = np.random.default_rng(seed)
    t = rs.choice(np.float32([0.5, 1.0, 1.5, traverse.INF]), size=(n_geo, r))
    prim_type = np.where(t >= traverse.INF, -1, rs.integers(0, 2, (n_geo, r))).astype(np.int32)
    return dict(
        t=t.astype(np.float32), valid=t < traverse.INF, prim_type=prim_type,
        prim_id=rs.integers(0, 1000, (n_geo, r)).astype(np.int32),
        mat_id=rs.integers(0, 4, (n_geo, r)).astype(np.int32),
        position=rs.normal(size=(n_geo, r, 3)).astype(np.float32),
        normal=rs.normal(size=(n_geo, r, 3)).astype(np.float32),
        uv=rs.random((n_geo, r, 2)).astype(np.float32),
        enter=rs.random((n_geo, r)) < 0.5,
        fiber_u=rs.normal(size=(n_geo, r, 3)).astype(np.float32),
        fiber_v=rs.normal(size=(n_geo, r, 3)).astype(np.float32),
        fiber_w=rs.normal(size=(n_geo, r, 3)).astype(np.float32))


def test_merge_hits_over_geo_matches_jax():
    """The tie rule: at equal t a triangle beats a cone, else the lowest
    shard; held field for field against the JAX package's merge under
    shard_map on 4 of its 8 CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ba_pathtracing_fur_tpu.ops import bruteforce as jbf
    from ba_pathtracing_fur_tpu.parallel import make_mesh as jmake_mesh
    from ba_pathtracing_fur_tpu.parallel.render import _merge_hits_over_geo as jmerge

    h = _crafted_hits()
    n_geo, r = h["t"].shape
    tie = (h["t"] == h["t"].min(0)).sum(0) > 1
    assert tie.any() and ((h["prim_type"] == 0) & (h["t"] == h["t"].min(0))).any()
    got = prender._merge_hits_over_geo([bruteforce.Hit(**{k: torch.from_numpy(v[g])
                                                           for k, v in h.items()})
                                        for g in range(n_geo)])
    mesh = jmake_mesh(n_geo, geo=n_geo, devices=jax.devices()[:n_geo])
    flat = jbf.Hit(**{k: jnp.asarray(v.reshape((n_geo * r,) + v.shape[2:]))
                      for k, v in h.items()})
    want = jax.shard_map(lambda x: jmerge(x, "geo"), mesh=mesh, in_specs=(P("geo"),),
                         out_specs=P(), check_vma=False)(flat)
    for f in dataclasses.fields(bruteforce.Hit):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


@pytest.fixture
def jax_numpy_build(monkeypatch):
    """Route the JAX package's median build through its numpy lexsort path
    (its native splitter agrees only up to ties)."""
    from ba_pathtracing_fur_tpu import native as jnative

    monkeypatch.setattr(jnative, "median_split", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "ranges_to_perm", lambda *a, **k: None)


def test_pad_and_shard_scene_bvh_match_jax(jax_numpy_build):
    from ba_pathtracing_fur_tpu.parallel import render as jrender
    from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins

    js, _ = jbuiltins.fur_patch(resolution=(16, 16), fibers_per_face=8, fiber_verts=4)
    ts, _ = _fur(8, 4)
    assert prender.scene_geo_bytes(ts) == jrender.scene_geo_bytes(js)
    for n_geo in (3, 4):
        jp, tp = jrender.pad_scene_geo(js, n_geo), prender.pad_scene_geo(ts, n_geo)
        for part in ("tris", "cones"):
            for f in dataclasses.fields(getattr(tp, part)):
                np.testing.assert_array_equal(getattr(getattr(tp, part), f.name).numpy(),
                                              np.asarray(getattr(getattr(jp, part), f.name)),
                                              err_msg=f"{part}.{f.name}")
        assert prender.scene_geo_bytes(tp) == jrender.scene_geo_bytes(jp)
    jsh, tsh = jrender.shard_scene_bvh(js, 4), prender.shard_scene_bvh(ts, 4)
    for part, bvh in (("tris", "tri_bvh"), ("cones", "cone_bvh")):
        for f in dataclasses.fields(getattr(tsh, part)):
            np.testing.assert_array_equal(getattr(getattr(tsh, part), f.name).numpy(),
                                          np.asarray(getattr(getattr(jsh, part), f.name)),
                                          err_msg=f"{part}.{f.name}")
        jb, tb = getattr(jsh, bvh), getattr(tsh, bvh)
        assert tb.geo_stacked and jb.geo_stacked
        assert (tb.n_leaves, tb.leaf_size, tb.fanout) == (jb.n_leaves, jb.leaf_size, jb.fanout)
        for f in ("bmin", "bmax", "perm", "packed"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                          err_msg=f"{bvh}.{f}")


def test_train_step_reduces_loss():
    scene, cam = builtins.cornell_box(resolution=(16, 16), device=CPU)
    cfg = pt.RenderConfig(depth=2, spp=1, ray_chunk=1024)
    mesh = _mesh(8, 2)
    key = rng.key(7, CPU)
    target = torch.zeros(16, 16, 3)
    state = par.TrainState(materials=scene.materials, step=torch.tensor(0, dtype=torch.int32))
    state1, loss1 = par.train_step(state, scene, cam, key, target, cfg, mesh, lr=0.05)
    state2, loss2 = par.train_step(state1, scene, cam, key, target, cfg, mesh, lr=0.05)
    assert torch.isfinite(loss1) and torch.isfinite(loss2)
    assert float(loss2) < float(loss1)
    assert int(state2.step) == 2
    assert not any(v.requires_grad for v in par.material_params(state2.materials).values())


def test_loss_gradients_equal_the_unsharded_ones():
    scene, cam = builtins.fur_patch(resolution=(16, 16), fibers_per_face=6, fiber_verts=4,
                                    fiber_radius=0.03, device=CPU)
    cfg = pt.RenderConfig(depth=2, spp=1)
    key = rng.key(9, CPU)
    target = torch.zeros(16, 16, 3)

    def grads(render):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in par.material_params(scene.materials).items()}
        loss = render(params)
        return torch.autograd.grad(loss, list(params.values()), allow_unused=True)

    sharded = grads(lambda p: par.loss_fn(p, scene, cam, key, target, cfg, _mesh(4, 2)))
    single = grads(lambda p: ((pt.render_image(dataclasses.replace(
        scene, materials=par.train.with_material_params(scene.materials, p)), cam, key, cfg)
        - target) ** 2).mean())
    reached = 0
    for a, b, name in zip(sharded, single, par.train.PARAM_FIELDS):
        a = torch.zeros(1) if a is None else a
        b = torch.zeros(1) if b is None else b
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale, name
        reached += scale > 1e-30
    assert reached >= 3


def test_make_mesh_shapes_and_errors(monkeypatch):
    mesh = par.make_mesh(devices=[CPU] * 8, geo=2)
    assert mesh.shape == {"dp": 4, "geo": 2}
    assert all(d == CPU for row in mesh.devices for d in row)
    assert par.make_mesh(4, devices=[CPU] * 8).shape == {"dp": 4, "geo": 1}
    with pytest.raises(ValueError):
        par.make_mesh(6, geo=4, devices=[CPU] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.make_mesh()


def test_multihost_initialize_is_idempotent():
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    par.multihost_initialize(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        par.multihost_initialize(backend="gloo", init_method="tcp://127.0.0.1:1",
                                 world_size=1, rank=0)  # already up: no-op
    finally:
        dist.destroy_process_group()


def test_measure_scaling_rows(capsys):
    scene, cam = builtins.cornell_box(resolution=(8, 8), device=CPU)
    cfg = pt.RenderConfig(depth=2, spp=1)
    rows = par.measure_scaling(scene, cam, cfg, devices=[CPU] * 4, repeats=1)
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert rows[0]["speedup"] == 1.0 and all(r["rays_per_s"] > 0 for r in rows)
    panel = par.scaling_panel(rows)
    assert set(panel) == {f"{n}dev_{k}" for n in (1, 2, 4) for k in ("rays_per_s",
                                                                      "efficiency")}
    scaling.main(["--devices", "cpu,cpu", "--res", "8", "--spp", "1", "--depth", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "scaling_efficiency" and len(out["rows"]) == 2


@pytest.mark.cuda
def test_geo_merge_on_the_card():
    """On the card: the BVH-less fur patch split over 2 geo shards of one
    device (K5 a shard: 128^2 rays x 2,700 cones a shard) -- the merged
    camera-wavefront Hit against the unsharded one (t bit for bit, prim_id
    equal but at exact ties), and the sharded render against the unsharded
    render at the JAX package's tolerance, with K5's launches twice the
    unsharded render's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, cam = builtins.fur_patch(resolution=(128, 128), fibers_per_face=300, device=dev)
    shards = prender.geo_shards(prender.pad_scene_geo(scene, 2), 2)
    key = rng.key(0, dev)
    state, _ = pt.camera_wavefront(cam, torch.arange(128 * 128, device=dev), key, [0], FUR_CFG)
    o, d = state.origin, state.direction
    want = traverse.closest_hit(o, d, scene)
    cone0 = cisect.CONE_LAUNCHES
    got = prender.geo_closest_fn(shards)(o, d, scene)
    assert cisect.CONE_LAUNCHES - cone0 == 2
    assert torch.equal(got.t, want.t) and torch.equal(got.valid, want.valid)
    tie = got.prim_id != want.prim_id
    assert int(tie.sum()) <= 2
    cfg = dataclasses.replace(FUR_CFG, fused_shading=True, depth=2)
    cisect.CONE_LAUNCHES = ctraverse.KERNEL_LAUNCHES = 0
    ref = pt.render_image(scene, cam, key, cfg)
    n_single = cisect.CONE_LAUNCHES
    img = par.render_image_sharded(scene, cam, key, cfg,
                                   par.make_mesh(devices=[dev, dev], geo=2))
    assert cisect.CONE_LAUNCHES - n_single == 2 * n_single > 0
    np.testing.assert_allclose(img.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
