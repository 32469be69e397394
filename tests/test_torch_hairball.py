"""The port's hair-ball slice against the JAX package on the CPU.

* `core/rng.split` and `uniform` over a 2-D shape equal jax.random's bits;
  `normal` agrees to rtol 1e-4, atol 1e-5: XLA's float32 `erf_inv`
  polynomial is up to 1.5e-5 off the exact value, torch's within 2.4e-7.
* `builtins.hair_ball(on_device=False)` equals JAX's numpy hair ball field
  by field; `on_device=True` (the ported threefry draws grown in torch)
  agrees with JAX's on-device generator to 1e-5 absolute on every cone
  field (positions to 2e-7; the frame axes of near-vertical cones move
  most, up to 8.1e-6).
* `ops/bvh.build_median` (the split in torch) equals the JAX package's
  numpy build on the same bounds, including packs of tied and -0.0
  centroids; `attach_bvh`'s two-level tables equal JAX `pack_super_boxes` /
  `pack_child_boxes`.
* The dispatch reaches K5's twin once R*P >= 2^24 (threshold patched
  down), and its Hit equals the dense grid's.
* The slice end to end: a 16x16 hair ball (600 fibers, forced two-level
  BVH, depth 3, spp 2) through the K3, K5 and K1 twins against the JAX
  package's compiled `render_image(fused_shading=True)`, run in a child
  process with XLA's CPU ISA capped below FMA, under the image gate of
  tests/test_fused_shade.py::_compare.

XLA's CPU backend contracts a*b + c into one FMA wherever the ISA has it
(it has no flag for contraction alone). On this scene's thin cones that
moves the grazing roots of the cone quadratic, so the compiled render
differs from the same bounces run op by op; with the ISA capped at SSE4.2
the two are equal. The witness, run from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_hairball.py --witness
    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 JAX_PLATFORMS=cpu PYTHONPATH=.:tests \
        python tests/test_torch_hairball.py --witness

prints the compiled render's difference from the op-by-op bounces under
each setting.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu import native as jnative
from ba_pathtracing_fur_tpu.core import camera as jcam, rng as jrng
from ba_pathtracing_fur_tpu.models import pathtracer as jpt
from ba_pathtracing_fur_tpu.ops import bvh as jbvh, traverse as jtraverse
from ba_pathtracing_fur_tpu.ops.pallas import stream as jstream
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import bvh, intersect, traverse
from ba_pathtracing_fur_torch.ops.cuda import hit as chit, intersect as cisect, stream as cstream
from ba_pathtracing_fur_torch.scene import builtins, types
from test_torch_fur import _compare_images
from test_torch_scene import _assert_scene_equal

torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture
def jax_numpy_build(monkeypatch):
    """Route the JAX package's median build through its numpy lexsort path."""
    monkeypatch.setattr(jnative, "median_split", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "ranges_to_perm", lambda *a, **k: None)


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_split_uniform_normal_match_jax(seed):
    keys = jax.random.split(jax.random.key(np.uint32(seed)))
    got = rng.split(rng.key(seed, CPU), 2)
    np.testing.assert_array_equal(got.numpy(), _u32(jax.random.key_data(keys)))
    np.testing.assert_array_equal(rng.uniform(got[0], (500, 2)).numpy(),
                                  np.asarray(jax.random.uniform(keys[0], (500, 2))))
    want = np.asarray(jax.random.normal(keys[1], (20000, 3)))
    np.testing.assert_allclose(rng.normal(got[1], (20000, 3)).numpy(), want,
                               rtol=1e-4, atol=1e-5)


def test_hair_ball_host_equals_jax():
    js, jc = jbuiltins.hair_ball(resolution=(12, 10), n_fibers=300)
    ts, tc = builtins.hair_ball(resolution=(12, 10), n_fibers=300, device=CPU)
    assert (ts.tris.count, ts.cones.count) == (768, 2700)
    _assert_scene_equal(ts, types.scene_from_numpy(js, device=CPU))
    ref = camera_from_numpy(jc, device=CPU)
    for f in ("position", "axis_x", "axis_y", "axis_z", "bottom_left"):
        assert torch.equal(getattr(tc, f), getattr(ref, f)), f


def test_hair_ball_on_device_matches_jax():
    js, _ = jbuiltins.hair_ball(resolution=(8, 8), n_fibers=600, on_device=True)
    ts, _ = builtins.hair_ball(resolution=(8, 8), n_fibers=600, on_device=True, device=CPU)
    for f in dataclasses.fields(types.ConePack):
        np.testing.assert_allclose(getattr(ts.cones, f.name).numpy(),
                                   np.asarray(getattr(js.cones, f.name)), rtol=0, atol=1e-5,
                                   err_msg=f.name)
    host, _ = builtins.hair_ball(resolution=(8, 8), n_fibers=600, device=CPU)
    assert not torch.equal(ts.cones.base, host.cones.base)  # another stream than numpy's


def _tied_bounds():
    """Boxes whose centroids tie on every axis in places, with -0.0 and
    +0.0 keys mixed."""
    rs = np.random.default_rng(7)
    c = rs.integers(-3, 4, (3000, 3)).astype(np.float32) * np.float32(0.5)
    half = rs.uniform(0.0, 0.2, (3000, 3)).astype(np.float32)
    c[rs.random(3000) < 0.3, 1] = np.float32(0.0)
    lo, hi = c - half, c + half
    neg = rs.random(3000) < 0.3
    lo[neg, 0] = hi[neg, 0] = np.float32(-0.0)  # flat boxes at -0.0
    return lo, hi


@pytest.mark.parametrize("case", ["hair_ball", "tied"])
@pytest.mark.parametrize("leaf", [8, 40])
def test_device_split_equals_numpy_build(jax_numpy_build, case, leaf):
    """The torch split on CPU tensors against JAX's numpy lexsort build."""
    if case == "hair_ball":
        ts, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=400, device=CPU)
        lo, hi = (x.numpy() for x in intersect.cone_aabbs(ts.cones))
    else:
        lo, hi = _tied_bounds()
        cent = 0.5 * (lo + hi)
        assert np.signbit(cent[:, :2][cent[:, :2] == 0]).any()
    got = bvh.build_median(torch.from_numpy(lo), torch.from_numpy(hi), leaf)
    want = jbvh.build_median(lo, hi, leaf)
    assert (got.n_leaves, got.leaf_size) == (want.n_leaves, want.leaf_size)
    for f in ("bmin", "bmax", "perm"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_attach_bvh_two_level_layouts(jax_numpy_build):
    """Forced leaf_size 16, fanout 8, through the torch build on CPU
    tensors: the same packs and heap as JAX's numpy build, and the super and
    child box tables of JAX's streaming kernel."""
    js, _ = jbuiltins.hair_ball(resolution=(4, 4), n_fibers=600)
    js = jtraverse.attach_bvh(js, method="median", leaf_size=16, fanout=8)
    ts, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=600, device=CPU)
    ts = traverse.attach_bvh(ts, leaf_size=16, fanout=8)
    assert set(traverse.LAST_BUILD_STATS["cone"]) == {"aabb", "split", "reorder_pack",
                                                      "layouts"}
    jb, tb = js.cone_bvh, ts.cone_bvh
    assert (tb.n_leaves, tb.leaf_size, tb.fanout) == (jb.n_leaves, jb.leaf_size, 8) == \
        (512, 16, 8)
    for f in ("bmin", "bmax", "perm", "packed"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), f)
    for f in dataclasses.fields(types.ConePack):
        np.testing.assert_array_equal(getattr(ts.cones, f.name).numpy(),
                                      np.asarray(getattr(js.cones, f.name)), f.name)
    np.testing.assert_array_equal(tb.sboxes.numpy(), np.asarray(jstream.pack_super_boxes(jb)))
    np.testing.assert_array_equal(tb.cboxes.numpy(), np.asarray(jstream.pack_child_boxes(jb)))
    np.testing.assert_array_equal(tb.aos_rows.numpy(), chit.cone_aos(ts.cones).numpy())
    assert ts.tri_bvh is None  # 768 scalp triangles stay BVH-less


def test_auto_fanout_matches_jax():
    for n in (1, 512, 1024, 32768, 65536, 131072, 1 << 20):
        assert traverse.auto_fanout(n) == jtraverse.auto_fanout(n), n
    assert traverse.auto_leaf_size(9_000_000, traverse.CONE_LEAF_TARGET_STREAM) == 280
    assert traverse.auto_fanout(32768) == 64


def test_big_bvh_less_packs_reach_the_brute_force_twin(monkeypatch):
    """R*P at or above the (patched) threshold: K5's twin, closest and any
    hit, for both kinds; the Hit equals the dense grid's."""
    ts, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=150, device=CPU)
    rs = np.random.default_rng(1)
    o = torch.from_numpy(rs.uniform(-1.2, 1.2, (300, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(-o + torch.from_numpy(
        rs.normal(0, 0.2, (300, 3)).astype(np.float32)), dim=-1)
    t_max = torch.full((300,), 3.4e38)
    t_max[::11] = 0.0
    grid = traverse.closest_hit(o, d, ts, t_max=t_max)
    blocked_grid = traverse.any_hit(o, d, ts, torch.full((300,), 0.9))
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)
    refs = cisect.REF_CALLS
    hit = traverse.closest_hit(o, d, ts, t_max=t_max)
    assert cisect.REF_CALLS == refs + 2  # triangles and cones
    blocked = traverse.any_hit(o, d, ts, torch.full((300,), 0.9))
    assert cisect.REF_CALLS == refs + 4
    assert 0.2 < hit.valid.double().mean() < 1.0 and 0.0 < blocked.double().mean() < 1.0
    assert torch.equal(blocked, blocked_grid)
    for f in ("valid", "prim_type", "prim_id", "mat_id", "enter"):
        assert torch.equal(getattr(hit, f), getattr(grid, f)), f
    for f in ("t", "position", "normal", "uv", "fiber_u"):
        torch.testing.assert_close(getattr(hit, f), getattr(grid, f), rtol=1e-5, atol=1e-6)


#: caps XLA's CPU code at an ISA without FMA, so that no a*b + c of the
#: compiled render is contracted (see the module doc)
_NO_FMA = "--xla_cpu_max_isa=SSE4_2"
_HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_hair_ball():
    """The render test's scene in the JAX package: 16x16, 600 fibers, a
    two-level cone BVH of leaf 16 and fanout 8 (numpy build)."""
    js, jc = jbuiltins.hair_ball(resolution=(16, 16), n_fibers=600)
    return jtraverse.attach_bvh(js, method="median", leaf_size=16, fanout=8), jc


_JAX_CFG = jpt.RenderConfig(depth=3, spp=2, compact=False, fused_shading=True, ray_chunk=256)


def _jax_render_op_by_op(js, jc, spp, cfg):
    """JAX `render_image`'s running mean of `render_sample_ids`, with each
    bounce's `trace_bounce_fused` run op by op instead of inside one
    compiled program."""
    w, h = jc.resolution
    ids = jnp.arange(w * h)
    key = jax.random.key(0)
    acc = np.zeros((w * h, 3), np.float32)
    for s in range(spp):
        keys = jrng.keys_for_pixels(key, ids, s)
        o, d = jcam.rays_from_pixels(jc, (ids % w).astype(jnp.float32),
                                     (ids // w).astype(jnp.float32),
                                     jrng.bounce_uniform(keys, -1, 2, tag=7))
        state = jpt.init_state(o, d)
        for b in range(cfg.depth):
            state = jpt.trace_bounce_fused(state, js, keys, b, cfg)
        acc = acc + (np.asarray(state.color) - acc) / np.float32(s + 1)
    return acc.reshape(h, w, 3)


def _jax_render_without_fma() -> np.ndarray:
    """JAX's compiled `render_image` of `_jax_hair_ball`, in a child process
    (XLA reads its flags once a process) with the ISA capped below FMA."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {_NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join([os.path.dirname(_HERE), _HERE]))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "jax.npy")
        subprocess.run([sys.executable, os.path.abspath(__file__), out], env=env, check=True,
                       timeout=600)
        return np.load(out)


def test_hair_ball_render_matches_jax(jax_numpy_build, monkeypatch):
    """16x16, 600 fibers, a two-level cone BVH (leaf 16, fanout 8), depth 3,
    spp 2: every bounce through the K3, K5 and K1 twins (K5 reached by
    patching its threshold below this wavefront's 256 x 768 pairs), against
    the JAX package's compiled `render_image` without FMA contraction."""
    a = _jax_render_without_fma()
    ts, tc = builtins.hair_ball(resolution=(16, 16), n_fibers=600, device=CPU)
    ts = traverse.attach_bvh(ts, leaf_size=16, fanout=8)
    k3, k5 = cstream.REF_CALLS, cisect.REF_CALLS
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 16)
    b = pt.render_image(ts, tc, rng.key(0, CPU), pt.RenderConfig(
        depth=3, spp=2, compact=False, fused_shading=True)).numpy()
    n = _JAX_CFG.spp * _JAX_CFG.depth
    assert cstream.REF_CALLS - k3 == 2 * n and cisect.REF_CALLS - k5 == 2 * n
    _compare_images(a, b)


if __name__ == "__main__":
    # python tests/test_torch_hairball.py OUT.npy: save JAX's compiled render
    # of the test scene; --witness: print its difference from the op-by-op
    # bounces under this process's XLA_FLAGS
    jax.config.update("jax_platforms", "cpu")
    jnative.median_split = jnative.ranges_to_perm = lambda *a, **k: None
    scene, camera = _jax_hair_ball()
    img = np.asarray(jpt.render_image(scene, camera, jax.random.key(0), _JAX_CFG))
    if sys.argv[1] != "--witness":
        np.save(sys.argv[1], img)
    else:
        diff = np.abs(img - _jax_render_op_by_op(scene, camera, _JAX_CFG.spp, _JAX_CFG))
        print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}: compiled render_image vs "
              f"op-by-op bounces: mean |d| {diff.mean():.6g}, pixels off by > 1e-3 "
              f"{(diff.max(-1) > 1e-3).mean():.6g}, max |d| {diff.max():.6g}")
