"""The port's BVH builds, their structure tools, the progressive loop and
checkpoints against the JAX package's:

* the morton `build` and `build_grid` give bit-equal bmin, bmax and perm,
  also for counts that are no multiple of the leaf size (their padding
  fills the last leaves, which can be wholly empty);
* `attach_bvh` with every method gives the JAX package's BVHs and packed
  leaves, and its closest hits (through the traversal twins) equal the
  brute force (`tests/test_bvh.py::test_accel_family_matches_bruteforce`);
  empty tail leaves carry inverted boxes, in the unit and super-cluster
  tables too, and the kernels' box test never enters them;
* `debug_info`, `visualize_structure` and `visit_count_stats` equal;
* `render_progressive`'s yields against JAX's under the image gate, and a
  checkpoint written by the JAX package resumes in the port (and one
  written by the port loads in the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu import native as jnative
from ba_pathtracing_fur_tpu.models import pathtracer as jpt
from ba_pathtracing_fur_tpu.ops import bruteforce as jbrute, bvh as jbvh, \
    traverse as jtraverse, visualize as jvisualize
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_tpu.utils import checkpoint as jcheckpoint
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import bvh, traverse, visualize
from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse
from ba_pathtracing_fur_torch.scene.types import scene_from_numpy
from ba_pathtracing_fur_torch.utils import checkpoint
from test_torch_fur import _compare_images

torch.set_num_threads(2)

CPU = "cpu"
METHODS = ("median", "sah", "morton", "grid")


@pytest.fixture
def jax_numpy_build(monkeypatch):
    """Route the JAX package's median build through its numpy lexsort path."""
    monkeypatch.setattr(jnative, "median_split", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "ranges_to_perm", lambda *a, **k: None)


def _bounds(n, seed):
    """Seeded boxes with runs of equal centroids (fibers share morton
    cells and grid cells)."""
    rs = np.random.RandomState(seed)
    c = (rs.rand(n, 3) * [2.0, 0.5, 3.0]).astype(np.float32)
    c[: n // 10] = c[0]
    half = (rs.rand(n, 3) * 0.01).astype(np.float32)
    return c - half, c + half


@pytest.mark.parametrize("method", ["morton", "grid"])
@pytest.mark.parametrize("n,k", [(1024, 8), (1003, 16), (5000, 96), (77, 8)])
def test_morton_and_grid_builds_are_bit_equal(method, n, k):
    lo, hi = _bounds(n, n)
    want = (jbvh.build if method == "morton" else jbvh.build_grid)(lo, hi, k)
    got = (bvh.build if method == "morton" else bvh.build_grid)(torch.from_numpy(lo),
                                                                torch.from_numpy(hi), k)
    for f in ("bmin", "bmax", "perm"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.n_leaves, got.leaf_size) == (want.n_leaves, want.leaf_size)
    assert bvh.debug_info(got) == jbvh.debug_info(want)
    # the padding fills the last slots in order
    slots = got.perm.numpy()
    assert (slots[:n] >= 0).all() and (slots[n:] == -1).all()


def _fur(res=(8, 8)):
    return jbuiltins.fur_patch(resolution=res, fibers_per_face=4, fiber_verts=4,
                               fiber_radius=0.02)


@pytest.mark.parametrize("method", METHODS)
def test_attach_bvh_equals_jax_and_brute_force(method, jax_numpy_build):
    """Every method on the fur patch's cones and triangles: the JAX
    package's perm, boxes and packed leaves, the same debug_info; the
    closest hits of random rays through the traversal twins equal the
    port's BVH-less brute force (found, t and primitive) and JAX's."""
    js, _ = _fur()
    ja = jtraverse.attach_bvh(js, leaf_size=8, method=method, min_prims=1, fanout=0)
    ts = scene_from_numpy(js, device=CPU)
    ta = traverse.attach_bvh(ts, leaf_size=8, method=method, min_prims=1, fanout=0)
    for kind in ("tri_bvh", "cone_bvh"):
        a, b = getattr(ta, kind), getattr(ja, kind)
        for f in ("perm", "bmin", "bmax", "packed"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                          err_msg=f"{kind} {f}")
        assert bvh.debug_info(a) == jbvh.debug_info(b)
    rs = np.random.RandomState(7)
    o = rs.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    d = rs.uniform((-0.4, 0.0, -0.4), (0.4, 0.12, 0.4), (512, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    refs = ctraverse.REF_CALLS
    got = traverse.closest_hit(torch.from_numpy(o), torch.from_numpy(d), ta)
    assert ctraverse.REF_CALLS == refs + 2  # the twin of K2, once a pack
    ref = traverse.closest_hit(torch.from_numpy(o), torch.from_numpy(d), ts)
    assert 0.2 < float(ref.valid.float().mean()) < 1.0
    assert torch.equal(got.valid, ref.valid) and torch.equal(got.prim_id, ref.prim_id)
    assert torch.equal(got.t, ref.t)
    jref = jbrute.closest_hit(jnp.asarray(o), jnp.asarray(d), js)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jref.valid))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(jref.t), rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("fanout", [0, 4])
def test_empty_tail_leaves_are_inert(fanout):
    """A morton tree over 1,100 cones in leaves of 96: its 4 last leaves
    (and, with a fanout of 4, its last super-cluster) hold only padding.
    Their heap, unit, child and super boxes are inverted, the box test of
    the kernels (`_slab_entry`, `_units_entered`) enters none of them, and
    the twins of K2 and K3 find the brute force's hits."""
    js, _ = jbuiltins.fur_patch(resolution=(8, 8), fibers_per_face=62, fiber_verts=10)
    ts = scene_from_numpy(js, device=CPU)
    assert ts.cones.count == 1116
    ta = traverse.attach_bvh(ts, leaf_size=96, method="morton", min_prims=1, fanout=fanout)
    b = ta.cone_bvh
    empty = (b.perm.reshape(b.n_leaves, -1) < 0).all(1)
    assert b.n_leaves == 16 and empty.tolist() == [False] * 12 + [True] * 4
    leaves = slice(b.n_leaves - 1, None)
    assert (b.bmin[leaves][empty] == bvh.BIG).all() and (b.bmax[leaves][empty] == -bvh.BIG).all()
    assert (b.uboxes[empty][:, :3] == bvh.BIG).all() and (b.uboxes[empty][:, 3:] == -bvh.BIG).all()
    rs = np.random.RandomState(3)
    o = torch.from_numpy(rs.uniform(-1.5, 1.5, (256, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(-o + 0.2 * torch.from_numpy(
        rs.randn(256, 3).astype(np.float32)), dim=-1)
    t_best = torch.full((256,), traverse.INF)
    e = ctraverse._slab_entry(o, d, b.bmin[leaves], b.bmax[leaves], t_best)
    assert (e[:, empty] == traverse.INF).all() and (e[:, ~empty] < traverse.INF).any()
    units = ctraverse._units_entered(o[:, None].expand(-1, 4, -1).reshape(-1, 3),
                                     d[:, None].expand(-1, 4, -1).reshape(-1, 3),
                                     b.uboxes[empty].repeat(256, 1, 1), t_best.repeat(4))
    assert not units.any()
    if fanout:
        assert torch.equal(b.sboxes[:3, -1], torch.full((3,), bvh.BIG))
        assert (b.cboxes[-1, :3] == bvh.BIG).all() and (b.cboxes[-1, 3:] == -bvh.BIG).all()
    twin = cstream.traverse_stream if fanout else ctraverse.traverse
    for any_hit in (False, True):
        t1, r1, f1 = twin(o, d, torch.full((256,), traverse.INF), b, "cone", any_hit=any_hit)
        t0, r0, f0 = ctraverse.brute_force(o, d, torch.full((256,), traverse.INF), b, "cone",
                                           any_hit)
        assert torch.equal(f1, f0) and torch.equal(t1, t0) and 0 < int(f0.sum()) < 256


@pytest.mark.parametrize("method", ["median", "morton"])
def test_visualize_structure_equals_jax(method, jax_numpy_build):
    """The overlay (heatmap, tinted edges, blended onto a base image) and the
    visit counts, at the leaf level and at level 2, chunked over rays."""
    js, jc = jbuiltins.fur_patch(resolution=(24, 16), fibers_per_face=60)
    ja = jtraverse.attach_bvh(js, method=method, min_prims=1)
    ta = traverse.attach_bvh(scene_from_numpy(js, device=CPU), method=method, min_prims=1)
    tc = camera_from_numpy(jc, device=CPU)
    base = np.random.RandomState(0).rand(16, 24, 3).astype(np.float32)
    for kind in ("tri_bvh", "cone_bvh"):
        for level in (-1, 2):
            want = np.asarray(jvisualize.visualize_structure(
                getattr(ja, kind), jc, level=level, base_image=jnp.asarray(base)))
            got = visualize.visualize_structure(getattr(ta, kind), tc, level=level,
                                                base_image=torch.from_numpy(base))
            np.testing.assert_array_equal(got.numpy(), want)
            assert visualize.visit_count_stats(getattr(ta, kind), tc, level) == \
                jvisualize.visit_count_stats(getattr(ja, kind), jc, level)


_CFG = dict(depth=2, spp=2)


@pytest.fixture(scope="module")
def progressive():
    """The Cornell box at 12x12 and JAX's render_progressive yields and its
    resumable render's first state (key 0, depth 2, spp 2, JAX's defaults
    otherwise: compaction on, unfused)."""
    js, jc = jbuiltins.cornell_box(resolution=(12, 12), variant="glossy")
    cfg = jpt.RenderConfig(**_CFG)
    yields = [(i, np.asarray(img)) for i, img in
              jpt.render_progressive(js, jc, jax.random.key(0), cfg)]
    state = next(jcheckpoint.render_resumable(
        js, jc, cfg, jcheckpoint.fresh_state(jc.resolution, jax.random.key(0))))
    return js, jc, yields, state


def test_render_progressive_matches_jax(progressive):
    js, jc, yields, _ = progressive
    ts, tc = scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU)
    got = list(pt.render_progressive(ts, tc, rng.key(0, CPU), pt.RenderConfig(**_CFG)))
    assert [i for i, _ in got] == [i for i, _ in yields] == [0, 1]
    for (_, a), (_, b) in zip(yields, got):
        assert b.shape == (12, 12, 3)
        _compare_images(a, b.numpy())
    # the mean continues from a given accumulator and sample
    rest = list(pt.render_progressive(ts, tc, rng.key(0, CPU), pt.RenderConfig(**_CFG),
                                      accum=got[0][1], start_sample=1))
    assert len(rest) == 1 and torch.equal(rest[0][1], got[1][1])


def test_jax_checkpoint_resumes_in_the_port(progressive, tmp_path):
    js, jc, yields, state = progressive
    assert int(state.sample_count) == 1
    jcheckpoint.save_checkpoint(str(tmp_path / "jax.npz"), state)
    loaded = checkpoint.load_checkpoint(str(tmp_path / "jax.npz"), device=CPU)
    assert loaded.sample_count == 1 and loaded.params is None
    np.testing.assert_array_equal(loaded.key_data.numpy(),
                                  np.asarray(state.key_data).astype(np.int64))
    ts, tc = scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU)
    states = list(checkpoint.render_resumable(ts, tc, pt.RenderConfig(**_CFG), loaded,
                                              str(tmp_path / "port.npz"), checkpoint_every=2))
    assert [s.sample_count for s in states] == [2]
    _compare_images(yields[-1][1], states[-1].accum.numpy())
    back = jcheckpoint.load_checkpoint(str(tmp_path / "port.npz"))
    assert int(back.sample_count) == 2
    np.testing.assert_array_equal(np.asarray(back.accum), states[-1].accum.numpy())
    np.testing.assert_array_equal(np.asarray(back.key_data), np.asarray(state.key_data))
    fresh = checkpoint.fresh_state((12, 12), rng.key(0, CPU))
    checkpoint.save_checkpoint(str(tmp_path / "fresh.npz"),
                               fresh._replace(params={"diffuse": torch.ones(2, 3)}))
    j = jcheckpoint.load_checkpoint(str(tmp_path / "fresh.npz"))
    assert np.asarray(j.key_data).dtype == np.uint32 and j.params["diffuse"].shape == (2, 3)
