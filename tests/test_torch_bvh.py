"""The port's median BVH build against the JAX package's numpy build.

`ops/bvh.build_median` + `reorder_*` + `pack_*` (and `ops/traverse.
attach_bvh` over a whole scene) must be bit-equal to the JAX package's
numpy path. That path is the JAX package's fallback when its native C++
splitter is absent; the tests take it by patching the JAX package's
`native.median_split` and `native.ranges_to_perm` to return None (the JAX
package itself is not edited).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu import native as jnative
from ba_pathtracing_fur_tpu.ops import bvh as jbvh, intersect as jisect, traverse as jtraverse
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins, types as jtypes
from ba_pathtracing_fur_torch.ops import bvh, intersect, traverse
from ba_pathtracing_fur_torch.scene import builtins, types

torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture
def jax_numpy_build(monkeypatch):
    """Route the JAX package's median build through its numpy lexsort path."""
    monkeypatch.setattr(jnative, "median_split", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "ranges_to_perm", lambda *a, **k: None)


def _soup(n, seed):
    rs = np.random.default_rng(seed)
    v0 = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1 = v0 + rs.normal(0, 0.05, (n, 3)).astype(np.float32)
    v2 = v0 + rs.normal(0, 0.05, (n, 3)).astype(np.float32)
    return v0, v1, v2


def _assert_bvh_equal(a: bvh.BVH, b):
    assert (a.n_leaves, a.leaf_size) == (b.n_leaves, b.leaf_size)
    for f in ("bmin", "bmax", "perm", "packed"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), f)


def _assert_pack_equal(a, b, cls):
    for f in dataclasses.fields(cls):
        np.testing.assert_array_equal(getattr(a, f.name).numpy(),
                                      np.asarray(getattr(b, f.name)), f.name)


@pytest.mark.parametrize("n,leaf", [(5000, 40), (777, 8), (3, 8)])
def test_triangle_build_reorder_pack_bit_equal(jax_numpy_build, n, leaf):
    v0, v1, v2 = _soup(n, n)
    jt = jtypes.make_triangle_pack(v0, v1, v2, mat_id=np.arange(n) % 3)
    tt = types.make_triangle_pack(v0, v1, v2, mat_id=np.arange(n) % 3)
    for x, y in zip(intersect.triangle_aabbs(tt), jisect.triangle_aabbs(jt)):
        np.testing.assert_array_equal(x.numpy(), y)
    jb = jbvh.build_median(*jisect.triangle_aabbs(jt), leaf)
    tb = bvh.build_median(*intersect.triangle_aabbs(tt), leaf)
    jr, tr = jbvh.reorder_tris(jt, jb), bvh.reorder_tris(tt, tb)
    _assert_pack_equal(tr, jr, types.TrianglePack)
    _assert_bvh_equal(bvh.pack_tris(tr, tb), jbvh.pack_tris(jr, jb))


@pytest.mark.parametrize("fibers_per_face,leaf", [(300, 128), (40, 16)])
def test_cone_build_reorder_pack_bit_equal(jax_numpy_build, fibers_per_face, leaf):
    js, _ = jbuiltins.fur_patch(resolution=(4, 4), fibers_per_face=fibers_per_face)
    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=fibers_per_face, device=CPU)
    for x, y in zip(intersect.cone_aabbs(ts.cones), jisect.cone_aabbs(js.cones)):
        np.testing.assert_array_equal(x.numpy(), y)
    np.testing.assert_array_equal(intersect.cone_centroids(ts.cones).numpy(),
                                  jisect.cone_centroids(js.cones))
    jb = jbvh.build_median(*jisect.cone_aabbs(js.cones), leaf)
    tb = bvh.build_median(*intersect.cone_aabbs(ts.cones), leaf)
    jr, tr = jbvh.reorder_cones(js.cones, jb), bvh.reorder_cones(ts.cones, tb)
    _assert_pack_equal(tr, jr, types.ConePack)
    assert (tr.min_d[tb.perm < 0] == 1.0).all() and (tr.max_d[tb.perm < 0] == -1.0).all()
    _assert_bvh_equal(bvh.pack_cones(tr, tb), jbvh.pack_cones(jr, jb))


@pytest.mark.parametrize("n", [1, 100, 45000, 1_000_001])
@pytest.mark.parametrize("target", [traverse.TRI_LEAF_TARGET, traverse.CONE_LEAF_TARGET])
def test_auto_leaf_size_matches(n, target):
    assert traverse.auto_leaf_size(n, target) == jtraverse.auto_leaf_size(n, target)


def test_attach_bvh_equals_jax(jax_numpy_build):
    """A whole fur-patch scene: the reordered packs and both BVHs."""
    js, _ = jbuiltins.fur_patch(resolution=(4, 4), fibers_per_face=250)
    js = jtraverse.attach_bvh(js, method="median", min_prims=1)
    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=250, device=CPU)
    ts = traverse.attach_bvh(ts, method="median", min_prims=1)
    _assert_pack_equal(ts.cones, js.cones, types.ConePack)
    _assert_pack_equal(ts.tris, js.tris, types.TrianglePack)
    _assert_bvh_equal(ts.cone_bvh, js.cone_bvh)
    _assert_bvh_equal(ts.tri_bvh, js.tri_bvh)
    # the same scene carried across by scene_from_numpy
    carried = types.scene_from_numpy(js, device=CPU)
    _assert_bvh_equal(carried.cone_bvh, js.cone_bvh)
    assert carried.cone_bvh.fanout == js.cone_bvh.fanout


def test_small_packs_stay_bvh_less():
    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=20, device=CPU)
    out = traverse.attach_bvh(ts)  # min_prims 2048: 360 cones, 2 triangles
    assert out.cone_bvh is None and out.tri_bvh is None and out.cones is ts.cones


def _perm_cache_scene(shift=0.0):
    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=120, device=CPU)
    if shift:
        base = ts.cones.base.clone()
        base[0, 0] += shift
        ts = dataclasses.replace(ts, cones=dataclasses.replace(ts.cones, base=base))
    return ts


def _cone_build(ts, **kw):
    out = traverse.attach_bvh(ts, method="median", **kw)
    return out, dict(traverse.LAST_BUILD_STATS["cone"])


@pytest.mark.parametrize("case", ["hit_bit_equal", "changed_pack_misses", "disabled",
                                  "fingerprint"])
def test_perm_cache(case, tmp_path, monkeypatch, jax_numpy_build):
    """The median build's on-disk perm cache (BAPT_BVH_CACHE_DIR = tmp_path;
    PERM_CACHE_MIN lowered to this 2,160-cone patch): a cached build is
    bit-equal to a fresh one and to the JAX package's build, a changed pack
    misses, BAPT_NO_BVH_CACHE turns the cache off, and a caller's
    fingerprint turns it on below the threshold; LAST_BUILD_STATS records
    `perm_cached` wherever the cache took part."""
    monkeypatch.setenv("BAPT_BVH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("BAPT_NO_BVH_CACHE", raising=False)
    if case != "fingerprint":
        monkeypatch.setattr(traverse, "PERM_CACHE_MIN", 1000)
    kw = dict(fingerprint="patch120") if case == "fingerprint" else {}
    if case == "disabled":
        monkeypatch.setenv("BAPT_NO_BVH_CACHE", "1")
        _, st = _cone_build(_perm_cache_scene())
        assert "perm_cached" not in st and not list(tmp_path.iterdir())
        return
    if case == "fingerprint":
        _, st = _cone_build(_perm_cache_scene())  # below the threshold, no key
        assert "perm_cached" not in st and not list(tmp_path.iterdir())
    first, st1 = _cone_build(_perm_cache_scene(), **kw)
    second, st2 = _cone_build(_perm_cache_scene(), **kw)
    assert (st1["perm_cached"], st2["perm_cached"]) == (False, True)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("perm_")
    if case == "fingerprint":
        assert files[0].startswith("perm_patch120_")
    for f in ("bmin", "bmax", "perm", "packed", "aos_rows", "uboxes"):
        assert torch.equal(getattr(first.cone_bvh, f), getattr(second.cone_bvh, f)), f
    _assert_pack_equal(second.cones, first.cones, types.ConePack)
    js, _ = jbuiltins.fur_patch(resolution=(4, 4), fibers_per_face=120)
    js = jtraverse.attach_bvh(js, method="median")
    _assert_bvh_equal(second.cone_bvh, js.cone_bvh)
    if case == "changed_pack_misses":
        _, st3 = _cone_build(_perm_cache_scene(shift=1e-3))
        assert st3["perm_cached"] is False and len(list(tmp_path.iterdir())) == 2
