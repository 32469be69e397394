"""The port's binned-SAH build (`ops/bvh.build_sah`, `attach_bvh(method=
"sah")`) against the JAX package's on the CPU.

* The slot permutation, the heap boxes and the packed leaves are bit-equal
  to JAX's on the terrain, on random boxes, and on a pack whose centroids
  all coincide (every split takes the median fallback's argpartition).
* Closest-hit rows and t on a SAH terrain's camera wavefront (K2's twin on
  200-row leaves) equal JAX's `closest_hit` ray for ray.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.core import camera as jcam, rng as jrng
from ba_pathtracing_fur_tpu.ops import bvh as jbvh, traverse as jtraverse
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import bvh, traverse
from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse
from ba_pathtracing_fur_torch.scene import builtins, types

torch.set_num_threads(2)

CPU = "cpu"
BVH_FIELDS = ("perm", "bmin", "bmax")


def _bounds(case):
    rs = np.random.default_rng(7)
    if case == "random":
        lo = rs.uniform(-2, 2, (3000, 3)).astype(np.float32)
        hi = lo + rs.uniform(0, 0.2, (3000, 3)).astype(np.float32)
    elif case == "shared_centroid":  # every extent degenerate: the median fallback
        half = rs.uniform(0.01, 0.5, (700, 3)).astype(np.float32)
        lo, hi = (0.25 - half).astype(np.float32), (0.25 + half).astype(np.float32)
    else:  # flat slabs: one axis without extent
        lo = rs.uniform(-1, 1, (1500, 3)).astype(np.float32)
        lo[:, 1] = 0.5
        hi = lo + np.float32(0.01) * np.array([1, 0, 1], np.float32)
    return lo, hi


@pytest.mark.parametrize("case,leaf", [("random", 64), ("random", 200),
                                       ("shared_centroid", 16), ("flat", 24)])
def test_build_sah_equals_jax(case, leaf):
    lo, hi = _bounds(case)
    want = jbvh.build_sah(lo, hi, leaf)
    got = bvh.build_sah(torch.from_numpy(lo), torch.from_numpy(hi), leaf)
    assert (got.n_leaves, got.leaf_size) == (want.n_leaves, want.leaf_size)
    for f in BVH_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_attach_sah_terrain_equals_jax():
    """attach_bvh(method="sah") on a 20,000-triangle terrain: the auto
    leaf size, the perm, boxes, packed leaves and the reordered pack."""
    js, _ = jbuiltins.tri_terrain(resolution=(8, 8), n_tris=20_000)
    jb = jtraverse.attach_bvh(js, method="sah")
    ts, _ = builtins.tri_terrain(resolution=(8, 8), n_tris=20_000, device=CPU)
    tb = traverse.attach_bvh(ts, method="sah")
    a, b = tb.tri_bvh, jb.tri_bvh
    assert (a.n_leaves, a.leaf_size, a.fanout) == (b.n_leaves, b.leaf_size, b.fanout)
    for f in BVH_FIELDS + ("packed",):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                      err_msg=f)
    for f in ("v0", "v1", "v2", "uv0", "mat_id"):
        np.testing.assert_array_equal(getattr(tb.tris, f).numpy(),
                                      np.asarray(getattr(jb.tris, f)), err_msg=f)
    st = traverse.LAST_BUILD_STATS["tri"]
    assert set(st) == {"aabb", "split", "reorder_pack", "layouts"}
    assert min(st.values()) >= 0.0


def test_terrain_sizes_give_config3_leaves():
    """bench config 3's 100,000 triangles (99,458 of the 223^2 grid) take
    512 leaves of 200 rows, a flat BVH: K2, not K3."""
    n = 2 * 223 * 223
    k = traverse.auto_leaf_size(n, traverse.TRI_LEAF_TARGET)
    n_leaves = bvh._next_pow2(-(-n // k))
    assert (k, n_leaves, traverse.auto_fanout(n_leaves)) == (200, 512, 0)
    assert (k, n_leaves, jtraverse.auto_fanout(n_leaves)) == (
        jtraverse.auto_leaf_size(n, jtraverse.TRI_LEAF_TARGET), 512, 0)


def test_sah_terrain_closest_rows_equal_jax():
    """The camera wavefront of a 24x24 SAH terrain (2,000 triangles, forced
    BVH): K2's twin picks JAX closest_hit's rows and t."""
    js, jc = jbuiltins.tri_terrain(resolution=(24, 24), n_tris=2000)
    js = jtraverse.attach_bvh(js, method="sah", min_prims=1)
    ts = types.scene_from_numpy(js, device=CPU)
    w, h = jc.resolution
    ids = jnp.arange(w * h)
    keys = jrng.keys_for_pixels(jax.random.key(0), ids, 0)
    jo, jd = jcam.rays_from_pixels(jc, (ids % w).astype(jnp.float32),
                                   (ids // w).astype(jnp.float32),
                                   jrng.bounce_uniform(keys, -1, 2, tag=7))
    want = jtraverse.closest_hit(jo, jd, js)
    refs = ctraverse.REF_CALLS
    got = traverse.closest_hit(torch.from_numpy(np.asarray(jo)),
                               torch.from_numpy(np.asarray(jd)), ts)
    assert ctraverse.REF_CALLS == refs + 1  # the flat BVH's traversal twin
    assert 0.2 < got.valid.float().mean() < 1.0  # ground and sky
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(want.prim_id))
    np.testing.assert_array_equal(got.mat_id.numpy(), np.asarray(want.mat_id))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), rtol=0, atol=1e-6)


def test_sah_render_cfg_has_no_texture_fetch_in_the_fused_path():
    """The fused path still refuses the textured terrain (K1 has no texture
    fetch); the unfused default renders it."""
    ts, tc = builtins.tri_terrain(resolution=(6, 6), n_tris=200, device=CPU)
    ts = traverse.attach_bvh(ts, method="sah", min_prims=1)
    with pytest.raises(NotImplementedError, match="K1's texture fetch"):
        pt.render_image(ts, tc, rng.key(0, CPU), pt.RenderConfig(
            depth=1, spp=1, compact=False, fused_shading=True))
    img = pt.render_image(ts, tc, rng.key(0, CPU), pt.RenderConfig(depth=2, spp=1,
                                                                   compact=False))
    assert img.shape == (6, 6, 3) and torch.isfinite(img).all() and img.max() > 0.01
