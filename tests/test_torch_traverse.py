"""The port's traversal twin and Hit assembly against the JAX package.

* `ops/cuda/traverse.traverse_ref` (the plain twin of the traversal kernel)
  on a BVH carried across from the JAX package, cone and triangle leaves,
  closest and any hit: the same `found` as JAX `traverse_vmem` (the Pallas
  kernel in interpret mode, as tests/test_pallas.py runs it) and as JAX
  `bvh.traverse`; on found closest-hit rays the same rows. The twin's t
  equals the JAX leaf test evaluated op by op on the winning rows (rtol
  1e-5). Against the compiled JAX traversals t agrees to rtol 1e-5 for
  triangles and 2e-3 for cones: XLA contracts the thin-cone quadratic's
  multiply-adds when it compiles (jitted and eager JAX differ by up to
  1.7e-4 on these rays), the tolerance of test_pallas_cone_matches_grid.
  (Any-hit rows are any accepted row, so they are not compared.)
* `ops/traverse.closest_hit` / `any_hit` Hit fields against JAX
  `closest_hit_bvh` / `any_hit_bvh` on the same scene.
* The slice end to end with a BVH: a fur-patch render against JAX
  `render_image(fused_shading=True)` under the image gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.models import pathtracer as jpt
from ba_pathtracing_fur_tpu.ops import bvh as jbvh, traverse as jtraverse
from ba_pathtracing_fur_tpu.ops.pallas import traverse as jptrav
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins, types as jtypes
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, traverse as ctraverse
from ba_pathtracing_fur_torch.scene import types
from test_torch_fur import _compare_images

torch.set_num_threads(2)

CPU = "cpu"
N_RAYS = 256


def _scene(kind):
    """A JAX scene with a BVH over the `kind` pack, and rays aimed into it."""
    rs = np.random.RandomState(5)
    if kind == "cone":
        js, _ = jbuiltins.fur_patch(resolution=(4, 4), fibers_per_face=120, fiber_verts=6,
                                    fiber_radius=0.01)
        js = jtraverse.attach_bvh(js, method="median", leaf_size=16, min_prims=1)
        target = rs.uniform((-0.45, 0.0, -0.45), (0.45, 0.08, 0.45), (N_RAYS, 3))
    else:  # an untextured triangle soup in the Cornell box's place
        js, _ = jbuiltins.cornell_box(resolution=(4, 4))
        v0 = rs.uniform(-1, 1, (2000, 3)).astype(np.float32) * np.float32([1, 0.2, 1])
        v1, v2 = (v0 + rs.normal(0, 0.08, (2000, 3)).astype(np.float32) for _ in range(2))
        js = js.replace(tris=jtypes.make_triangle_pack(v0, v1, v2))
        js = jtraverse.attach_bvh(js, method="median", leaf_size=32, min_prims=1)
        target = rs.uniform(-0.9, 0.9, (N_RAYS, 3)) * (1.0, 0.2, 1.0)
    o = rs.uniform(-1.2, 1.2, (N_RAYS, 3)).astype(np.float32) + np.float32([0, 1.2, 0])
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return js, o, d.astype(np.float32)


@pytest.mark.parametrize("kind", ["cone", "tri"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_twin_matches_jax(kind, any_hit):
    js, o, d = _scene(kind)
    jb = js.cone_bvh if kind == "cone" else js.tri_bvh
    tb = getattr(types.scene_from_numpy(js, device=CPU), f"{kind}_bvh")
    t_max = np.full((N_RAYS,), 1.5 if any_hit else 3.4e38, np.float32)
    t_max[::17] = 0.0  # dead rays

    refs = ctraverse.REF_CALLS
    t, row, found = (x.numpy() for x in ctraverse.traverse(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), tb, kind,
        any_hit=any_hit))
    assert ctraverse.REF_CALLS == refs + 1
    assert 0.05 < found.mean() < 0.95

    oj, dj, tj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    leaf_fn = jbvh.cone_leaf_packed(jb) if kind == "cone" else jbvh.tri_leaf_packed(jb)
    t0, r0, f0 = (np.asarray(x) for x in jbvh.traverse(jb, oj, dj, leaf_fn, 1e-4, tj,
                                                        any_hit=any_hit, chunk=4096))
    t1, r1, f1 = (np.asarray(x) for x in jptrav.traverse_vmem(
        oj, dj, jptrav.pack_boxes_cm(jb), jptrav.pack_leaf_cm(jb, kind)[0], tj, kind=kind,
        n_clusters=jb.n_leaves, leaf_k=jb.leaf_size, any_hit=any_hit, ray_tile=256))
    for f_ref in (f0, f1):
        np.testing.assert_array_equal(found, f_ref)
    np.testing.assert_array_equal(row < 0, ~found)
    np.testing.assert_array_equal(t[~found], t_max[~found])  # t_max on a miss
    if any_hit:
        assert (t[found] == 0.0).all() and (t1[found] == 0.0).all()
    else:
        rtol = 2e-3 if kind == "cone" else 1e-5
        for r_ref, t_ref in ((r0, t0), (r1, t1)):
            np.testing.assert_array_equal(row[found], r_ref[found])
            np.testing.assert_allclose(t[found], t_ref[found], rtol=rtol)
        pack = js.cones if kind == "cone" else js.tris
        rows_fn = jbvh.cone_leaf_rows if kind == "cone" else jbvh.tri_leaf_rows
        t_op = np.asarray(rows_fn(pack)(oj, dj, jnp.asarray(np.maximum(row, 0))[:, None],
                                        1e-4, tj))[:, 0]
        np.testing.assert_allclose(t[found], t_op[found], rtol=1e-5)


HIT_FIELDS = ("t", "valid", "prim_type", "prim_id", "mat_id", "position", "normal", "uv",
              "enter", "fiber_u", "fiber_v", "fiber_w")


@pytest.mark.parametrize("kind", ["cone", "tri"])
def test_hit_assembly_matches_jax(kind):
    js, o, d = _scene(kind)
    ts = types.scene_from_numpy(js, device=CPU)
    t_max = np.full((N_RAYS,), 3.4e38, np.float32)
    t_max[::13] = 0.0
    want = jtraverse.closest_hit_bvh(jnp.asarray(o), jnp.asarray(d), js,
                                     t_max=jnp.asarray(t_max))
    got = traverse.closest_hit(torch.from_numpy(o), torch.from_numpy(d), ts,
                               t_max=torch.from_numpy(t_max))
    valid = np.asarray(want.valid)
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for f in HIT_FIELDS:
        a, b = np.asarray(getattr(want, f))[valid], getattr(got, f).numpy()[valid]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f)

    tm = np.full((N_RAYS,), 1.0, np.float32)
    blocked_j = np.asarray(jtraverse.any_hit_bvh(jnp.asarray(o), jnp.asarray(d), js,
                                                 jnp.asarray(tm)))
    blocked_t = traverse.any_hit(torch.from_numpy(o), torch.from_numpy(d), ts,
                                 torch.from_numpy(tm)).numpy()
    np.testing.assert_array_equal(blocked_t, blocked_j)


def test_fur_patch_render_with_bvh_matches_jax():
    """16x16, depth 3, spp 2, with a cone BVH (and a triangle one): every
    bounce through the traversal twin and the shade twin."""
    kw = dict(depth=3, spp=2, compact=False, fused_shading=True)
    js, jc = jbuiltins.fur_patch(resolution=(16, 16), fibers_per_face=60, fiber_verts=6)
    js = jtraverse.attach_bvh(js, method="median", min_prims=1)
    a = np.asarray(jpt.render_image(js, jc, jax.random.key(0),
                                    jpt.RenderConfig(**kw, ray_chunk=256)))
    trav, shade = ctraverse.REF_CALLS, cshade.SHADE_REF_CALLS
    b = pt.render_image(types.scene_from_numpy(js, device=CPU),
                        camera_from_numpy(jc, device=CPU), rng.key(0, CPU),
                        pt.RenderConfig(**kw)).numpy()
    # per bounce: closest + any hit over each of the two BVHs, one shade
    n = kw["spp"] * kw["depth"]
    assert ctraverse.REF_CALLS - trav == 4 * n and cshade.SHADE_REF_CALLS - shade == n
    _compare_images(a, b)
