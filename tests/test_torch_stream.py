"""The twins of the streaming traversal kernel (K3) and the brute-force
kernel (K5) against the JAX package's Pallas kernels, on the CPU.

* `ops/cuda/stream.traverse_stream` (CPU tensors: its brute-force twin) on
  a two-level cone BVH (leaf 16, fanout 8) carried across from the JAX
  package, against JAX `traverse_stream` in interpret mode, as
  tests/test_pallas.py::test_stream_traversal_matches_xla_traversal runs
  it: the same found rays and, on found closest-hit rays, the same rows;
  t to rtol 2e-3 (XLA contracts the thin-cone quadratic when it compiles,
  the tolerance of test_pallas_cone_matches_grid). That contraction also
  flips grazing rays (6 of 512 here, closest hit): on at most 2% of rays
  the compiled kernel may differ in found or row, and there JAX's own leaf
  test run op by op gives the twin's found and row.
* `ops/cuda/intersect.closest` (CPU: its twin) against JAX `tri_closest` /
  `cone_closest` in interpret mode, as tests/test_pallas.py:24-62: the
  same hit rays and indices, t to rtol 1e-5 (triangles) / 2e-3 (cones).
* `ops/traverse` routes a two-level BVH to K3 and a flat one to K2, and
  the two give the same Hit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.ops import bvh as jbvh, traverse as jtraverse
from ba_pathtracing_fur_tpu.ops.pallas import intersect as jpk, stream as jstream
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, stream as cstream, \
    traverse as ctraverse
from ba_pathtracing_fur_torch.scene import builtins, types

torch.set_num_threads(2)

CPU = "cpu"
N_RAYS = 512


def _rays(n, seed, aim):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = (rs.uniform(aim[0], aim[1], (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.fixture(scope="module")
def two_level():
    """A JAX fur patch with a two-level cone BVH, the port's copy of it and
    rays aimed into it."""
    js, _ = jbuiltins.fur_patch(resolution=(16, 16), fibers_per_face=120, fiber_verts=6)
    js = jtraverse.attach_bvh(js, method="median", min_prims=1, leaf_size=16, fanout=8)
    assert js.cone_bvh.fanout == 8 and js.cone_bvh.n_leaves == 128
    o, d = _rays(N_RAYS, 5, ((-0.4, 0.0, -0.4), (0.4, 0.12, 0.4)))
    return js, types.scene_from_numpy(js, device=CPU), o, d


def _jax_op_by_op(o, d, t_max, bvh):
    """JAX's cone leaf test (`ops/bvh._cone_core`) run op by op over every
    row of the reordered pack -> (found, row of the nearest hit)."""
    comp = [jnp.asarray(c.numpy()) for c in ctraverse._rows_cm(bvh)]
    t = np.asarray(jbvh._cone_core(jnp.asarray(o), jnp.asarray(d), comp, 1e-4,
                                   jnp.asarray(t_max)))
    return t.min(-1) < 3.4e38, t.argmin(-1)


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_twin_matches_jax_traverse_stream(two_level, any_hit):
    js, ts, o, d = two_level
    jb, tb = js.cone_bvh, ts.cone_bvh
    t_max = np.full((N_RAYS,), 2.5 if any_hit else 3.4e38, np.float32)
    t_max[::19] = 0.0  # dead rays
    refs = cstream.REF_CALLS
    t, row, found = (x.numpy() for x in cstream.traverse_stream(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), tb, "cone",
        any_hit=any_hit))
    assert cstream.REF_CALLS == refs + 1
    assert 0.05 < found.mean() < 0.95
    t1, r1, f1 = (np.asarray(x) for x in jstream.traverse_stream(
        jnp.asarray(o), jnp.asarray(d), jstream.pack_super_boxes(jb),
        jstream.pack_child_boxes(jb), jstream.pack_prim_hbm(jb, "cone")[0],
        jnp.asarray(t_max), kind="cone", fanout=jb.fanout, leaf_k=jb.leaf_size,
        any_hit=any_hit, ray_tile=128))
    np.testing.assert_array_equal(row < 0, ~found)
    np.testing.assert_array_equal(t[~found], t_max[~found])
    # Compiled JAX contracts the thin-cone quadratic's multiply-adds: on a
    # few grazing rays it accepts or picks another cone than its own leaf
    # test run op by op, which the twin equals.
    differ = (found != f1) | (~np.bool_(any_hit) & found & (row != r1))
    assert differ.mean() <= 0.02
    if differ.any():
        f_op, r_op = _jax_op_by_op(o[differ], d[differ], t_max[differ], tb)
        np.testing.assert_array_equal(found[differ], f_op)
        if not any_hit:
            np.testing.assert_array_equal(row[differ][f_op], r_op[f_op])
    same = found & ~differ
    if any_hit:
        assert (t[found] == 0.0).all() and (t1[same] == 0.0).all()
    else:
        np.testing.assert_allclose(t[same], t1[same], rtol=2e-3)


@pytest.mark.parametrize("kind", ["tri", "cone"])
def test_bruteforce_twin_matches_jax_kernels(kind):
    if kind == "tri":
        js, _ = jbuiltins.hair_ball(resolution=(8, 8), n_fibers=20)
        pack, jpacked = js.tris, jpk.pack_tris_cm(js.tris)[0]
        o, d = _rays(400, 0, ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)))
        jfn, rtol = jpk.tri_closest, 1e-5
    else:
        js, _ = jbuiltins.fur_patch(resolution=(8, 8), fibers_per_face=16, fiber_verts=5,
                                    fiber_radius=0.02)
        pack, jpacked = js.cones, jpk.pack_cones_cm(js.cones)[0]
        o, d = _rays(400, 1, ((-0.4, 0.0, -0.4), (0.4, 0.12, 0.4)))
        jfn, rtol = jpk.cone_closest, 2e-3
    tpack = getattr(types.scene_from_numpy(js, device=CPU), "tris" if kind == "tri"
                    else "cones")
    tables = cisect.brute_tables(tpack, kind)
    np.testing.assert_array_equal(tables.cm.numpy(), np.asarray(jpacked)[:, :pack.count])
    t_max = torch.full((400,), 3.4e38)
    refs = cisect.REF_CALLS
    t, idx = (x.numpy() for x in cisect.closest(torch.from_numpy(o), torch.from_numpy(d),
                                                  t_max, tables, kind))
    assert cisect.REF_CALLS == refs + 1
    t1, i1 = (np.asarray(x) for x in jfn(jnp.asarray(o), jnp.asarray(d), jpacked))
    hit = t < 1e30
    assert 0.1 < hit.mean() < 0.95
    np.testing.assert_array_equal(hit, t1 < 1e30)
    np.testing.assert_array_equal(idx < 0, ~hit)
    np.testing.assert_allclose(t[hit], t1[hit], rtol=rtol)
    np.testing.assert_array_equal(idx[hit], i1[hit])
    # a dead ray (t_max <= 0) is a miss
    t_max[::7] = 0.0
    t2, i2 = cisect.closest(torch.from_numpy(o), torch.from_numpy(d), t_max, tables, kind)
    assert (t2[::7] == 3.4e38).all() and (i2[::7] == -1).all()
    assert torch.equal(t2[1::7], torch.from_numpy(t[1::7]))
    # a hit at or beyond t_max is a miss (the port's kernel takes t_max)
    cut = torch.from_numpy(np.where(hit, t * 0.999, 3.4e38).astype(np.float32))
    t3, i3 = cisect.closest(torch.from_numpy(o), torch.from_numpy(d), cut, tables, kind)
    assert (i3[torch.from_numpy(hit)] != torch.from_numpy(idx[hit])).all()
    assert ((t3 < cut) | (i3 == -1)).all()


def test_dispatch_two_level_to_k3_and_flat_to_k2(two_level):
    """The same BVH as a two-level one (K3) and as a flat one (fanout 0,
    K2): the same Hit; the K3 twin runs for the first only."""
    _, ts, o, d = two_level
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    flat = dataclasses.replace(ts, cone_bvh=dataclasses.replace(ts.cone_bvh, fanout=0))
    k3, k2 = cstream.REF_CALLS, ctraverse.REF_CALLS
    hit = traverse.closest_hit(o, d, ts)
    blocked = traverse.any_hit(o, d, ts, torch.full((N_RAYS,), 1.0))
    # the patch's 2 ground triangles have a flat BVH of their own: K2
    assert (cstream.REF_CALLS - k3, ctraverse.REF_CALLS - k2) == (2, 2)
    hit_flat = traverse.closest_hit(o, d, flat)
    blocked_flat = traverse.any_hit(o, d, flat, torch.full((N_RAYS,), 1.0))
    assert (cstream.REF_CALLS - k3, ctraverse.REF_CALLS - k2) == (2, 6)
    assert torch.equal(blocked, blocked_flat) and blocked.any()
    for f in dataclasses.fields(hit):
        assert torch.equal(getattr(hit, f.name), getattr(hit_flat, f.name)), f.name


@pytest.mark.parametrize("any_hit", [False, True])
def test_work_ref_counts_the_leaves_it_enters(two_level, any_hit):
    """The leaves of the bound's byte count: every leaf that holds a ray's
    winning row is entered, no more leaves than the BVH has, their bytes
    are the packed [W, K] blocks and their unit boxes, the rows tested lie
    in the entered units (fewer than the entered leaves hold), and dead
    rays enter none."""
    _, ts, o, d = two_level
    b = ts.cone_bvh
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = torch.full((N_RAYS,), 2.5 if any_hit else 3.4e38)
    w = ctraverse.work_ref(o, d, t_max, b, "cone", any_hit=any_hit)
    _, row, found = ctraverse.brute_force(o, d, t_max, b, "cone", any_hit=False)
    winners = torch.unique(row[found].long() // b.leaf_size).numel()
    assert 0 < winners <= w["leaves_entered"] <= b.n_leaves
    assert w["leaf_bytes"] == w["leaves_entered"] * (16 * b.leaf_size + 6 * 1) * 4
    assert int(found.sum()) <= w["leaf_row_tests"]
    dead = ctraverse.work_ref(o, d, torch.zeros(N_RAYS), b, "cone", any_hit=any_hit)
    assert dead["leaves_entered"] == 0 and dead["leaf_row_tests"] == 0


def test_work_ref_counts_hits_on_a_flat_leafs_face():
    """A Cornell wall's triangles make flat leaves, and a hit on one lies on
    its leaf box's face: the slab test enters the box at the hit's t, which
    the bound counts (the kernel's entry test takes t <= best t). Every hit
    ray counts at least its winning row's unit, also where the box entry
    rounds an ulp past the row test's t."""
    from ba_pathtracing_fur_torch.ops import bvh as bvh_mod

    ts, _ = builtins.cornell_box(resolution=(8, 8), device=CPU)
    b = traverse.attach_bvh(ts, leaf_size=4, min_prims=1).tri_bvh
    c = b.n_leaves
    o, d = _rays(256, 0, ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3)))
    o = torch.from_numpy(o * np.float32(0.15))
    d = torch.from_numpy(d)
    t_max = torch.full((256,), 3.4e38)
    t, row, found = ctraverse.brute_force(o, d, t_max, b, "tri")
    leaf = row.long() // b.leaf_size
    flat = ((b.bmax[c - 1:] - b.bmin[c - 1:]) == 0).any(1)
    e = ctraverse._slab_entry(o, d, b.bmin[c - 1:], b.bmax[c - 1:], t)
    at_t = e[torch.arange(256), leaf] == t
    assert int((found & flat[leaf] & at_t).sum()) > 10
    for i in found.nonzero()[:, 0].tolist():
        w = ctraverse.work_ref(o[i:i + 1], d[i:i + 1], t_max[i:i + 1], b, "tri",
                               hit=(t[i:i + 1], row[i:i + 1], found[i:i + 1]))
        assert w["leaf_row_tests"] >= min(bvh_mod.UNIT, b.leaf_size), i
        assert w["leaves_entered"] >= 1


@pytest.mark.parametrize("leaf", [16, 40, 88])
def test_unit_boxes_bound_their_rows(leaf):
    """attach_bvh caches the boxes of each leaf's runs of UNIT rows: each
    run's box is the union of its real rows' AABBs (padding rows and rows
    past the leaf inverted), and the runs of a leaf make up its box."""
    from ba_pathtracing_fur_torch.ops import bvh as bvh_mod, intersect

    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=60, device=CPU)
    ts = traverse.attach_bvh(ts, leaf_size=leaf, min_prims=1)
    b = ts.cone_bvh
    u = -(-leaf // bvh_mod.UNIT)
    assert b.uboxes.shape == (b.n_leaves, 6, u) and b.uboxes.is_contiguous()
    lo, hi = intersect.cone_aabbs(ts.cones)
    for j in (0, b.n_leaves // 2, b.n_leaves - 1):
        for k in range(u):
            rows = torch.arange(j * leaf + k * bvh_mod.UNIT, min(j * leaf + (k + 1) *
                                                                 bvh_mod.UNIT, (j + 1) * leaf))
            rows = rows[b.perm[rows] >= 0]
            if rows.numel():
                assert torch.equal(b.uboxes[j, :3, k], lo[rows].amin(0))
                assert torch.equal(b.uboxes[j, 3:, k], hi[rows].amax(0))
            else:
                assert (b.uboxes[j, :3, k] > b.uboxes[j, 3:, k]).all()
        leaf_node = b.n_leaves - 1 + j
        assert torch.equal(b.uboxes[j, :3].amin(1), b.bmin[leaf_node])
        assert torch.equal(b.uboxes[j, 3:].amax(1), b.bmax[leaf_node])


def test_child_and_super_tables_match_the_heap():
    """pack_super_boxes / pack_child_boxes read the heap's super level and
    leaf level; attach_bvh caches them on a two-level BVH."""
    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=60, device=CPU)
    b = traverse.attach_bvh(ts, leaf_size=8, fanout=4, min_prims=1).cone_bvh
    s, f = b.n_leaves // b.fanout, b.fanout
    assert b.sboxes.shape == (6, s) and b.cboxes.shape == (s, 6, f)
    assert torch.equal(b.sboxes[:3].T, b.bmin[s - 1:2 * s - 1])
    assert torch.equal(b.cboxes[2, 3:, 1], b.bmax[b.n_leaves - 1 + 2 * f + 1])
    assert torch.equal(cstream.pack_child_boxes(b), b.cboxes)
