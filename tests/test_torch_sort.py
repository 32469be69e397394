"""The entry-morton ray sort of the port's traversal against the JAX package,
on the CPU.

* `ops/bvh.morton_codes` and `ops/traverse._entry_morton_perms` give JAX's
  keys and permutation exactly, on the camera, bounce and shadow wavefronts
  of a small hair ball (a two-level cone BVH) with dead rays mixed in;
  `ops/compact.invert_permutation` gives JAX's inverse.
* `closest_hit` / `any_hit` with the sort give the same Hit and the same
  blocked flags per ray as without it: the fur patch (flat cone BVH and a
  triangle BVH), the hair ball with a forced two-level BVH, and a Cornell box
  with a triangle BVH. The traversal twins run in both cases.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.ops import bvh as jbvh, compact as jcompact, traverse as jtraverse
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import bvh, compact, traverse
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, stream as cstream, \
    traverse as ctraverse
from ba_pathtracing_fur_torch.scene import builtins, types

torch.set_num_threads(2)

CPU = "cpu"
RES = (16, 16)


@pytest.fixture(scope="module")
def hair_ball():
    """A JAX hair ball with a two-level cone BVH (leaf 16, fanout 8), the
    port's copy of it, and the port's camera, bounce-1 and shadow wavefronts
    (o, d, t_max) of one sample, with dead rays in each."""
    js, _ = jbuiltins.hair_ball(resolution=RES, n_fibers=400)
    js = jtraverse.attach_bvh(js, method="median", leaf_size=16, fanout=8)
    _, cam = builtins.hair_ball(resolution=RES, n_fibers=400, device=CPU)
    ts = types.scene_from_numpy(js, device=CPU)
    assert 0 < ts.cone_bvh.fanout < ts.cone_bvh.n_leaves
    cfg = pt.RenderConfig(depth=2, spp=1, compact=False, fused_shading=True)
    ids = torch.arange(RES[0] * RES[1])
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, CPU), [0], cfg)
    cam_tmax = torch.full((ids.shape[0],), traverse.INF)
    cam_tmax[::7] = 0.0
    hit = traverse.closest_hit(state.origin, state.direction, ts, t_max=cam_tmax)
    sh = cshade.shade_bounce_ref(**pt.shade_inputs(state, ts, keys, 0, cfg, hit,
                                                   pt.BounceTables.of(ts)))
    alive = (sh["radiance"] != 0.0).any(-1) & (sh["direction"] != 0.0).any(-1)
    waves = {"camera": (state.origin, state.direction, cam_tmax),
             "bounce": (sh["origin"], sh["direction"], torch.where(alive, traverse.INF, 0.0)),
             "shadow": (sh["shadow_o"], sh["shadow_d"], sh["shadow_tmax"])}
    for o, d, t_max in waves.values():
        assert 0 < int((t_max <= 0).sum()) < o.shape[0]
    return js, ts, waves


def _jax_entry_points(o, d, bvh):
    """JAX `_entry_morton_perms`'s entry points and box, op by op."""
    lo, hi = bvh.bmin[0] - 1e-3, bvh.bmax[0] + 1e-3
    eps = 1e-20
    inv = 1.0 / jnp.where(jnp.abs(d) < eps, jnp.where(d < 0, -eps, eps), d)
    tn = jnp.max(jnp.minimum((lo[None] - o) * inv, (hi[None] - o) * inv), axis=1)
    return jnp.clip(o + jnp.maximum(tn, 0.0)[:, None] * d, lo[None], hi[None]), lo, hi


@pytest.mark.parametrize("wave", ["camera", "bounce", "shadow"])
def test_entry_morton_keys_and_perms_equal_jax(hair_ball, wave):
    js, ts, waves = hair_ball
    o, d, t_max = waves[wave]
    jo, jd, jt = (jnp.asarray(x.numpy()) for x in (o, d, t_max))
    p, lo, hi = _jax_entry_points(jo, jd, js.cone_bvh)
    want_key = np.asarray(jnp.where(jt <= 0.0, 1 << 30,
                                    jbvh.morton_codes(p, lo, hi).astype(jnp.int32)))
    got_key = bvh.morton_codes(*(torch.from_numpy(np.array(x)) for x in (p, lo, hi)))
    got_key = torch.where(t_max <= 0.0, 1 << 30, got_key)
    np.testing.assert_array_equal(got_key.numpy(), want_key)
    live = want_key < 1 << 30
    assert len(np.unique(want_key[live])) > live.sum() // 2  # the key spreads the rays

    perm, inv = traverse._entry_morton_perms(o, d, t_max, ts.cone_bvh)
    jperm, jinv = jtraverse._entry_morton_perms(jo, jd, jt, js.cone_bvh)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert not torch.equal(perm, torch.arange(o.shape[0]))
    dead = int((t_max <= 0).sum())
    assert bool((t_max[perm[-dead:]] <= 0).all())  # dead rays last


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_invert_permutation_equals_jax(n):
    perm = np.random.default_rng(n).permutation(n).astype(np.int32)
    got = compact.invert_permutation(torch.from_numpy(perm).long())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcompact.invert_permutation(
        jnp.asarray(perm))))


def test_morton_codes_equal_jax_at_the_box_edges():
    np.testing.assert_array_equal(
        bvh._expand_bits_10(torch.arange(1024)).numpy(),
        np.asarray(jbvh._expand_bits_10(jnp.arange(1024))).astype(np.int64))
    rs = np.random.default_rng(3)
    lo, hi = np.float32([-1.0, -0.5, 0.0]), np.float32([1.0, 0.5, 2.0])
    p = rs.uniform(-1.2, 2.2, (5000, 3)).astype(np.float32)
    p[:10] = lo
    p[10:20] = hi
    got = bvh.morton_codes(torch.from_numpy(p), torch.from_numpy(lo), torch.from_numpy(hi))
    want = np.asarray(jbvh.morton_codes(jnp.asarray(p), jnp.asarray(lo), jnp.asarray(hi)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) < 1 << 30 and int(got[10]) == (1 << 30) - 1


def _scene(name):
    if name == "fur_patch":  # a flat cone BVH and a triangle BVH
        fur, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=150, device=CPU)
        return traverse.attach_bvh(fur, leaf_size=16, min_prims=1)
    if name == "hair_ball":  # a two-level cone BVH
        hb, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=400, device=CPU)
        return traverse.attach_bvh(hb, leaf_size=16, fanout=8)
    box, _ = builtins.cornell_box(resolution=(4, 4), device=CPU)
    return traverse.attach_bvh(box, leaf_size=8, min_prims=1)


@pytest.mark.parametrize("name", ["fur_patch", "hair_ball", "cornell"])
def test_sorted_traversal_gives_the_unsorted_hit(name, monkeypatch):
    scene = _scene(name)
    rs = np.random.default_rng(11)
    n = 600
    o = torch.from_numpy(rs.uniform(-1.0, 1.0, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rs.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)) * 0.5 - o, dim=-1)
    t_max = torch.full((n,), traverse.INF)
    t_max[::9] = 0.0
    shadow_t = torch.full((n,), 0.8)
    shadow_t[1::9] = 0.0
    assert traverse.SORT_RAYS  # the default
    refs = ctraverse.REF_CALLS + cstream.REF_CALLS
    sorted_hit = traverse.closest_hit(o, d, scene, t_max=t_max)
    assert ctraverse.REF_CALLS + cstream.REF_CALLS > refs  # a traversal twin ran
    blocked = traverse.any_hit(o, d, scene, shadow_t)
    monkeypatch.setattr(traverse, "SORT_RAYS", False)
    plain_hit = traverse.closest_hit(o, d, scene, t_max=t_max)
    assert 0.05 < sorted_hit.valid.double().mean() < 0.95
    for f in dataclasses.fields(sorted_hit):
        assert torch.equal(getattr(sorted_hit, f.name), getattr(plain_hit, f.name)), f.name
    assert torch.equal(blocked, traverse.any_hit(o, d, scene, shadow_t))
    assert blocked.any() and not blocked.all()
