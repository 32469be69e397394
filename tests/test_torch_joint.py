"""The joint closest + shadow pass (`RenderConfig.joint_shadows`) and the
streaming kernel's mixed mode against the JAX package on the CPU.

The scene is that of tests/test_fused_shade.py::
test_fused_joint_shadows_stream: a 12x12 hair ball of 600 fibers (4
vertices each: 1,800 cones on a two-level median BVH of leaf 64 and fanout
8; the 768 scalp triangles stay BVH-less, min_prims 1200), depth 3, spp 2.
The JAX package runs with `traverse.enable_stream_traversal(True)`, its
Pallas kernel in interpret mode, compiled in a child process with XLA's CPU
ISA capped below FMA (tests/test_torch_hairball.py: XLA contracts a*b + c
otherwise, which moves the grazing roots of thin cones). The child computes
once, for the whole module:

* JAX `traverse_stream(..., is_any=...)` on pairs of rays (a closest-hit
  ray and a shadow ray from the same origin, interleaved): the port's
  mixed plain version `ops/cuda/stream.traverse_stream_ref(is_any=...)`
  gives the same found rays, closest-hit rows and t, and t = 0 on accepted
  shadow rays;
* JAX `joint_closest_any` on the same pairs: the port's gives the same Hit
  (discrete fields exactly, the rest to rtol 1e-5, atol 1e-6, as
  tests/test_torch_hairball.py compares Hits) and the same blocked flags;
* JAX's joint image: the port's is within the image gate of
  tests/test_fused_shade.py::_compare.

On the port alone: the joint image equals the separate fused image bit for
bit (the colour sums in the same order), and the compacted joint image the
uncompacted one; a scene that `joint_eligible` refuses (the fur patch's
flat BVHs) renders with `joint_shadows=True` exactly as without it.

The child is this file run as a script: `python tests/test_torch_joint.py
OUT.npz` (with `JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`).
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.ops.cuda import stream as cstream
from ba_pathtracing_fur_torch.scene import builtins

torch.set_num_threads(2)

CPU = "cpu"
SCENE = dict(resolution=(12, 12), n_fibers=600, fiber_verts=4)
BVH = dict(method="median", min_prims=1200, leaf_size=64, fanout=8)
KW = dict(depth=3, spp=2, compact=False)
N_PAIRS = 384
#: caps XLA's CPU code at an ISA without FMA (tests/test_torch_hairball.py)
_NO_FMA = "--xla_cpu_max_isa=SSE4_2"
_HERE = os.path.dirname(os.path.abspath(__file__))
_HIT_EXACT = ("valid", "prim_type", "prim_id", "mat_id", "enter")
_HIT_CLOSE = ("t", "position", "normal", "uv", "fiber_u", "fiber_v", "fiber_w")


def _pairs():
    """N_PAIRS (closest ray, shadow ray) pairs sharing an origin around the
    ball, each ray aimed at a point of the fur between radii 0.5 and 0.65:
    the closest rays with t_max inf (every 17th dead), the shadow rays with
    t_max in [0, 1.5) (every 13th dead)."""
    rs = np.random.RandomState(7)

    def toward_fur(o):
        p = rs.normal(0, 1, (N_PAIRS, 3))
        p *= rs.uniform(0.5, 0.65, (N_PAIRS, 1)) / np.linalg.norm(p, axis=-1, keepdims=True)
        d = (p - o).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    o = rs.uniform(-1.2, 1.2, (N_PAIRS, 3)).astype(np.float32)
    d_c, d_a = toward_fur(o), toward_fur(o)
    t_c = np.full((N_PAIRS,), 3.4e38, np.float32)
    t_c[::17] = 0.0
    t_a = rs.uniform(0.0, 1.5, (N_PAIRS,)).astype(np.float32)
    t_a[::13] = 0.0
    return o, d_c, t_c, o.copy(), d_a, t_a


def _interleaved(o_c, d_c, t_c, o_a, d_a, t_a):
    """The pairs as one mixed wavefront: closest rays in the even slots."""
    def mix(a, b):
        return np.stack([a, b], 1).reshape((-1,) + a.shape[1:])
    return mix(o_c, o_a), mix(d_c, d_a), mix(t_c, t_a), np.arange(2 * len(o_c)) % 2 == 1


def _jax_results(out_path):
    """The child's work: JAX's mixed kernel and joint pass on `_pairs`, and
    its joint image, saved to `out_path`."""
    import jax
    import jax.numpy as jnp

    from ba_pathtracing_fur_tpu import native as jnative
    from ba_pathtracing_fur_tpu.models import pathtracer as jpt
    from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
    from ba_pathtracing_fur_tpu.ops.pallas import stream as jstream
    from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins

    jax.config.update("jax_platforms", "cpu")
    jnative.median_split = jnative.ranges_to_perm = lambda *a, **k: None
    scene, cam = jbuiltins.hair_ball(**SCENE)
    scene = jtraverse.attach_bvh(scene, **BVH)
    jtraverse.enable_stream_traversal(True)
    assert jtraverse.joint_eligible(scene)
    pairs = _pairs()
    o2, d2, t2, is_any = _interleaved(*pairs)
    b = scene.cone_bvh
    t, row, found = jstream.traverse_stream(
        jnp.asarray(o2), jnp.asarray(d2), jstream.pack_super_boxes(b),
        jstream.pack_child_boxes(b), jstream.pack_prim_hbm(b, "cone")[0], jnp.asarray(t2),
        kind="cone", fanout=b.fanout, leaf_k=b.leaf_size, is_any=jnp.asarray(is_any, jnp.float32))
    hit, blocked = jtraverse.joint_closest_any(*(jnp.asarray(x) for x in pairs), scene)
    img = jpt.render_image(scene, cam, jax.random.key(0), jpt.RenderConfig(
        **KW, ray_chunk=256, fused_shading=True, joint_shadows=True))
    np.savez(out_path, t=t, row=row, found=found, blocked=blocked, img=img,
             **{f"hit_{f}": getattr(hit, f) for f in _HIT_EXACT + _HIT_CLOSE})


@pytest.fixture(scope="module")
def jax_out():
    """The child's results (JAX compiled without FMA)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {_NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join([os.path.dirname(_HERE), _HERE]))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "jax.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__), out], env=env, check=True,
                       timeout=600)
        return dict(np.load(out))


@pytest.fixture(scope="module")
def hair_ball():
    scene, cam = builtins.hair_ball(**SCENE, device=CPU)
    scene = traverse.attach_bvh(scene, **BVH)
    assert traverse.joint_eligible(scene) and scene.tri_bvh is None
    assert (scene.cone_bvh.n_leaves, scene.cone_bvh.fanout) == (32, 8)
    return scene, cam


def _render(scene, cam, **cfg):
    return pt.render_image(scene, cam, rng.key(0, CPU), pt.RenderConfig(
        **{**KW, "fused_shading": True, **cfg})).numpy()


def test_mixed_plain_matches_jax_traverse_stream(hair_ball, jax_out):
    scene, _ = hair_ball
    o2, d2, t2, is_any = _interleaved(*_pairs())
    refs, mixed = cstream.REF_CALLS, cstream.MIXED_LAUNCHES
    t, row, found = (x.numpy() for x in cstream.traverse_stream(
        torch.from_numpy(o2), torch.from_numpy(d2), torch.from_numpy(t2), scene.cone_bvh,
        "cone", is_any=torch.from_numpy(is_any)))
    assert (cstream.REF_CALLS, cstream.MIXED_LAUNCHES) == (refs + 1, mixed)
    c, a = ~is_any, is_any
    assert 0.05 < found[c].mean() < 0.95 and 0.05 < found[a].mean() < 0.95
    np.testing.assert_array_equal(found, jax_out["found"])
    np.testing.assert_array_equal(row[c], jax_out["row"][c])
    np.testing.assert_array_equal(row < 0, ~found)
    np.testing.assert_allclose(t[c], jax_out["t"][c], rtol=1e-6)
    # an accepted shadow ray ends at t = 0, a missed one keeps its t_max
    assert (t[a & found] == 0.0).all() and (jax_out["t"][a & found] == 0.0).all()
    np.testing.assert_array_equal(t[a & ~found], t2[a & ~found])
    # each ray gets what its own mode's brute force gives it
    for flag in (False, True):
        m = is_any == flag
        want = cstream.traverse_stream(torch.from_numpy(o2[m]), torch.from_numpy(d2[m]),
                                       torch.from_numpy(t2[m]), scene.cone_bvh, "cone",
                                       any_hit=flag)
        np.testing.assert_array_equal(found[m], want[2].numpy())
        np.testing.assert_array_equal(t[m], want[0].numpy())


def test_mixed_flags_exclude_any_hit(hair_ball):
    scene, _ = hair_ball
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="exclude"):
        cstream.traverse_stream(o, o + 1.0, torch.ones(4), scene.cone_bvh, "cone",
                                any_hit=True, is_any=torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="is_any must be"):
        cstream.traverse_stream(o, o + 1.0, torch.ones(4), scene.cone_bvh, "cone",
                                is_any=torch.ones(3))


def test_work_ref_counts_a_mixed_launch_as_its_two_sets(hair_ball):
    """The mixed launch's bound (`work_ref` with the flags) counts the tests
    of its closest-hit set and of its any-hit set, and the leaves of both."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    scene, _ = hair_ball
    o2, d2, t2, is_any = (torch.from_numpy(x) for x in _interleaved(*_pairs()))
    bvh = scene.cone_bvh
    w = ctraverse.work_ref(o2, d2, t2, bvh, "cone", is_any=is_any)
    wc, wa = (ctraverse.work_ref(o2[m], d2[m], t2[m], bvh, "cone", any_hit=flag)
              for m, flag in ((~is_any, False), (is_any, True)))
    for k in ("rays", "box_tests", "leaf_row_tests", "flops"):
        assert w[k] == wc[k] + wa[k], k
    assert max(wc["leaves_entered"], wa["leaves_entered"]) <= w["leaves_entered"] \
        <= wc["leaves_entered"] + wa["leaves_entered"]
    assert wa["leaf_row_tests"] > 0 and wc["leaf_row_tests"] > 0


def test_joint_closest_any_matches_jax(hair_ball, jax_out):
    scene, _ = hair_ball
    pairs = [torch.from_numpy(x) for x in _pairs()]
    refs = cstream.REF_CALLS
    hit, blocked = traverse.joint_closest_any(*pairs, scene)
    assert cstream.REF_CALLS == refs + 1  # one mixed pass for both sets
    valid = jax_out["hit_valid"]
    assert 0.1 < valid.mean() < 0.95 and 0.05 < blocked.double().mean() < 0.95
    np.testing.assert_array_equal(blocked.numpy(), jax_out["blocked"])
    np.testing.assert_array_equal(hit.valid.numpy(), valid)
    np.testing.assert_array_equal(hit.prim_type.numpy(), jax_out["hit_prim_type"])
    for f in _HIT_EXACT[2:]:
        np.testing.assert_array_equal(getattr(hit, f).numpy()[valid], jax_out[f"hit_{f}"][valid],
                                      err_msg=f)
    for f in _HIT_CLOSE:
        np.testing.assert_allclose(getattr(hit, f).numpy()[valid], jax_out[f"hit_{f}"][valid],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    # the same answers as the separate passes, ray for ray
    o_c, d_c, t_c, o_a, d_a, t_a = pairs
    want = traverse.closest_hit(o_c, d_c, scene, t_max=t_c)
    for f in dataclasses.fields(hit):
        assert torch.equal(getattr(hit, f.name), getattr(want, f.name)), f.name
    assert torch.equal(blocked, traverse.any_hit(o_a, d_a, scene, t_a))


def test_joint_closest_any_without_the_sort_and_on_k5(hair_ball, monkeypatch):
    """The pass without the pair sort (SORT_RAYS off) and with the scalp on
    K5's plain version (its threshold patched below 384 x 768 pairs) gives
    the same answers."""
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect

    scene, _ = hair_ball
    pairs = [torch.from_numpy(x) for x in _pairs()]
    hit, blocked = traverse.joint_closest_any(*pairs, scene)
    monkeypatch.setattr(traverse, "SORT_RAYS", False)
    hit2, blocked2 = traverse.joint_closest_any(*pairs, scene)
    monkeypatch.setattr(traverse, "SORT_RAYS", True)
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 16)
    k5 = cisect.REF_CALLS
    hit3, blocked3 = traverse.joint_closest_any(*pairs, scene)
    assert cisect.REF_CALLS == k5 + 2  # the scalp for both sets
    assert torch.equal(blocked, blocked2) and torch.equal(blocked, blocked3)
    for f in dataclasses.fields(hit):
        assert torch.equal(getattr(hit, f.name), getattr(hit2, f.name)), f.name
        assert torch.equal(getattr(hit, f.name), getattr(hit3, f.name)), f.name


def test_joint_image_matches_jax(hair_ball, jax_out):
    from test_torch_fur import _compare_images

    scene, cam = hair_ball
    refs = cstream.REF_CALLS
    img = _render(scene, cam, joint_shadows=True)
    # a mixed pass a bounce, one any-hit pass a sample after the loop
    assert cstream.REF_CALLS - refs == KW["spp"] * (KW["depth"] + 1)
    _compare_images(jax_out["img"], img)


def test_joint_image_equals_separate_fused_image(hair_ball):
    scene, cam = hair_ball
    refs = cstream.REF_CALLS
    separate = _render(scene, cam)
    assert cstream.REF_CALLS - refs == 2 * KW["spp"] * KW["depth"]
    joint = _render(scene, cam, joint_shadows=True)
    assert np.isfinite(joint).all() and joint.max() > 0.01
    np.testing.assert_array_equal(joint, separate)


def test_joint_compacted_equals_uncompacted(hair_ball, monkeypatch):
    """With compaction the joint image is the same; a lane whose path died
    stays alive while its shadow ray is pending, so the joint wavefront
    keeps more live lanes than the separate one."""
    from ba_pathtracing_fur_torch.ops import compact

    scene, cam = hair_ball
    joint = _render(scene, cam, joint_shadows=True)
    counts, perm_fn = [], compact.compaction_permutation

    def spy(alive):
        perm, n = perm_fn(alive)
        counts.append(int(n))
        return perm, n

    monkeypatch.setattr(compact, "compaction_permutation", spy)
    compacted = _render(scene, cam, joint_shadows=True, compact=True)
    n_joint, counts[:] = counts[:], []
    _render(scene, cam, compact=True)
    assert len(n_joint) == len(counts) == KW["spp"] * KW["depth"]
    assert all(a >= b for a, b in zip(n_joint, counts)) and n_joint != counts
    np.testing.assert_array_equal(compacted, joint)


def test_ineligible_scene_renders_as_without_joint():
    """The fur patch has a flat cone BVH and a triangle BVH: no joint pass,
    the ordinary fused bounces."""
    scene, cam = builtins.fur_patch(resolution=(10, 8), fibers_per_face=120, fiber_verts=4,
                                    device=CPU)
    scene = traverse.attach_bvh(scene, min_prims=1)
    assert not traverse.joint_eligible(scene) and scene.tri_bvh is not None
    refs = cstream.REF_CALLS
    a = _render(scene, cam)
    b = _render(scene, cam, joint_shadows=True)
    assert cstream.REF_CALLS == refs and np.isfinite(b).all() and b.max() > 0.01
    np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    # python tests/test_torch_joint.py OUT.npz: save the JAX package's results
    _jax_results(sys.argv[1])
