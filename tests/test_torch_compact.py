"""Stream compaction and tone mapping of the port against the JAX package.

* `ops/compact`: the three compaction cases of tests/test_compact_rr.py,
  held against the JAX package's `compaction_permutation` on masks made
  from a numpy seed;
* `render_image` with `compact=True` equals the `compact=False` render bit
  for bit: each ray's result does not depend on its position in the
  wavefront. On the Cornell box unfused (the dense grid, with chunks small
  enough that it skips the dead tail) and fused (the full-bounce twin), the
  fur patch fused (K2's and K1's twins on a cone BVH) and unfused (the
  dense grid), and a two-sample wavefront (`spp_batch=2`);
* the port's default `RenderConfig` (compaction on) against the JAX
  package's default `render_image` under the image gate of
  tests/test_fused_shade.py::_compare, on the Cornell box and a small fur
  patch;
* `ops/tonemap.tonemap` and its gradient against the JAX package's on
  random HDR images under `_close_most` (tests/test_torch_unfused.py), and
  `render_image(tonemap=True)` against JAX's.

The JAX package is imported inside the tests, so that the `cuda`-marked
checks run on the card, which has no jax:
`python -m pytest tests/test_torch_compact.py -m cuda --noconftest -p no:cacheprovider`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import compact, tonemap, traverse
from ba_pathtracing_fur_torch.scene import builtins

torch.set_num_threads(2)

CPU = "cpu"
TONEMAPS = [tonemap.TonemapParams(),
            tonemap.TonemapParams(exposure=1.0, gamma=2.2),
            tonemap.TonemapParams(gamma=2.2, use_rec_gamma=True, white=0.9, black=0.05),
            tonemap.TonemapParams(contrast=0.5, bias=0.7, gamma=1.8, use_rec_gamma=True)]


def _jcompact():
    from ba_pathtracing_fur_tpu.ops import compact as jcompact

    return jcompact


def _gate(a, b, atol_mean=5e-3, flip_frac=0.02):
    """The image gate of tests/test_fused_shade.py::_compare."""
    assert b.shape == a.shape and np.all(np.isfinite(b)) and b.max() > 0.01
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.mean() < atol_mean, f"mean {d.mean()}"
    assert np.mean(d.max(-1) > 1e-3) <= flip_frac, f"flips {np.mean(d.max(-1) > 1e-3)}"


def test_compaction_permutation_stable():
    jcompact = _jcompact()
    alive = np.array([True, False, True, True, False, False, True])
    perm, n = compact.compaction_permutation(torch.from_numpy(alive))
    jperm, jn = jcompact.compaction_permutation(alive)
    assert int(n) == int(jn) == 4 and perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(perm.numpy(), [0, 2, 3, 6, 1, 4, 5])
    inv = compact.invert_permutation(perm)
    np.testing.assert_array_equal(perm[inv.long()].numpy(), np.arange(7))


@dataclasses.dataclass
class _Soa:
    o: torch.Tensor
    t: torch.Tensor
    tag: str = "kept"


def test_compaction_gather_fields_roundtrip():
    jcompact = _jcompact()
    rs = np.random.default_rng(0)
    alive = rs.uniform(size=512) > 0.6
    data = _Soa(o=torch.from_numpy(rs.normal(size=(512, 3)).astype(np.float32)),
                t=torch.from_numpy(rs.normal(size=512).astype(np.float32)))
    perm, n = compact.compaction_permutation(torch.from_numpy(alive))
    jperm, jn = jcompact.compaction_permutation(alive)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(n) == int(jn) == alive.sum()
    packed = compact.gather_fields(data, perm)
    # the front of the packed buffer is exactly the alive rays, in order
    assert torch.equal(packed.o[:int(n)], data.o[torch.from_numpy(alive)])
    assert packed.tag == "kept"
    restored = compact.gather_fields(packed, compact.invert_permutation(perm))
    assert torch.equal(restored.t, data.t) and torch.equal(restored.o, data.o)


@pytest.mark.parametrize("alive", [np.zeros(16, bool), np.ones(16, bool)],
                         ids=["all_dead", "all_alive"])
def test_compaction_all_dead_and_all_alive(alive):
    jcompact = _jcompact()
    perm, n = compact.compaction_permutation(torch.from_numpy(alive))
    jperm, jn = jcompact.compaction_permutation(alive)
    np.testing.assert_array_equal(np.sort(perm.numpy()), np.arange(16))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(n) == int(jn) == int(alive.sum())


def _both(scene, cam, dev=CPU, **kw):
    """(compact=True render, compact=False render) with the same key."""
    a = pt.render_image(scene, cam, rng.key(3, dev), pt.RenderConfig(**kw))
    b = pt.render_image(scene, cam, rng.key(3, dev), pt.RenderConfig(**kw, compact=False))
    return a, b


def test_compact_render_equals_uncompacted_cornell_unfused(monkeypatch):
    """The dense grid in chunks of 120 rays over the 34 triangles: past
    bounce 0 it skips the chunks behind the live prefix, and the image
    stays the same bit for bit."""
    monkeypatch.setattr(traverse, "_GRID_ELEMS", 4096)
    chunks = []
    grid_chunks = traverse._grid_chunks

    def spy(r, p, n_alive):
        out = grid_chunks(r, p, n_alive)
        chunks.append((len(out), -(-r // max(1, 4096 // p))))
        return out

    monkeypatch.setattr(traverse, "_grid_chunks", spy)
    scene, cam = builtins.cornell_box(resolution=(16, 16), variant="glossy", device=CPU)
    a, b = _both(scene, cam, depth=4, spp=2, mis=True, rr=True)
    assert torch.equal(a, b) and torch.isfinite(a).all() and a.max() > 0.01
    assert any(n < total for n, total in chunks)


def test_compact_render_equals_uncompacted_cornell_fused():
    scene, cam = builtins.cornell_box(resolution=(16, 16), device=CPU)
    a, b = _both(scene, cam, depth=4, spp=2, fused_shading=True)
    assert torch.equal(a, b) and a.max() > 0.01


@pytest.mark.parametrize("fused", [False, True])
def test_compact_render_equals_uncompacted_fur_patch(fused):
    """Fused: a cone BVH (K2's and K1's twins); unfused: the dense grid."""
    scene, cam = builtins.fur_patch(resolution=(16, 16), fibers_per_face=120,
                                    fiber_verts=6, device=CPU)
    if fused:
        scene = traverse.attach_bvh(scene, min_prims=1)
    a, b = _both(scene, cam, depth=4, spp=1, fused_shading=fused, hair_p_random=True)
    assert torch.equal(a, b) and a.max() > 0.01


def test_compact_render_equals_uncompacted_spp_batch():
    """Two samples in one wavefront, compacted as one."""
    scene, cam = builtins.cornell_box(resolution=(12, 10), device=CPU)
    a, b = _both(scene, cam, depth=3, spp=4, spp_batch=2, mis=True, rr=True)
    assert torch.equal(a, b) and a.max() > 0.01


@pytest.mark.parametrize("scene_name", ["cornell", "fur_patch"])
def test_default_config_render_matches_jax(scene_name):
    """The port's RenderConfig(depth, spp) with its defaults (compact=True,
    unfused) against the JAX package's default render_image."""
    import jax

    from ba_pathtracing_fur_tpu.models import pathtracer as jpt
    from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
    from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
    from ba_pathtracing_fur_torch.scene.types import scene_from_numpy

    if scene_name == "cornell":
        js, jc = jbuiltins.cornell_box(resolution=(16, 16))
    else:
        js, jc = jbuiltins.fur_patch(resolution=(16, 16), fibers_per_face=8, fiber_verts=6)
    assert jpt.RenderConfig().compact and pt.RenderConfig().compact
    a = np.asarray(jpt.render_image(js, jc, jax.random.key(0),
                                    jpt.RenderConfig(depth=3, spp=2)))
    b = pt.render_image(scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU),
                        rng.key(0, CPU), pt.RenderConfig(depth=3, spp=2)).numpy()
    _gate(a, b)


def _hdr(seed):
    """A random HDR image with black pixels and a few very bright ones."""
    rs = np.random.default_rng(seed)
    img = rs.lognormal(-1.0, 1.5, (16, 12, 3)).astype(np.float32)
    img[rs.uniform(size=(16, 12)) < 0.1] = 0.0
    img[rs.uniform(size=(16, 12)) < 0.02] *= 50.0
    return img


@pytest.mark.parametrize("i", range(len(TONEMAPS)))
def test_tonemap_matches_jax(i):
    from ba_pathtracing_fur_tpu.ops import tonemap as jtonemap
    from test_torch_unfused import _close_most

    p = TONEMAPS[i]
    jp = jtonemap.TonemapParams(**p._asdict())
    for seed in range(3):
        img = _hdr(seed)
        got = tonemap.tonemap(torch.from_numpy(img), p).numpy()
        assert np.isfinite(got).all()
        _close_most(got, np.asarray(jtonemap.tonemap(img, jp)), f"tonemap {p} seed {seed}")


@pytest.mark.parametrize("i", range(len(TONEMAPS)))
def test_tonemap_gradient_matches_jax(i):
    """d(sum(w * tonemap(img)))/d img against jax.grad on an image without
    black pixels; with black pixels the port's gradient stays finite (0 on
    them), where the JAX package's power of 0 makes it NaN."""
    import jax
    import jax.numpy as jnp

    from ba_pathtracing_fur_tpu.ops import tonemap as jtonemap
    from test_torch_unfused import _close_most

    p = TONEMAPS[i]
    jp = jtonemap.TonemapParams(**p._asdict())
    img = _hdr(7)
    w = np.random.default_rng(8).uniform(size=img.shape).astype(np.float32)

    def grad(a):
        x = torch.from_numpy(a).requires_grad_()
        (tonemap.tonemap(x, p) * torch.from_numpy(w)).sum().backward()
        return x.grad.numpy()

    lit = img + 0.01
    want = jax.grad(lambda a: jnp.sum(jtonemap.tonemap(a, jp) * w))(jnp.asarray(lit))
    _close_most(grad(lit), np.asarray(want), f"tonemap {p} gradient", frac=0.01)
    assert np.isfinite(grad(img)).all()


def test_tonemapped_render_matches_jax():
    import jax

    from ba_pathtracing_fur_tpu.models import pathtracer as jpt
    from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
    from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
    from ba_pathtracing_fur_torch.scene.types import scene_from_numpy
    from test_torch_unfused import _close_most

    js, jc = jbuiltins.cornell_box(resolution=(16, 16))
    a = np.asarray(jpt.render_image(js, jc, jax.random.key(1),
                                    jpt.RenderConfig(depth=3, spp=2, tonemap=True)))
    ts, tc = scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU)
    b = pt.render_image(ts, tc, rng.key(1, CPU),
                        pt.RenderConfig(depth=3, spp=2, tonemap=True)).numpy()
    linear = pt.render_image(ts, tc, rng.key(1, CPU), pt.RenderConfig(depth=3, spp=2))
    np.testing.assert_array_equal(b, tonemap.tonemap(linear).numpy())
    _close_most(b, a, "tone-mapped Cornell")


@pytest.mark.cuda
def test_compact_render_equals_uncompacted_on_the_card():
    """The kernels are exact per ray, sorted or not: K4 on the Cornell box,
    K2 + K1 on the fur patch's cone BVH, K2 under the unfused bounce."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, traverse as ctraverse

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, cam = builtins.cornell_box(resolution=(64, 64), device=dev)
    launches = cshade.KERNEL_LAUNCHES
    a, b = _both(scene, cam, dev, depth=4, spp=2, fused_shading=True)
    assert cshade.KERNEL_LAUNCHES - launches == 2 * 2 * 4 and torch.equal(a, b)
    fur, fcam = builtins.fur_patch(resolution=(64, 64), fibers_per_face=400, device=dev)
    fur = traverse.attach_bvh(fur, min_prims=1)
    for fused in (True, False):
        refs = ctraverse.REF_CALLS, cshade.SHADE_REF_CALLS
        a, b = _both(fur, fcam, dev, depth=4, spp=1, fused_shading=fused)
        assert (ctraverse.REF_CALLS, cshade.SHADE_REF_CALLS) == refs
        assert torch.equal(a, b) and a.max() > 0.01
