"""The port's texture atlas (`scene/texture.py`) and the textured scene
state against the JAX package on the CPU.

* `build_atlas` equals JAX's array for array on 1-4-channel uint8 and
  float images of mixed sizes, one of them past the size cap.
* `fetch_bilinear` equals JAX's to atol 1e-6 with uv in [-3, 3] (the
  wrap), RGB and RGBA fetches, with and without per-texture sizes.
* `scene_from_numpy` reads a textured JAX scene: the atlas, its sizes and
  the scene's `tex_slots` (before, the atlas' NamedTuple raised in numpy).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins, texture as jtexture
from ba_pathtracing_fur_torch.scene import builtins, texture, types

torch.set_num_threads(2)


def _images(rs, case):
    """Mixed images: every channel count in uint8 and float32."""
    shapes = {"mixed": [(5, 7, 1), (9, 4, 2), (6, 6, 3), (3, 8, 4), (4, 4)],
              "past_cap": [(40, 24, 3), (8, 8, 4), (12, 50, 1)],
              "one": [(16, 16, 3)]}[case]
    out = []
    for i, s in enumerate(shapes):
        if i % 2:
            out.append(rs.integers(0, 256, s).astype(np.uint8))
        else:
            out.append(rs.uniform(0, 1, s).astype(np.float32))
    return out


@pytest.mark.parametrize("case,size", [("mixed", None), ("past_cap", 32), ("one", None),
                                       ("mixed", 6)])
def test_build_atlas_equals_jax(case, size):
    rs = np.random.default_rng(0)
    imgs = _images(rs, case)
    want = jtexture.build_atlas(imgs, size=size)
    got = texture.build_atlas(imgs, size=size)
    np.testing.assert_array_equal(got.images.numpy(), want.images)
    np.testing.assert_array_equal(got.sizes.numpy(), want.sizes)
    assert got.images.dtype == torch.float32 and got.sizes.dtype == torch.int32


def test_build_atlas_of_no_images():
    got, want = texture.build_atlas([]), jtexture.build_atlas([])
    assert tuple(got.images.shape) == want.images.shape
    assert tuple(got.sizes.shape) == want.sizes.shape


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("with_sizes", [False, True])
def test_fetch_bilinear_equals_jax(channels, with_sizes):
    rs = np.random.default_rng(channels + 2 * with_sizes)
    atlas = jtexture.build_atlas(_images(rs, "mixed"))
    n = 4096
    uv = rs.uniform(-3, 3, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [-1, 2], [-1e-9, 0.5], [0.5, -1e-9], [3, -3], [0.999999, 0], [2, 2]]
    tex_id = rs.integers(0, atlas.images.shape[0], n).astype(np.int32)
    jat = atlas if with_sizes else atlas.images
    want = np.asarray(jtexture.fetch_bilinear(jat, jnp.asarray(tex_id), jnp.asarray(uv),
                                              channels=channels))
    tat = texture.TextureAtlas(torch.from_numpy(atlas.images), torch.from_numpy(atlas.sizes))
    got = texture.fetch_bilinear(tat if with_sizes else tat.images, torch.from_numpy(tex_id),
                                 torch.from_numpy(uv), channels=channels).numpy()
    assert got.shape == want.shape == (n, channels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fetch_bilinear_clamps_ids_as_jnp():
    """Texture ids -1 and NT read the rows jnp's gather reads (the last one,
    and the clamped last one), without an out-of-range read."""
    rs = np.random.default_rng(5)
    atlas = jtexture.build_atlas(_images(rs, "mixed"))
    nt = atlas.images.shape[0]
    tex_id = np.array([-1, nt, 0, nt - 1] * 16, np.int32)
    uv = rs.uniform(-1, 1, (64, 2)).astype(np.float32)
    want = np.asarray(jtexture.fetch_bilinear(atlas, jnp.asarray(tex_id), jnp.asarray(uv)))
    tat = texture.TextureAtlas(torch.from_numpy(atlas.images), torch.from_numpy(atlas.sizes))
    got = texture.fetch_bilinear(tat, torch.from_numpy(tex_id), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_scene_from_numpy_reads_a_textured_jax_scene():
    """The atlas fault of the port's `scene_from_numpy`: JAX's textured
    terrain carries a `TextureAtlas(images, sizes)` and `tex_slots`."""
    js, _ = jbuiltins.tri_terrain(resolution=(8, 8), n_tris=2000)
    ts = types.scene_from_numpy(js, device="cpu")
    assert isinstance(ts.textures, texture.TextureAtlas)
    np.testing.assert_array_equal(ts.textures.images.numpy(), np.asarray(js.textures.images))
    np.testing.assert_array_equal(ts.textures.sizes.numpy(), np.asarray(js.textures.sizes))
    assert ts.tex_slots == js.tex_slots == ("diffuse",)
    np.testing.assert_array_equal(ts.materials.diffuse_tex.numpy(),
                                  np.asarray(js.materials.diffuse_tex))


def test_scene_from_numpy_reads_a_bare_atlas_array():
    js, _ = jbuiltins.tri_terrain(resolution=(8, 8), n_tris=2000)
    js = js.replace(textures=jnp.asarray(js.textures.images[..., :3]))
    ts = types.scene_from_numpy(js, device="cpu")
    assert ts.textures.sizes is None and tuple(ts.textures.images.shape) == (1, 256, 256, 3)


def test_tri_terrain_equals_jax():
    """The port's terrain is JAX's, field by field, atlas, slots and camera too."""
    from ba_pathtracing_fur_torch.core import camera as cam_mod
    from test_torch_scene import _assert_scene_equal

    js, jc = jbuiltins.tri_terrain(resolution=(12, 10), n_tris=2000, seed=3)
    ts, tc = builtins.tri_terrain(resolution=(12, 10), n_tris=2000, seed=3, device="cpu")
    ref = types.scene_from_numpy(js, device="cpu")
    for a, b in ((ts.textures.images, ref.textures.images),
                 (ts.textures.sizes, ref.textures.sizes)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ts.tex_slots == ref.tex_slots == ("diffuse",)
    _assert_scene_equal(dataclasses.replace(ts, textures=None),
                        dataclasses.replace(ref, textures=None))
    rc = cam_mod.camera_from_numpy(jc, device="cpu")
    for f in ("position", "axis_x", "axis_y", "axis_z", "bottom_left"):
        assert torch.equal(getattr(tc, f), getattr(rc, f)), f
    assert (tc.pixel_size, tc.resolution) == (rc.pixel_size, rc.resolution)


def test_to_device_moves_the_atlas():
    ts, _ = builtins.tri_terrain(resolution=(4, 4), n_tris=200, device="cpu")
    moved = types.to_device(ts, "meta")
    assert moved.textures.images.device.type == moved.textures.sizes.device.type == "meta"
