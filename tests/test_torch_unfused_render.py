"""The port's unfused `render_image` (fused_shading=False, compact=False)
against the JAX package's unfused `render_image` on the CPU, under the
image gate of tests/test_fused_shade.py::_compare (mean |diff| < 5e-3, at
most 2% of pixels with a channel off by more than 1e-3):

* the textured terrain (bench config 3's scene at 2,000 triangles, 24x24,
  spp 2, depth 4) on a SAH BVH, `ray_chunk=2048` as config 3 sets it;
* the glossy Cornell box with MIS and Russian roulette;
* the fur patch with the random walk choice (`hair_p_random`).

Both packages draw the same threefry streams, so the images agree pixel by
pixel up to isolated float-boundary decisions. Each JAX render is made
once a module (module-scoped fixtures).
"""

import jax
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.models import pathtracer as jpt
from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, traverse as ctraverse
from ba_pathtracing_fur_torch.scene.types import scene_from_numpy
from test_torch_fur import _compare_images

torch.set_num_threads(2)

CPU = "cpu"
TERRAIN = dict(depth=4, spp=2, compact=False)
CORNELL = dict(depth=4, spp=2, compact=False, mis=True, rr=True)
FUR = dict(depth=3, spp=2, compact=False, hair_p_random=True)


def _jax_render(js, jc, kw, ray_chunk):
    return np.asarray(jpt.render_image(js, jc, jax.random.key(0),
                                       jpt.RenderConfig(**kw, ray_chunk=ray_chunk)))


def _port_render(js, jc, kw):
    return pt.render_image(scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU),
                           rng.key(0, CPU), pt.RenderConfig(**kw)).numpy()


@pytest.fixture(scope="module")
def terrain():
    js, jc = jbuiltins.tri_terrain(resolution=(24, 24), n_tris=2000)
    js = jtraverse.attach_bvh(js, method="sah", min_prims=1)
    return js, jc, _jax_render(js, jc, TERRAIN, 2048)


@pytest.fixture(scope="module")
def cornell():
    js, jc = jbuiltins.cornell_box(resolution=(24, 24), variant="glossy")
    return js, jc, _jax_render(js, jc, CORNELL, 256)


@pytest.fixture(scope="module")
def fur_patch():
    js, jc = jbuiltins.fur_patch(resolution=(16, 16), fibers_per_face=8, fiber_verts=6)
    return js, jc, _jax_render(js, jc, FUR, 256)


def test_terrain_sah_render_matches_jax(terrain):
    """Config 3's path: K2's twin on the triangle leaves (closest hit and
    the NEE any-hit, once each a bounce), the textured gather, no shade
    stage."""
    js, jc, a = terrain
    trav, shade, full = ctraverse.REF_CALLS, cshade.SHADE_REF_CALLS, cshade.REF_CALLS
    b = _port_render(js, jc, TERRAIN)
    assert ctraverse.REF_CALLS - trav == 2 * TERRAIN["spp"] * TERRAIN["depth"]
    assert (cshade.SHADE_REF_CALLS, cshade.REF_CALLS) == (shade, full)
    _compare_images(a, b)


def test_terrain_texture_shows(terrain):
    """The diffuse texture reaches the image: the port's render without the
    atlas differs from the textured one on the lit checker squares."""
    import dataclasses

    js, jc, a = terrain
    ts = scene_from_numpy(js, device=CPU)
    plain = pt.render_image(dataclasses.replace(ts, textures=None),
                            camera_from_numpy(jc, device=CPU), rng.key(0, CPU),
                            pt.RenderConfig(**TERRAIN)).numpy()
    assert np.mean(np.abs(plain - a).max(-1) > 1e-2) > 0.05


def test_cornell_glossy_mis_rr_render_matches_jax(cornell):
    js, jc, a = cornell
    _compare_images(a, _port_render(js, jc, CORNELL))


def test_fur_patch_random_walk_render_matches_jax(fur_patch):
    js, jc, a = fur_patch
    _compare_images(a, _port_render(js, jc, FUR))
