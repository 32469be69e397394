"""The port's render_image against JAX render_image(fused_shading=True), and
the port's own render-loop invariants.

Both packages render the same scene with the same threefry streams, so the
images agree pixel by pixel up to isolated float-boundary decision flips;
the gate is tests/test_fused_shade.py::_compare (mean < 5e-3, <= 2% of
pixels with a channel off by more than 1e-3). The glossy MIS+RR render
lives in test_torch_pathtracer_mis.py, so the two JAX compiles run on two
test workers.
"""

import jax
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.models import pathtracer as jpt
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
from ba_pathtracing_fur_torch.scene import builtins
from ba_pathtracing_fur_torch.scene.types import scene_from_numpy

torch.set_num_threads(2)

KW = dict(depth=3, spp=2, compact=False, fused_shading=True)


def _render_both(variant, **cfg_kw):
    """(JAX image, port image) of the 16x16 Cornell `variant`."""
    js, jc = jbuiltins.cornell_box(resolution=(16, 16), variant=variant)
    a = np.asarray(jpt.render_image(js, jc, jax.random.key(0),
                                    jpt.RenderConfig(**KW, ray_chunk=256, **cfg_kw)))
    launches, refs = cshade.KERNEL_LAUNCHES, cshade.REF_CALLS
    b = pt.render_image(scene_from_numpy(js, device="cpu"), camera_from_numpy(jc, device="cpu"),
                        rng.key(0, "cpu"),
                        pt.RenderConfig(**KW, **cfg_kw))
    # one plain full bounce per bounce of every sample, no kernel on the CPU
    assert cshade.REF_CALLS - refs == KW["spp"] * KW["depth"]
    assert cshade.KERNEL_LAUNCHES == launches
    return a, b.numpy()


def _compare(a, b, atol_mean=5e-3, flip_frac=0.02):
    assert b.shape == a.shape and b.dtype == np.float32
    assert np.all(np.isfinite(b)) and b.max() > 0.01
    d = np.abs(a - b)
    assert np.mean(d) < atol_mean, f"mean {np.mean(d)}"
    assert np.mean(d.max(-1) > 1e-3) <= flip_frac, f"flips {np.mean(d.max(-1) > 1e-3)}"


def test_render_image_cornell_diffuse_matches_jax():
    _compare(*_render_both("diffuse"))


def _small(variant="diffuse", res=(8, 6)):
    return builtins.cornell_box(resolution=res, variant=variant, device="cpu")


def test_sharded_pixels_render_identically():
    scene, cam = _small()
    cfg = pt.RenderConfig(**KW)
    full = pt.render_sample(scene, cam, rng.key(1, "cpu"), 1, cfg)
    ids = torch.tensor([0, 5, 17, 30, 47])
    part = pt.render_sample_ids(scene, cam, ids, rng.key(1, "cpu"), 1, cfg)
    assert torch.equal(part, full[ids])


def test_spp_batch_is_the_same_estimator():
    scene, cam = _small("glossy")
    one = pt.render_image(scene, cam, rng.key(2, "cpu"), pt.RenderConfig(**{**KW, "spp": 4}, mis=True))
    batched = pt.render_image(scene, cam, rng.key(2, "cpu"),
                              pt.RenderConfig(**{**KW, "spp": 4}, mis=True, spp_batch=2))
    torch.testing.assert_close(batched, one, rtol=1e-5, atol=1e-6)


def test_qmc_and_dof_render():
    scene, cam = _small()
    cam.use_dof = True
    img = pt.render_image(scene, cam, rng.key(0, "cpu"), pt.RenderConfig(**KW, qmc=True))
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all() and img.max() > 0.01


@pytest.mark.parametrize("change,item", [
    (dict(bdpt=True), "M11"), (dict(joint_shadows=True), "do-not-port")])
def test_unported_configs_raise(change, item):
    """The configurations that the port once refused, each labelled with
    the ROADMAP entry that listed it, now render: BDPT (M11, through the
    unfused bounce; test_torch_bdpt.py holds it against JAX) and the joint
    closest + shadow pass (once on the do-not-port list; on this scene
    without a two-level BVH the ordinary bounces run, and
    test_torch_joint.py holds the joint pass against JAX)."""
    scene, cam = _small()
    cfg = pt.RenderConfig(**{**KW, **change})
    img = pt.render_image(scene, cam, rng.key(0, "cpu"), cfg)
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all() and img.max() > 0.01
