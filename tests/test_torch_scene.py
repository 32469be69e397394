"""The port's Cornell scene, kernel tables and camera rays against the JAX
package: the scene state both packages render must be the same."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.core import camera as jcam
from ba_pathtracing_fur_tpu.ops.pallas import shade as jshade
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.core import camera as cam_mod
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
from ba_pathtracing_fur_torch.scene import builtins, types

torch.set_num_threads(2)

PACKS = (("tris", types.TrianglePack), ("cones", types.ConePack),
         ("materials", types.MaterialTable), ("lights", types.LightPack))


def _assert_scene_equal(a: types.DeviceScene, b: types.DeviceScene):
    for name, cls in PACKS:
        for f in dataclasses.fields(cls):
            x, y = getattr(getattr(a, name), f.name), getattr(getattr(b, name), f.name)
            assert x.dtype == y.dtype, (name, f.name)
            assert torch.equal(x, y), (name, f.name)
    assert a.env.kind == b.env.kind
    assert torch.equal(a.env.color, b.env.color)
    assert torch.equal(a.env.ambient, b.env.ambient)
    assert (a.has_hair, a.bsdfs_present, a.textures) == (b.has_hair, b.bsdfs_present, b.textures)


@pytest.mark.parametrize("variant", ["diffuse", "glossy"])
@pytest.mark.parametrize("light_kind", ["quad", "point"])
def test_cornell_box_equals_jax(variant, light_kind):
    js, jc = jbuiltins.cornell_box(resolution=(24, 16), variant=variant, light_kind=light_kind)
    ts, tc = builtins.cornell_box(resolution=(24, 16), variant=variant, light_kind=light_kind,
                                  device="cpu")
    _assert_scene_equal(ts, types.scene_from_numpy(js, device="cpu"))
    assert cshade.full_fuse_eligible(ts) == jshade.full_fuse_eligible(js)
    ref = cam_mod.camera_from_numpy(jc, device="cpu")
    for f in ("position", "axis_x", "axis_y", "axis_z", "bottom_left"):
        assert torch.equal(getattr(tc, f), getattr(ref, f)), f
    assert (tc.pixel_size, tc.aperture, tc.focus_distance, tc.resolution, tc.use_dof) == \
        (ref.pixel_size, ref.aperture, ref.focus_distance, ref.resolution, ref.use_dof)


@pytest.mark.parametrize("variant", ["diffuse", "glossy"])
def test_tables_equal_jax_packs(variant):
    js, _ = jbuiltins.cornell_box(resolution=(8, 8), variant=variant)
    ts, _ = builtins.cornell_box(resolution=(8, 8), variant=variant, device="cpu")
    pairs = ((cshade.pack_tris_table(ts.tris), jshade.pack_tris_smem(js.tris)),
             (cshade.pack_mats_table(ts.materials), jshade.pack_mats_smem(js.materials)),
             (cshade.pack_lights_table(ts.lights), jshade.pack_lights_smem(js.lights)))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_dof", [False, True])
def test_rays_from_pixels_match(use_dof):
    kw = dict(position=(0.1, 0.2, 3.0), look_at=(0.05, -0.1, -1.0), up=(0.0, 1.0, 0.0),
              resolution=(40, 30), use_dof=use_dof)
    jc = jcam.make_camera(**kw)
    tc = cam_mod.make_camera(**kw, device="cpu")
    rs = np.random.default_rng(1)
    px = rs.integers(0, 40, 500).astype(np.float32)
    py = rs.integers(0, 30, 500).astype(np.float32)
    jitter = rs.random((500, 2), dtype=np.float32)
    dof = rs.random((500, 2), dtype=np.float32)
    jo, jd = jcam.rays_from_pixels(jc, jnp.asarray(px), jnp.asarray(py), jnp.asarray(jitter),
                                   jnp.asarray(dof))
    to, td = cam_mod.rays_from_pixels(tc, torch.from_numpy(px), torch.from_numpy(py),
                                      torch.from_numpy(jitter), torch.from_numpy(dof))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)


def test_pixel_grid_matches():
    jx, jy = jcam.pixel_grid((7, 5))
    tx, ty = cam_mod.pixel_grid((7, 5))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("method", ["grid", "morton"])
def test_scene_with_bvh_is_refused(method):
    """Scenes with a median or SAH BVH render (test_torch_traverse.py,
    test_torch_sah.py); the BVH builds that are not ported yet are refused,
    naming their ROADMAP item."""
    from ba_pathtracing_fur_torch.ops import traverse

    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        traverse.attach_bvh(ts, method=method, min_prims=1)


def test_sah_bvh_attaches_as_jax():
    """The SAH build, refused until it was ported, attaches on the fur
    patch's cones and triangles as the JAX package's does: the same perm,
    boxes and packed leaves per pack; an unknown method is an error."""
    from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
    from ba_pathtracing_fur_torch.ops import traverse

    js, _ = jbuiltins.fur_patch(resolution=(4, 4), fibers_per_face=4)
    jb = jtraverse.attach_bvh(js, method="sah", min_prims=1, fanout=0)
    ts = traverse.attach_bvh(types.scene_from_numpy(js, device="cpu"), method="sah",
                             min_prims=1, fanout=0)
    for kind in ("tri_bvh", "cone_bvh"):
        a, b = getattr(ts, kind), getattr(jb, kind)
        for f in ("perm", "bmin", "bmax", "packed"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                          err_msg=f"{kind} {f}")
    with pytest.raises(ValueError, match="unknown BVH method"):
        traverse.attach_bvh(ts, method="octree", min_prims=1)


@pytest.mark.parametrize("change,item", [(dict(compact=True), "M6"), (dict(bdpt=True), "M11")])
def test_ineligible_scene_is_refused(change, item):
    """Fur scenes render through the general bounce now; the render modes
    it does not run yet are refused on them, naming their ROADMAP item."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    ts, tc = builtins.fur_patch(resolution=(4, 4), fibers_per_face=4, device="cpu")
    cfg = pt.RenderConfig(**{**dict(depth=1, spp=1, compact=False, fused_shading=True),
                             **change})
    with pytest.raises(NotImplementedError, match=item):
        pt.render_image(ts, tc, rng.key(0, "cpu"), cfg)


def test_textured_scene_is_refused():
    """The fused path refuses a textured scene, naming K1's texture fetch
    (the shade kernel reads material rows itself and fetches no texture);
    the unfused path renders it."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.scene.texture import TextureAtlas

    ts, tc = builtins.fur_patch(resolution=(4, 4), fibers_per_face=4, device="cpu")
    ts = dataclasses.replace(ts, textures=TextureAtlas(torch.zeros((1, 2, 2, 4)),
                                                       torch.tensor([[2, 2]], dtype=torch.int32)),
                             tex_slots=("diffuse",))
    cfg = pt.RenderConfig(depth=1, spp=1, compact=False, fused_shading=True)
    with pytest.raises(NotImplementedError, match="K1's texture fetch"):
        pt.render_image(ts, tc, rng.key(0, "cpu"), cfg)
    img = pt.render_image(ts, tc, rng.key(0, "cpu"), dataclasses.replace(cfg, fused_shading=False))
    assert torch.isfinite(img).all()


def test_entry_points_default_to_the_card():
    """Entry points put their tensors on CUDA unless the caller asks for
    another device: without a card they raise torch's error instead of
    returning CPU tensors."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.core.camera import make_camera

    for fn in (lambda: builtins.cornell_box(resolution=(4, 4)),
               lambda: builtins.tri_terrain(resolution=(4, 4), n_tris=200),
               lambda: builtins.fur_patch(resolution=(4, 4), fibers_per_face=2),
               lambda: types.scene_from_numpy(jbuiltins.cornell_box(resolution=(4, 4))[0]),
               lambda: cam_mod.camera_from_numpy(jbuiltins.cornell_box(resolution=(4, 4))[1]),
               lambda: make_camera(), lambda: rng.key(0)):
        if torch.cuda.is_available():
            assert fn() is not None
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
                fn()
    # on the meta device (no data) the default is visible without a card
    import inspect
    for fn in (builtins.cornell_box, builtins.tri_terrain, builtins.fur_patch,
               types.scene_from_numpy,
               cam_mod.camera_from_numpy, make_camera, rng.key):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
