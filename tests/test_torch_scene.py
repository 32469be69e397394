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
    """The grid and morton builds, refused (naming their ROADMAP item) until
    they were ported, attach on the fur patch's cones and triangles as the
    JAX package's do: the same perm, boxes and packed leaves per pack, and
    the last leaves of the morton and grid trees hold the padding."""
    from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
    from ba_pathtracing_fur_torch.ops import traverse

    js, _ = jbuiltins.fur_patch(resolution=(4, 4), fibers_per_face=4)
    jb = jtraverse.attach_bvh(js, method=method, min_prims=1, fanout=0)
    ts = traverse.attach_bvh(types.scene_from_numpy(js, device="cpu"), method=method,
                             min_prims=1, fanout=0)
    for kind in ("tri_bvh", "cone_bvh"):
        a, b = getattr(ts, kind), getattr(jb, kind)
        for f in ("perm", "bmin", "bmax", "packed"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                          err_msg=f"{kind} {f}")
        n = getattr(js, kind[:-4] + "s").count  # the pack before the reorder
        assert (a.perm[:n] >= 0).all() and (a.perm[n:] == -1).all()


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


@pytest.mark.parametrize("change,item", [(dict(bdpt=True), "M11")])
def test_ineligible_scene_is_refused(change, item):
    """Fur scenes render through the general bounce now. BDPT (ROADMAP M11),
    once refused on them, is ported: with fused_shading=True it renders
    through the unfused bounce, as the JAX package does, so the image is
    the fused_shading=False one bit for bit."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    assert item == "M11"
    ts, tc = builtins.fur_patch(resolution=(4, 4), fibers_per_face=4, device="cpu")
    cfg = pt.RenderConfig(**{**dict(depth=1, spp=1, compact=False, fused_shading=True),
                             **change})
    img = pt.render_image(ts, tc, rng.key(0, "cpu"), cfg)
    unfused = pt.render_image(ts, tc, rng.key(0, "cpu"),
                              dataclasses.replace(cfg, fused_shading=False))
    assert torch.isfinite(img).all() and torch.equal(img, unfused)


def test_textured_scene_is_refused():
    """The fused path, which refused textured scenes until K1 fetched
    textures itself, renders a textured fur patch (the skin's diffuse
    textured) as the JAX package's fused path does (op by op, under the
    image gate), and as the port's unfused path does."""
    import jax

    from ba_pathtracing_fur_tpu.models import pathtracer as jpt
    from ba_pathtracing_fur_tpu.scene.texture import build_atlas as jbuild_atlas
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from test_torch_fur import _compare_images

    js, jc = jbuiltins.fur_patch(resolution=(6, 6), fibers_per_face=4)
    tex = np.random.RandomState(0).rand(3, 5, 3).astype(np.float32)
    js = js.replace(textures=jbuild_atlas([tex]), tex_slots=("diffuse",),
                    materials=js.materials.replace(
                        diffuse_tex=np.asarray([0, -1], np.int32)))
    cfg = dict(depth=2, spp=1, compact=False, fused_shading=True)
    w, h = jc.resolution
    with jax.disable_jit():
        want = np.asarray(jpt.render_sample_ids(js, jc, jax.numpy.arange(w * h),
                                                jax.random.key(0), 0, jpt.RenderConfig(**cfg)))
    ts, tc = types.scene_from_numpy(js, device="cpu"), cam_mod.camera_from_numpy(jc, "cpu")
    refs = cshade.SHADE_REF_CALLS
    img = pt.render_image(ts, tc, rng.key(0, "cpu"), pt.RenderConfig(**cfg))
    assert cshade.SHADE_REF_CALLS - refs == cfg["depth"]
    _compare_images(want.reshape(h, w, 3), img.numpy())
    unfused = pt.render_image(ts, tc, rng.key(0, "cpu"), pt.RenderConfig(
        **dict(cfg, fused_shading=False)))
    _compare_images(unfused.numpy(), img.numpy())


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
