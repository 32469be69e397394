"""The port's Whitted raytracer (`models/whitted.py`) and its helpers against
the JAX package's on the CPU.

* `vecmath.rotate_about_axis` / `angle_between`, `sampling.
  poisson_disk_pattern` (equal) and `fur.marschner_closed_form` on seeded
  random hits (`test_torch_unfused._close_most`: the hair Gaussians fed
  degree-valued angles amplify an ulp of torch's and XLA's
  transcendentals);
* `light_shading` on Cornell and fur-patch hits, hard and soft, with the
  soft-shadow draws bit for bit; and the `n_alive` gate case of
  tests/test_whitted.py (live shadow rays sorted past the live prefix);
* `render_whitted` on Cornell at depth 2, the mirror-walled glossy Cornell
  at depth 8 (the DFS runs several iterations), supersamples 2 on the grid
  and the Poisson pattern, adaptive refinement, depth of field, the fur
  patch with hair_lobes "r" and "all" (TT and TRT traced from inside the
  fiber), and a small hair ball on a two-level cone BVH (K3's twin, and
  K5's twin on the scalp) -- all under the image gate of
  tests/test_fused_shade.py::_compare;
* `record_hair_paths`;
* the far-ray skip of `traverse.any_hit` (tests/test_torch_far_rays.py
  holds its proof): on the tiny hair ball's Whitted shadow rays (misses'
  rays from o + 3.4e38 d, rays the scalp blocks) and its progressive NEE
  rays (some blocked by cones), on one- and two-level BVHs, `any_hit`
  equals the cone walk on the unmodified t_max or'ed with the scalp's
  answer, and `render_whitted` equals its render with the pack fact false.

JAX's renders come from two child processes with XLA's ISA capped below FMA
(XLA compiles the while loop's body and contracts a*b + c on the CPU, which
moves thin cones' roots; see tests/test_torch_hairball.py).
"""

import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu import native as jnative
from ba_pathtracing_fur_tpu.core import camera as jcam, sampling as jsampling, \
    vecmath as jvm
from ba_pathtracing_fur_tpu.models import bsdf as jbsdf, fur as jfur, whitted as jwhitted
from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch.core import camera as cam_mod, rng, sampling, vecmath as vm
from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
from ba_pathtracing_fur_torch.models import bsdf, fur, whitted
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, stream as cstream
from ba_pathtracing_fur_torch.scene.types import scene_from_numpy
from test_torch_far_rays import BALL, BIG, _shadow_traffic, _walked
from test_torch_fur import _compare_images
from test_torch_unfused import _close_most, _mats, _unit

torch.set_num_threads(2)

CPU = "cpu"
_NO_FMA = "--xla_cpu_max_isa=SSE4_2"
_HERE = os.path.dirname(os.path.abspath(__file__))
#: render cases: (scene, WhittedConfig fields)
CASES = {
    "cornell_d2": ("cornell", dict(depth=2)),
    "glossy_d8": ("mirror", dict(depth=8)),
    "ss2_grid": ("cornell", dict(depth=1, supersamples=2)),
    "ss2_poisson": ("cornell", dict(depth=1, supersamples=2, aa="poisson")),
    "adaptive": ("cornell", dict(depth=1, adaptive=True, adaptive_depth=1,
                                 adaptive_threshold=0.1)),
    "dof": ("cornell_dof", dict(depth=1, dof=True, dof_samples=2)),
    "fur_r": ("fur", dict(depth=2, hair_lobes="r")),
    "fur_all": ("fur", dict(depth=2, hair_lobes="all")),
    "hair_ball_all": ("hair_ball", dict(depth=2, hair_lobes="all")),
}


def _jax_scene(name):
    """The JAX package's scene and camera of a case (numpy BVH build)."""
    if name == "fur":
        return jbuiltins.fur_patch(resolution=(24, 24), fibers_per_face=6, fiber_verts=5,
                                   fiber_radius=0.02)
    if name == "hair_ball":
        jnative.median_split = jnative.ranges_to_perm = lambda *a, **k: None
        js, jc = jbuiltins.hair_ball(resolution=(16, 16), n_fibers=600)
        return jtraverse.attach_bvh(js, method="median", leaf_size=16, fanout=8), jc
    if name == "mirror":
        js, jc = jbuiltins.cornell_box(resolution=(24, 24), variant="glossy")
        # every surface reflective, so the recursion reaches depth 8
        return js.replace(materials=js.materials.replace(
            reflectivity=jnp.full_like(js.materials.reflectivity, 0.8))), jc
    js, jc = jbuiltins.cornell_box(resolution=(16, 16))
    if name == "cornell_dof":
        jc = jc.replace(use_dof=True, aperture=jnp.float32(0.2),
                        focus_distance=jnp.float32(2.0))
    return js, jc


def _port_scene(name):
    js, jc = _jax_scene(name)
    return scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU)


def _jax_child(out, names):
    """JAX's renders of `names` (and record_hair_paths) into the npz `out`."""
    jax.config.update("jax_platforms", "cpu")
    got = {}
    for name in names:
        if name == "record":
            js, jc = _jax_scene("fur")
            o, d = _jax_camera_rays(jc)
            rec = jwhitted.record_hair_paths(js, o, d)
            got.update({f"record/{k}": np.asarray(v) for k, v in rec._asdict().items()})
            continue
        scene, kw = CASES[name]
        js, jc = _jax_scene(scene)
        got[name] = np.asarray(jwhitted.render_whitted(js, jc, jwhitted.WhittedConfig(**kw)))
    np.savez(out, **got)


def _jax_camera_rays(jc):
    px, py = jcam.pixel_grid(jc.resolution)
    return jcam.rays_from_pixels(jc, px, py, jnp.full((px.shape[0], 2), 0.5))


@pytest.fixture(scope="module")
def jax_renders():
    """CASES rendered by the JAX package in two child processes at once (XLA
    reads its flags once a process), with the ISA capped below FMA."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {_NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join([os.path.dirname(_HERE), _HERE]))
    names = list(CASES) + ["record"]
    halves = (names[0::2], names[1::2])
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"whitted{i}.npz") for i in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), out, *half],
                                  env=env) for out, half in zip(outs, halves)]
        for p in procs:
            assert p.wait(timeout=600) == 0
        for out in outs:
            with np.load(out) as z:
                got.update(z)
    return got


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def test_rotate_about_axis_and_angle_between_match_jax():
    rs = np.random.default_rng(0)
    v, axis = rs.normal(size=(2, 4096, 3)).astype(np.float32)
    angle = rs.uniform(-7, 7, 4096).astype(np.float32)
    got = vm.rotate_about_axis(torch.from_numpy(v), torch.from_numpy(axis),
                               torch.from_numpy(angle))
    want = jvm.rotate_about_axis(jnp.asarray(v), jnp.asarray(axis), jnp.asarray(angle))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # a float angle, as the Whitted shader passes none but callers may
    got = vm.rotate_about_axis(torch.from_numpy(v), torch.from_numpy(axis), 0.7)
    want = jvm.rotate_about_axis(jnp.asarray(v), jnp.asarray(axis), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got = vm.angle_between(torch.from_numpy(v), torch.from_numpy(axis))
    want = jvm.angle_between(jnp.asarray(v), jnp.asarray(axis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,seed", [(4, 0), (9, 0), (16, 3), (25, 7)])
def test_poisson_disk_pattern_equal(n, seed):
    got = sampling.poisson_disk_pattern(n, seed)
    np.testing.assert_array_equal(got, jsampling.poisson_disk_pattern(n, seed))
    assert got.shape == (n, 2) and got.dtype == np.float32


def test_marschner_closed_form_matches_jax():
    rs = np.random.default_rng(4)
    n = 4096
    jm, tm = _mats(rs, n, 9)
    vecs = [_unit(rs, n) for _ in range(5)]
    want = jfur.marschner_closed_form(jm, *map(jnp.asarray, vecs))
    got = fur.marschner_closed_form(tm, *map(torch.from_numpy, vecs))
    for f in want._fields:
        w, g = np.asarray(getattr(want, f), np.float64), getattr(got, f).numpy()
        assert np.isfinite(g).all(), f
        d = np.abs(g - w)
        # `_close_most`, except on rays whose TT exit grazes the fiber: there
        # 1/sqrt(1 - h^2) takes h within 1e-4 of 1 (1 - h^2 = 6.4e-5 on
        # ray 4090), which turns an ulp of h into 2e-3 of the lobe
        grazing = (d > 1e-5 + 1e-3 * np.abs(w)).reshape(n, -1).any(-1)
        assert grazing.mean() <= 5e-4, f"{f}: {grazing.sum()} rays past 1e-3"
        assert (d <= 1e-5 + 1e-2 * np.abs(w)).all(), f
        assert (d > 1e-5 + 1e-5 * np.abs(w)).mean() <= 0.005, f
    assert (np.abs(np.asarray(want.scat_tt)) > 0).mean() > 0.5
    # the tangent alone
    n0 = _unit(rs, n)
    np.testing.assert_allclose(fur.hair_tangent(torch.from_numpy(n0)).numpy(),
                               np.asarray(jfur.hair_tangent(jnp.asarray(n0))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# light_shading
# ---------------------------------------------------------------------------

def _camera_hits(name):
    """(JAX scene, port scene, the camera rays' JAX hit, its material
    parameters in both packages, the view direction)."""
    js, jc = _jax_scene(name)
    ts = scene_from_numpy(js, device=CPU)
    o, d = _jax_camera_rays(jc)
    hit = jtraverse.closest_hit(o, d, js, t_max=jnp.full((o.shape[0],), 1e30))
    jmp = jbsdf.gather_materials(js.materials, hit.mat_id, hit.uv, js.textures, js.tex_slots)
    tmp = bsdf.gather_materials(ts.materials, torch.from_numpy(np.asarray(hit.mat_id)))
    return js, ts, hit, jmp, tmp, jvm.normalize(d)


@pytest.mark.parametrize("name", ["cornell", "fur"])
@pytest.mark.parametrize("soft", [False, True])
def test_light_shading_matches_jax(name, soft):
    js, ts, hit, jmp, tmp, view = _camera_hits(name)
    cfg = jwhitted.WhittedConfig(soft_shadows=soft, shadow_samples=3)
    active = np.asarray(hit.valid)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 5) if soft else None
    want = jwhitted.light_shading(js, hit.position, hit.normal, hit.uv, view, jmp,
                                  jmp.diffuse, cfg, key=jkey, active=jnp.asarray(active))
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    tkey = rng.fold_in(rng.key(0, CPU), 5) if soft else None
    got = whitted.light_shading(ts, t(hit.position), t(hit.normal), t(hit.uv), t(view), tmp,
                                tmp.diffuse, whitted.WhittedConfig(**cfg._asdict()), key=tkey,
                                active=t(active))
    _close_most(got.numpy(), np.asarray(want), f"{name} soft={soft}")
    assert np.asarray(want)[active].max() > 0.01


def test_soft_shadow_draws_bit_equal():
    """render_whitted's soft-shadow uniforms: fold_in(key, sample), then
    fold_in(iteration), fold_in(light), fold_in(shadow sample), then a
    (R, 3) uniform."""
    jk, tk = jax.random.PRNGKey(0), rng.key(0, CPU)
    for data in (3, 1, 0, 2):
        jk, tk = jax.random.fold_in(jk, data), rng.fold_in(tk, data)
    want = np.asarray(jax.random.uniform(jk, (777, 3)))
    got = rng.uniform(tk, (777, 3)).numpy()
    np.testing.assert_array_equal(got, want)


def test_light_shading_gated_compacted_wavefront_shadows():
    """tests/test_whitted.py's case through the port: live lanes above the
    Cornell ceiling aiming down at the light, dead lanes elsewhere, a BVH
    on every triangle, `n_alive` = the live prefix. Every live shadow ray is
    blocked (ambient-only 0); the ungated call on the live lanes alone
    agrees; unoccluded live lanes light up; and JAX's gated call agrees."""
    js, _ = jbuiltins.cornell_box(resolution=(8, 8))
    js = jtraverse.attach_bvh(js, min_prims=1)
    ts = scene_from_numpy(js, device=CPU)
    r, n_live = 2048, 512
    light = np.array([0.0, 0.98, 0.0], np.float32)

    def case(live_pos):
        pos = np.tile(light + np.array([-1.5, -1.48, -1.5], np.float32), (r, 1))
        pos[:n_live] = light + live_pos
        norm = light[None] - pos
        norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
        return pos, norm

    mp = bsdf.gather_materials(ts.materials, torch.zeros((r,), dtype=torch.int32))
    uv = torch.zeros((r, 2))
    cfg = whitted.WhittedConfig(shadows=True, ray_chunk=256)
    live = torch.arange(r) < n_live
    pos, norm = map(torch.from_numpy, case(np.array([0.3, 1.0, 0.3], np.float32)))
    got = whitted.light_shading(ts, pos, norm, uv, -norm, mp, mp.diffuse, cfg,
                                n_alive=torch.tensor(n_live), active=live)
    sl = slice(0, n_live)
    mp_live = bsdf.MatParams(**{k: v[sl] for k, v in vars(mp).items()})
    ref = whitted.light_shading(ts, pos[sl], norm[sl], uv[sl], -norm[sl], mp_live,
                                mp.diffuse[sl], cfg)
    torch.testing.assert_close(got[:n_live], ref, rtol=1e-5, atol=1e-6)
    assert got[:n_live].abs().max() < 1e-6
    jmp = jbsdf.gather_materials(js.materials, jnp.zeros((r,), jnp.int32),
                                 jnp.zeros((r, 2)), js.textures, js.tex_slots)
    want = jwhitted.light_shading(js, jnp.asarray(pos.numpy()), jnp.asarray(norm.numpy()),
                                  jnp.zeros((r, 2)), jnp.asarray(-norm.numpy()), jmp,
                                  jmp.diffuse, jwhitted.WhittedConfig(ray_chunk=256),
                                  n_alive=jnp.int32(n_live), active=jnp.arange(r) < n_live)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    pos2, norm2 = map(torch.from_numpy, case(np.array([0.05, -0.3, 0.05], np.float32)))
    lit = whitted.light_shading(ts, pos2, norm2, uv, -norm2, mp, mp.diffuse, cfg,
                                n_alive=torch.tensor(n_live), active=live)
    assert lit[:n_live].max() > 1e-3


def test_entry_morton_sort_of_overflowing_rays_matches_jax():
    """The Whitted shadow rays of a miss start at o + 3.4e38 * d, which
    overflows to inf for an unnormalized camera direction, and aim back at
    the light: their entry point into the BVH's box is NaN (inf * 0), which
    XLA's float-to-uint32 conversion turns into morton cell 0. The port's
    sort key does the same (the CPU's conversion gives INT64_MIN, an index
    out of the table's range). No value here is subnormal: XLA flushes
    those to 0 on the CPU, torch does not."""
    js, _ = _jax_scene("hair_ball")
    bvh = scene_from_numpy(js, device=CPU).cone_bvh
    rs = np.random.default_rng(2)
    n = 1024
    o = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    o[::3] = np.copysign(np.inf, _unit(rs, n)[::3])
    d = (np.array([0.0, 2.0, 1.0], np.float32) - o).astype(np.float32)
    d[1::3] = _unit(rs, n)[1::3]
    t_max = np.where(rs.uniform(size=n) < 0.8, 1.0, 0.0).astype(np.float32)
    want = jtraverse._entry_morton_perms(*map(jnp.asarray, (o, d, t_max)), js.cone_bvh)
    got = traverse._entry_morton_perms(*map(torch.from_numpy, (o, d, t_max)), bvh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_render_whitted_matches_jax(jax_renders, case, monkeypatch):
    scene_name, kw = CASES[case]
    ts, tc = _port_scene(scene_name)
    if scene_name == "hair_ball":
        # K5's twin on the 768-triangle scalp (256 x 768 pairs)
        monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 16)
    k3, k5 = cstream.REF_CALLS, cisect.REF_CALLS
    img = whitted.render_whitted(ts, tc, whitted.WhittedConfig(**kw))
    iters = [len(x) for x in whitted.LAST_QUEUE_LIVE]
    _compare_images(jax_renders[case], img.numpy())
    if scene_name == "hair_ball":
        # closest hits a node + TT + TRT, and each light's shadow rays
        assert cstream.REF_CALLS - k3 >= 3 * sum(iters)
        assert cisect.REF_CALLS - k5 >= 3 * sum(iters)
    if case == "glossy_d8":
        assert max(iters) > 2, whitted.LAST_QUEUE_LIVE
    if case == "adaptive":
        assert len(iters) > 4  # the four corners and at least one refinement level


def test_whitted_depth8_tree_is_walked_in_dfs_order():
    """The glossy mirror room at depth 8: the queue's live lanes fall
    iteration by iteration, and the render equals the sum of the same walk
    split into two halves of the image (per-ray independence)."""
    ts, tc = _port_scene("mirror")
    cfg = whitted.WhittedConfig(depth=8)
    img = whitted.render_whitted(ts, tc, cfg)
    (log,) = whitted.LAST_QUEUE_LIVE
    assert log[0] == 24 * 24 and len(log) > 2 and all(x > 0 for x in log)
    px, py = cam_mod.pixel_grid(tc.resolution)
    o, d = cam_mod.rays_from_pixels(tc, px, py, torch.full((px.shape[0], 2), 0.5))
    halves = [whitted._trace_queue(ts, o[s], d[s], cfg) for s in (slice(0, 300),
                                                                  slice(300, None))]
    assert torch.equal(torch.cat(halves).reshape(24, 24, 3), img)


def test_record_hair_paths_matches_jax(jax_renders):
    ts, tc = _port_scene("fur")
    px, py = cam_mod.pixel_grid(tc.resolution)
    o, d = cam_mod.rays_from_pixels(tc, px, py, torch.full((px.shape[0], 2), 0.5))
    rec = whitted.record_hair_paths(ts, o, d)
    valid = jax_renders["record/valid"]
    assert np.array_equal(rec.valid.numpy(), valid) and valid.any()
    for f in rec._fields:
        if f == "valid":
            continue
        g, w = getattr(rec, f).numpy()[valid], jax_renders[f"record/{f}"][valid]
        assert np.isfinite(g).all(), f
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3, err_msg=f)


# ---------------------------------------------------------------------------
# Far shadow rays (traverse.any_hit's skip)
# ---------------------------------------------------------------------------

#: the tiny ball's BVH layouts: attach_bvh's keywords (K2's twin, K3's)
FAR_LAYOUTS = {"one_level": dict(method="median"),
               "two_level": dict(method="median", leaf_size=16, fanout=8)}


def _far_ball(layout):
    from ba_pathtracing_fur_torch.scene import builtins

    scene, cam = builtins.hair_ball(**BALL, device=CPU)
    scene = traverse.attach_bvh(scene, **FAR_LAYOUTS[layout])
    assert traverse._two_level(scene.cone_bvh) == (layout == "two_level")
    return scene, cam


@pytest.mark.parametrize("layout", sorted(FAR_LAYOUTS))
@pytest.mark.parametrize("traffic", ["whitted_shadow", "nee"])
def test_any_hit_answers_far_lanes_as_the_walk(traffic, layout, monkeypatch):
    """Each `any_hit` call of a render: its answers bit-equal to the cone
    traversal called on the unmodified t_max, or'ed with the scalp's (K5's
    twin); Whitted's traffic holds far lanes and rays the scalp blocks, the
    NEE traffic rays that cones block."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)  # the scalp on K5's twin
    scene, cam = _far_ball(layout)
    assert scene.cone_bvh.far_inert
    cfg = (whitted.WhittedConfig(depth=8, hair_lobes="all") if traffic == "whitted_shadow"
           else pt.RenderConfig(depth=2, spp=1, fused_shading=True, compact=False))
    calls, _ = _shadow_traffic(scene, cam, cfg, monkeypatch)
    far = by_scalp = by_cones = 0
    for o, d, t_max in calls:
        want, by_cone = _walked(o, d, t_max, scene)
        assert torch.equal(traverse.any_hit(o, d, scene, t_max), want)
        far += int(((d.abs().amax(1) >= BIG) & (t_max > 0)).sum())
        by_scalp += int((want & ~by_cone).sum())
        by_cones += int(by_cone.sum())
    if traffic == "whitted_shadow":
        assert far > 0 and by_scalp > 0
    else:
        assert far == 0 and by_cones > 0


@pytest.mark.parametrize("layout", sorted(FAR_LAYOUTS))
def test_render_whitted_equals_its_render_without_the_pack_fact(layout, monkeypatch):
    """The tiny ball's Whitted render, with far lanes skipped, bit-equal to
    the render of the same scene attached with the pack fact false."""
    from ba_pathtracing_fur_torch.ops import bvh as bvh_mod

    cfg = whitted.WhittedConfig(depth=8, hair_lobes="all")
    skipped, far_dead = [], traverse._far_dead

    def spy(d, t_max):
        skipped.append(int(((d.abs().amax(1) >= BIG) & (t_max > 0)).sum()))
        return far_dead(d, t_max)

    monkeypatch.setattr(traverse, "_far_dead", spy)
    scene, cam = _far_ball(layout)
    img = whitted.render_whitted(scene, cam, cfg)
    assert sum(skipped) > 0
    monkeypatch.setattr(bvh_mod, "far_rays_inert", lambda packed: False)
    off, _ = _far_ball(layout)
    assert scene.cone_bvh.far_inert and not off.cone_bvh.far_inert
    n = len(skipped)
    assert torch.equal(img, whitted.render_whitted(off, cam, cfg)) and len(skipped) == n


if __name__ == "__main__":
    # python tests/test_torch_whitted.py OUT.npz CASE...: save JAX's renders
    _jax_child(sys.argv[1], sys.argv[2:])
