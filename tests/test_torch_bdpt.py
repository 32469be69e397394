"""The port's bidirectional path tracing (`models/bdpt.py` and its wiring in
`models/pathtracer.py`) against the JAX package's on the CPU.

* `build_light_subpaths` field by field on the Cornell box with each light
  kind (the photon emission per kind, the walk, the subpath keys
  fold_in(key, p) bit for bit);
* `connect_eye_vertex` and `splat_image_plane` on JAX's own buffer
  (`subpaths_from_numpy`), and on a stacked buffer of two samples;
* `render_image(bdpt=True)` on Cornell 24x24 and a small fur patch, with
  compaction on and off, `spp_batch=2` and `fused_shading=True` (which
  renders through the unfused bounce, as in the JAX package), under the
  image gate of tests/test_torch_pathtracer.py::_compare;
* one `diff.render_loss` backward with `bdpt=True`: finite, and equal to
  `jax.grad` wherever JAX's gradient is finite.

JAX's renders and gradients come from child processes with XLA's ISA
capped below FMA (see tests/test_torch_hairball.py and
tests/test_torch_diff.py). Tolerances: 1e-5 on the subpath fields and the
connection terms, the image gate on renders, and on gradients 1e-3 of the
value plus 1e-3 of the field's max |g| (tests/test_torch_diff.py's).
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

from ba_pathtracing_fur_tpu.core import camera as jcam, rng as jrng
from ba_pathtracing_fur_tpu.models import bdpt as jbdpt, bsdf as jbsdf
from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins
from ba_pathtracing_fur_torch import diff
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
from ba_pathtracing_fur_torch.models import bdpt, bsdf, pathtracer as pt
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.scene.types import scene_from_numpy
from test_torch_pathtracer import _compare

torch.set_num_threads(2)

CPU = "cpu"
_NO_FMA = "--xla_cpu_max_isa=SSE4_2"
_HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=1e-5, atol=1e-5)
#: render cases: (scene, RenderConfig fields); JAX renders the `jax` ones
RENDER = dict(depth=3, spp=2, bdpt=True, bdpt_samples_per_light=4)
JAX_RENDERS = {"cornell": ("cornell", RENDER), "cornell_batch": ("cornell",
                                                                 dict(RENDER, spp_batch=2)),
               "fur": ("fur", RENDER)}
#: the port's cases, each against the JAX render of the same estimator
#: (compaction is exact, and bdpt forces the unfused bounce)
PORT_RENDERS = {"cornell_compact": ("cornell", {}), "cornell_no_compact": ("cornell",
                                                                           dict(compact=False)),
                "cornell_fused": ("cornell", dict(fused_shading=True)),
                "cornell_batch": ("cornell_batch", {}),
                "fur_compact": ("fur", {}), "fur_no_compact": ("fur", dict(compact=False))}
GRAD_CFG = dict(depth=2, spp=1, bdpt=True, bdpt_samples_per_light=2, bdpt_bounces=2)


def _jax_scene(name, res=(24, 24)):
    if name == "fur":
        return jbuiltins.fur_patch(resolution=res, fibers_per_face=6, fiber_verts=5,
                                   fiber_radius=0.02)
    if name.startswith("cornell_"):
        return jbuiltins.cornell_box(resolution=res, light_kind=name.split("_")[1])
    return jbuiltins.cornell_box(resolution=res)


def _jax_child(out):
    """JAX's renders of JAX_RENDERS, or (`out` ending in grads.npz) the
    gradients of GRAD_CFG's loss, into the npz `out`."""
    from ba_pathtracing_fur_tpu import diff as jdiff
    from ba_pathtracing_fur_tpu.models import pathtracer as jpt

    jax.config.update("jax_platforms", "cpu")
    got = {}
    if out.endswith("grads.npz"):
        js, jc = _jax_scene("cornell", (12, 12))
        params = jdiff.make_params(js, lights=True)
        grads = jax.grad(jdiff.render_loss)(params, js, jc, jax.random.key(7),
                                            jnp.zeros((12, 12, 3)),
                                            jpt.RenderConfig(**GRAD_CFG))
        got.update({f"{g}.{k}": np.asarray(v) for g, sub in grads.items()
                    for k, v in sub.items()})
    else:
        for name, (scene, kw) in JAX_RENDERS.items():
            js, jc = _jax_scene(scene)
            got[name] = np.asarray(jpt.render_image(js, jc, jax.random.key(4),
                                                    jpt.RenderConfig(**kw)))
    np.savez(out, **got)


@pytest.fixture(scope="module")
def jax_results():
    """JAX's renders and gradients, from two child processes at once (XLA
    reads its flags once a process), with the ISA capped below FMA."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {_NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join([os.path.dirname(_HERE), _HERE]))
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f) for f in ("renders.npz", "grads.npz")]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), out], env=env)
                 for out in outs]
        for p in procs:
            assert p.wait(timeout=600) == 0
        for out in outs:
            with np.load(out) as z:
                got.update(z)
    return got


# ---------------------------------------------------------------------------
# The light-subpath buffer
# ---------------------------------------------------------------------------

def _assert_subpaths_equal(got, want):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if g.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, err_msg=f, **TOL)


@pytest.mark.parametrize("kind", ["quad", "point", "spot", "sun"])
def test_build_light_subpaths_matches_jax(kind):
    js, _ = _jax_scene(f"cornell_{kind}")
    want = jbdpt.build_light_subpaths(js, jax.random.key(5), samples_per_light=16,
                                      n_bounces=4)
    got = bdpt.build_light_subpaths(scene_from_numpy(js, device=CPU), rng.key(5, CPU), 16, 4)
    _assert_subpaths_equal(got, want)
    v = got.valid.numpy()
    assert v[:, 0].all()
    if kind != "sun":  # a sun's photons start 1e16 away and miss the box
        assert v[:, 1:].any() and not v.all()


def test_subpath_keys_bit_equal():
    """The photon keys fold_in(key, p) and their emission uniforms."""
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(jnp.arange(40))
    tkeys = rng.fold_in(rng.key(9, CPU), torch.arange(40))
    np.testing.assert_array_equal(tkeys.numpy() & 0xFFFFFFFF,
                                  np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    for tag in (10, 11):
        np.testing.assert_array_equal(rng.bounce_uniform(tkeys, -1, 2, tag=tag).numpy(),
                                      np.asarray(jrng.bounce_uniform(jkeys, -1, 2, tag=tag)))


def test_subpaths_from_numpy_and_stacking():
    js, _ = _jax_scene("cornell")
    want = jbdpt.build_light_subpaths(js, jax.random.key(1), samples_per_light=4, n_bounces=3)
    got = bdpt.subpaths_from_numpy(want, device=CPU)
    _assert_subpaths_equal(got, want)
    assert got.valid.dtype == torch.bool and got.light_index.dtype == torch.int32
    st = bdpt.stack_subpaths([got, got])
    assert st.position.shape == (2,) + tuple(got.position.shape)
    assert torch.equal(st.valid[1], got.valid)


# ---------------------------------------------------------------------------
# The connection and the splat on JAX's buffer
# ---------------------------------------------------------------------------

def _eye_hits(name):
    """JAX's camera hits of scene `name` (24x24) and their materials, and the
    port's scene."""
    js, jc = _jax_scene(name)
    px, py = jcam.pixel_grid(jc.resolution)
    o, d = jcam.rays_from_pixels(jc, px, py, jnp.full((px.shape[0], 2), 0.5))
    hit = jtraverse.closest_hit(o, d, js)
    jmp = jbsdf.gather_materials(js.materials, hit.mat_id, hit.uv, js.textures, js.tex_slots)
    tmp = bsdf.gather_materials(scene_from_numpy(js, device=CPU).materials,
                                torch.from_numpy(np.asarray(hit.mat_id)))
    return js, jc, hit, d, jmp, tmp


@pytest.mark.parametrize("name", ["cornell", "fur"])
def test_connect_eye_vertex_on_jax_buffer(name):
    js, _, hit, d, jmp, tmp = _eye_hits(name)
    ts = scene_from_numpy(js, device=CPU)
    sub = jbdpt.build_light_subpaths(js, jax.random.key(2), samples_per_light=8, n_bounces=3)
    u = np.random.default_rng(3).uniform(size=(d.shape[0], 2)).astype(np.float32)
    valid = np.asarray(hit.valid)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    for bounce in (0, 2):
        want = np.asarray(jbdpt.connect_eye_vertex(js, sub, jnp.asarray(u), hit.position,
                                                   hit.normal, d, jmp, bounce))
        got = bdpt.connect_eye_vertex(ts, bdpt.subpaths_from_numpy(sub, CPU), t(u),
                                      t(hit.position), t(hit.normal), t(d), tmp, bounce)
        np.testing.assert_allclose(got.numpy()[valid], want[valid], **TOL)
        assert want[valid].max() > 0.0
        # the port's dead lanes (t_max = 0) change nothing where the term is used
        masked = bdpt.connect_eye_vertex(ts, bdpt.subpaths_from_numpy(sub, CPU), t(u),
                                         t(hit.position), t(hit.normal), t(d), tmp, bounce,
                                         active=t(valid))
        assert torch.equal(masked[t(valid)], got[t(valid)])


def test_connection_reads_each_rays_own_sample():
    """A stacked buffer of two samples: each ray connects to the buffer of
    its own sample, as two separate calls do."""
    js, _, hit, d, _, tmp = _eye_hits("cornell")
    ts = scene_from_numpy(js, device=CPU)
    subs = [bdpt.build_light_subpaths(ts, rng.key(s, CPU), 4, 3) for s in (0, 1)]
    u = torch.from_numpy(np.random.default_rng(4).uniform(size=(d.shape[0], 2))
                         .astype(np.float32))
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    args = (t(hit.position), t(hit.normal), t(d), tmp, 1)
    one = [bdpt.connect_eye_vertex(ts, s, u, *args) for s in subs]
    sample = torch.arange(d.shape[0]) % 2
    both = bdpt.connect_eye_vertex(ts, bdpt.stack_subpaths(subs), u, *args, sample=sample)
    assert torch.equal(both, torch.where((sample == 0)[:, None], one[0], one[1]))
    assert not torch.equal(one[0], one[1])


@pytest.mark.parametrize("name", ["cornell", "fur"])
def test_splat_image_plane_on_jax_buffer(name):
    js, jc = _jax_scene(name)
    ts, tc = scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU)
    sub = jbdpt.build_light_subpaths(js, jax.random.key(6), samples_per_light=8, n_bounces=3)
    ids = jnp.arange(24 * 24)
    jkeys = jrng.keys_for_pixels(jax.random.key(8), ids, 1)
    want = np.asarray(jbdpt.splat_image_plane(js, jc, sub, ids, jkeys))
    got = bdpt.splat_image_plane(ts, tc, bdpt.subpaths_from_numpy(sub, CPU),
                                 torch.arange(24 * 24),
                                 rng.keys_for_pixels(rng.key(8, CPU), torch.arange(24 * 24), 1))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if name == "cornell":  # the fur patch's sun photons miss it: nothing to splat
        assert want.max() > 0.0


# ---------------------------------------------------------------------------
# Renders and a gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(PORT_RENDERS))
def test_render_image_bdpt_matches_jax(jax_results, case):
    jname, kw = PORT_RENDERS[case]
    scene, jkw = JAX_RENDERS[jname]
    js, jc = _jax_scene(scene)
    ts, tc = scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU)
    calls = []
    fn = traverse.any_hit

    def spy(o, d, sc, t_max, *a, **k):
        calls.append(int((t_max > 0).sum()))
        return fn(o, d, sc, t_max, *a, **k)

    traverse.any_hit = spy
    try:
        img = pt.render_image(ts, tc, rng.key(4, CPU), pt.RenderConfig(**{**jkw, **kw}))
    finally:
        traverse.any_hit = fn
    _compare(jax_results[jname], img.numpy())
    # connections (3 a bounce) and the splat's 3 rays, no NEE shadow ray
    spp_calls = jkw["depth"] * 3 + 3
    assert len(calls) == jkw["spp"] * spp_calls // jkw.get("spp_batch", 1)


def test_render_loss_bdpt_gradient_matches_jax(jax_results):
    js, jc = _jax_scene("cornell", (12, 12))
    ts, tc = scene_from_numpy(js, device=CPU), camera_from_numpy(jc, device=CPU)
    params = diff.make_params(ts, lights=True)
    loss = diff.render_loss(params, ts, tc, rng.key(7, CPU), torch.zeros(12, 12, 3),
                            pt.RenderConfig(**GRAD_CFG))
    loss.backward()
    reached = 0
    for g_name, sub in params.items():
        for k, v in sub.items():
            w = jax_results[f"{g_name}.{k}"]
            g = v.grad.numpy() if v.grad is not None else np.zeros_like(w)
            assert np.isfinite(g).all(), k
            ok = np.isfinite(w)
            tol = 1e-3 * np.abs(w[ok]) + 1e-3 * np.abs(w[ok]).max(initial=0.0)
            assert (np.abs(g[ok] - w[ok]) <= tol).all(), \
                f"{g_name}.{k}: {np.abs(g[ok] - w[ok]).max()}"
            reached += np.abs(w[ok]).max(initial=0.0) > 0.0
    assert reached >= 2


if __name__ == "__main__":
    # python tests/test_torch_bdpt.py OUT.npz: save JAX's renders (or, for
    # an OUT ending in grads.npz, its gradients)
    _jax_child(sys.argv[1])
