"""Differentiable rendering in the port (`diff/fit.py` on torch autograd)
against the JAX package's.

* the five cases of tests/test_diff.py through the port (CFG depth 2,
  spp 1, compaction on): a finite-difference check, gradients reaching the
  hair and light parameters, a fit that pulls the red wall back, and a
  scene with BVHs attached;
* the port's gradients against `jax.grad(diff.render_loss)` on the three
  scenes of tests/test_diff.py, field by field, within 1e-3 of the value
  plus 1e-3 of the field's max |g|. JAX's gradients come from its compiled
  render in a child process with XLA's ISA capped below FMA (see
  tests/test_torch_hairball.py: contracted a*b + c moves the grazing roots
  of thin cones, which flips a fur pixel and its gradient);
* one Adam and one SGD update against optax's on identical gradients;
* `remat=True` gives the same gradients bit for bit;
* the fused path raises under autograd and renders under `torch.no_grad`;
* the gradients stay finite with MIS on every light kind and with the hair
  walk's random choice, where the JAX package's are NaN on some entries
  (a sun's 1e16 or a missed light's INF in the light pdf).

The JAX package is imported inside the tests, so that the `cuda`-marked
checks run on the card, which has no jax:
`python -m pytest tests/test_torch_diff.py -m cuda --noconftest -p no:cacheprovider`.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from ba_pathtracing_fur_torch import diff
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.diff.fit import make_optimizer
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
from ba_pathtracing_fur_torch.scene import builtins

torch.set_num_threads(2)

CPU = "cpu"
CFG = pt.RenderConfig(depth=2, spp=1)
FUR = dict(fibers_per_face=6, fiber_verts=4, fiber_radius=0.03)
#: tests/test_diff.py's scenes with their keys and parameter sets
JAX_CASES = {"cornell_lights": (2, dict(materials=True, lights=True)),
             "fur_patch": (1, dict(materials=True)),
             "cornell_bvh": (4, dict(materials=True))}
_NO_FMA = "--xla_cpu_max_isa=SSE4_2"
_HERE = os.path.dirname(os.path.abspath(__file__))


def _scene(name, device=CPU):
    if name == "fur_patch":
        return builtins.fur_patch(resolution=(12, 12), **FUR, device=device)
    scene, cam = builtins.cornell_box(resolution=(12, 12), device=device)
    if name == "cornell_bvh":
        scene = traverse.attach_bvh(scene, min_prims=1)
    return scene, cam


def _grads(params):
    return {f"{g}.{k}": (torch.zeros_like(v) if v.grad is None else v.grad.clone())
            for g, sub in params.items() for k, v in sub.items()}


def _loss_grads(scene, cam, key, cfg, **spec):
    params = diff.make_params(scene, **spec)
    target = torch.zeros(cam.resolution[1], cam.resolution[0], 3, device=scene.device)
    diff.render_loss(params, scene, cam, key, target, cfg).backward()
    return _grads(params)


def test_grad_matches_finite_difference_diffuse():
    scene, camera = builtins.cornell_box(resolution=(12, 12), device=CPU)
    params = diff.make_params(scene)
    analytic, numeric = diff.finite_diff_check(
        params, scene, camera, rng.key(0, CPU), torch.zeros(12, 12, 3), CFG,
        path=("materials", "diffuse"), index=(0, 0), eps=1e-2)
    assert np.isfinite(analytic) and np.isfinite(numeric)
    assert abs(analytic - numeric) < 0.05 * max(abs(numeric), 1e-3)


def test_grad_flows_to_hair_params():
    scene, camera = _scene("fur_patch")
    g = _loss_grads(scene, camera, rng.key(1, CPU), CFG)
    g_alpha, g_beta = g["materials.hair_alpha"], g["materials.hair_beta"]
    assert torch.isfinite(g_alpha).all() and torch.isfinite(g_beta).all()
    assert (g_alpha.abs() + g_beta.abs()).max() > 0.0


def test_grad_flows_to_light_color():
    scene, camera = _scene("cornell")
    g = _loss_grads(scene, camera, rng.key(2, CPU), CFG, lights=True)["lights.color"]
    assert torch.isfinite(g).all() and g.abs().max() > 0.0


def test_fit_recovers_wall_color():
    scene, camera = builtins.cornell_box(resolution=(16, 16), device=CPU)
    key = rng.key(3, CPU)
    with torch.no_grad():
        target = pt.render_image(scene, camera, key, CFG)
    mats = scene.materials
    wrong_diffuse = mats.diffuse.clone()
    wrong_diffuse[1] = torch.tensor([0.2, 0.6, 0.6])
    wrong = dataclasses.replace(scene, materials=dataclasses.replace(mats, diffuse=wrong_diffuse))
    res = diff.fit(wrong, camera, target, CFG, steps=30, lr=5e-2, key=key)
    # stochastic 1-spp gradients: a clear decrease, not convergence
    assert res.losses[-1] < res.losses[0] * 0.7
    # the red wall drifted back toward red
    rec, true = res.params["materials"]["diffuse"][1], mats.diffuse[1]
    assert (rec - true).norm() < (torch.tensor([0.2, 0.6, 0.6]) - true).norm()
    assert torch.equal(res.scene.materials.diffuse, res.params["materials"]["diffuse"])


def test_grad_with_bvh_attached():
    scene, camera = _scene("cornell_bvh")
    g = _loss_grads(scene, camera, rng.key(4, CPU), CFG)["materials.diffuse"]
    assert torch.isfinite(g).all() and g.abs().max() > 0.0


def _jax_grads_child(out):
    """JAX's gradients of JAX_CASES (compiled, as tests/test_diff.py takes
    them) into the npz `out`."""
    import jax
    import jax.numpy as jnp

    from ba_pathtracing_fur_tpu import diff as jdiff
    from ba_pathtracing_fur_tpu.models import pathtracer as jpt
    from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
    from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins

    jax.config.update("jax_platforms", "cpu")
    cfg = jpt.RenderConfig(depth=2, spp=1, ray_chunk=1024)
    got = {}
    for name, (seed, spec) in JAX_CASES.items():
        if name == "fur_patch":
            js, jc = jbuiltins.fur_patch(resolution=(12, 12), **FUR)
        else:
            js, jc = jbuiltins.cornell_box(resolution=(12, 12))
            if name == "cornell_bvh":
                js = jtraverse.attach_bvh(js, min_prims=1)
        params = jdiff.make_params(js, **spec)
        grads = jax.grad(jdiff.render_loss)(params, js, jc, jax.random.key(seed),
                                            jnp.zeros((12, 12, 3)), cfg)
        got.update({f"{name}/{g}.{k}": np.asarray(v)
                    for g, sub in grads.items() for k, v in sub.items()})
    np.savez(out, **got)


@pytest.fixture(scope="module")
def jax_grads():
    """JAX_CASES' gradients from a child process (XLA reads its flags once a
    process) with the ISA capped below FMA."""
    pytest.importorskip("jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {_NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join([os.path.dirname(_HERE), _HERE]))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "grads.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__), out], env=env, check=True,
                       timeout=600)
        with np.load(out) as z:
            return dict(z)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_gradients_match_jax(jax_grads, name):
    seed, spec = JAX_CASES[name]
    scene, cam = _scene("cornell" if name == "cornell_lights" else name)
    got = _loss_grads(scene, cam, rng.key(seed, CPU), CFG, **spec)
    want = {k.split("/")[1]: v for k, v in jax_grads.items() if k.startswith(name + "/")}
    assert set(got) == set(want)
    reached = 0
    for field, w in want.items():
        g = got[field].numpy()
        assert np.isfinite(g).all(), field
        tol = 1e-3 * np.abs(w) + 1e-3 * np.abs(w).max()
        bad = np.abs(g - w) > tol
        assert not bad.any(), f"{name} {field}: {np.abs(g - w).max()} past {tol[bad].min()}"
        reached += np.abs(w).max() > 0.0
    assert reached >= 1


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_update_matches_optax(name):
    """Three updates from identical gradients (tiny entries included: Adam's
    first step is about lr * sign(g))."""
    import jax.numpy as jnp
    import optax

    rs = np.random.default_rng(5)
    p0 = {"materials": {"diffuse": rs.uniform(0.1, 0.9, (4, 3)).astype(np.float32),
                        "ior": rs.uniform(1.1, 1.9, 4).astype(np.float32)}}
    grads = [{"materials": {k: (rs.normal(size=v.shape) * 10.0 ** rs.integers(-9, 1, v.shape))
                            .astype(np.float32) for k, v in p0["materials"].items()}}
             for _ in range(3)]
    opt = {"adam": optax.adam, "sgd": optax.sgd}[name](5e-2)
    jp = {"materials": {k: jnp.asarray(v) for k, v in p0["materials"].items()}}
    state = opt.init(jp)
    tp = {"materials": {k: torch.from_numpy(v.copy()).requires_grad_()
                        for k, v in p0["materials"].items()}}
    topt = make_optimizer(name, tp, 5e-2)
    for g in grads:
        updates, state = opt.update({"materials": {k: jnp.asarray(v) for k, v in
                                                   g["materials"].items()}}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp["materials"].items():
            v.grad = torch.from_numpy(g["materials"][k])
        topt.step()
        for k, v in tp["materials"].items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp["materials"][k]),
                                       rtol=0, atol=1e-6, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["cornell", "fur_patch"])
def test_remat_gives_identical_gradients(name):
    scene, cam = _scene(name)
    cfg = pt.RenderConfig(depth=3, spp=2)
    plain = _loss_grads(scene, cam, rng.key(6, CPU), cfg, lights=True, env=True)
    remat = _loss_grads(scene, cam, rng.key(6, CPU), dataclasses.replace(cfg, remat=True),
                        lights=True, env=True)
    for k, g in plain.items():
        assert torch.equal(g, remat[k]), k


@pytest.mark.parametrize("name", ["cornell", "fur_patch_bvh"])
def test_fused_path_raises_under_autograd(name):
    """The full-bounce twin (Cornell) and the shade stage's (a fur patch
    with a cone BVH) refuse to record; under no_grad, with the fit's leaf
    parameters in the scene, they render as with the plain scene."""
    if name == "cornell":
        scene, cam = _scene("cornell")
    else:
        scene, cam = builtins.fur_patch(resolution=(12, 12), fibers_per_face=120, device=CPU)
        scene = traverse.attach_bvh(scene, min_prims=1)
    cfg = pt.RenderConfig(depth=2, spp=1, fused_shading=True)
    leafy = diff.apply_params(scene, diff.make_params(scene, lights=True, env=True))
    with pytest.raises(NotImplementedError, match="fused_shading=False"):
        pt.render_image(leafy, cam, rng.key(0, CPU), cfg)
    refs = cshade.REF_CALLS + cshade.SHADE_REF_CALLS
    with torch.no_grad():
        img = pt.render_image(leafy, cam, rng.key(0, CPU), cfg)
    assert cshade.REF_CALLS + cshade.SHADE_REF_CALLS - refs == cfg.depth
    assert torch.equal(img, pt.render_image(scene, cam, rng.key(0, CPU), cfg))


@pytest.mark.parametrize("case", ["glossy_quad", "point", "spot", "sun", "fur_random_walk"])
def test_gradients_finite_with_mis(case):
    """MIS and Russian roulette at depth 5 on every light kind and on the
    hair walk's random choice: every gradient of the materials, lights and
    environment is finite."""
    if case == "fur_random_walk":
        scene, cam = builtins.fur_patch(resolution=(16, 16), fibers_per_face=40,
                                        fiber_verts=6, device=CPU)
    elif case == "glossy_quad":
        scene, cam = builtins.cornell_box(resolution=(16, 16), variant="glossy", device=CPU)
    else:
        scene, cam = builtins.cornell_box(resolution=(16, 16), light_kind=case, device=CPU)
    cfg = pt.RenderConfig(depth=5, spp=2, mis=True, rr=True, hair_p_random=True)
    g = _loss_grads(scene, cam, rng.key(0, CPU), cfg, lights=True, env=True)
    for k, v in g.items():
        assert torch.isfinite(v).all(), k
    assert g["materials.diffuse"].abs().max() > 0.0 and g["lights.color"].abs().max() > 0.0


@pytest.mark.cuda
def test_gradients_with_kernels_match_twins_on_the_card(monkeypatch):
    """The fur patch (cone BVH) under autograd on the card: K2 picks the
    rows, no plain version runs; the same gradients with the twins swapped
    in, within 1e-4 of each field's max |g| (the index backward adds in no
    fixed order on the card)."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, cam = builtins.fur_patch(resolution=(64, 64), fibers_per_face=400, device=dev)
    scene = traverse.attach_bvh(scene)  # 7,200 cones; the 2 ground triangles stay BVH-less
    cfg = pt.RenderConfig(depth=3, spp=1, remat=True)
    launches, refs = ctraverse.KERNEL_LAUNCHES, ctraverse.REF_CALLS
    got = _loss_grads(scene, cam, rng.key(0, dev), cfg)
    # closest + shadow a bounce, forward and recompute
    assert ctraverse.KERNEL_LAUNCHES - launches == 2 * 2 * cfg.depth
    assert ctraverse.REF_CALLS == refs
    monkeypatch.setattr(ctraverse, "traverse", ctraverse.traverse_ref)
    want = _loss_grads(scene, cam, rng.key(0, dev), cfg)
    for k, w in want.items():
        assert torch.isfinite(got[k]).all(), k
        assert (got[k] - w).abs().max() <= 1e-4 * max(w.abs().max(), 1e-30), k


@pytest.mark.cuda
def test_fused_path_raises_under_autograd_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, cam = builtins.cornell_box(resolution=(32, 32), device=dev)
    cfg = pt.RenderConfig(depth=2, spp=1, fused_shading=True)
    leafy = diff.apply_params(scene, diff.make_params(scene))
    with pytest.raises(NotImplementedError, match="fused_shading=False"):
        pt.render_image(leafy, cam, rng.key(0, dev), cfg)
    launches = cshade.KERNEL_LAUNCHES
    with torch.no_grad():
        img = pt.render_image(leafy, cam, rng.key(0, dev), cfg)
    assert cshade.KERNEL_LAUNCHES - launches == cfg.depth and torch.isfinite(img).all()


if __name__ == "__main__":
    # python tests/test_torch_diff.py OUT.npz: save JAX's gradients of JAX_CASES
    _jax_grads_child(sys.argv[1])
