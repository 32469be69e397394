"""The Whitted raytracer's gradients in the port (torch autograd through
`models/whitted.render_whitted`) against the JAX package's.

The fur patch (12x12, 6 fibers a face x 4 vertices, radius 0.03) rendered
with WhittedConfig(hair_lobes="all"): the R, TT and TRT lobes with the TT
and TRT rays traced from inside the fibers, whose closest hits the JAX
package takes on a stop_gradient'ed scene (its `models/whitted.py:170`,
`:178`, `:193`). The loss is the mean of the squared image; the parameters
are both materials' ior, diffuse, specular, hair_alpha and hair_beta. JAX's
DFS is a `lax.while_loop`, which reverse mode cannot differentiate, so its
gradient is `jax.jacfwd` of the same loss, compiled in a child process with
XLA's ISA capped below FMA (as tests/test_torch_diff.py takes JAX's). Field
by field within 1e-3 of the value plus 1e-3 of the field's max |g|
(test_torch_diff.py's tolerance), every entry finite.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from ba_pathtracing_fur_torch import diff
from ba_pathtracing_fur_torch.models import whitted
from ba_pathtracing_fur_torch.scene import builtins

torch.set_num_threads(2)

FUR = dict(resolution=(12, 12), fibers_per_face=6, fiber_verts=4, fiber_radius=0.03)
FIELDS = ("ior", "diffuse", "specular", "hair_alpha", "hair_beta")
_NO_FMA = "--xla_cpu_max_isa=SSE4_2"
_HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_child(out):
    """jax.jacfwd of the loss into the npz `out`."""
    import jax
    import jax.numpy as jnp

    from ba_pathtracing_fur_tpu import diff as jdiff
    from ba_pathtracing_fur_tpu.models import whitted as jwhitted
    from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins

    jax.config.update("jax_platforms", "cpu")
    js, jc = jbuiltins.fur_patch(**FUR)
    params = {"materials": {k: getattr(js.materials, k) for k in FIELDS}}
    cfg = jwhitted.WhittedConfig(hair_lobes="all")

    def loss(p):
        return jnp.mean(jwhitted.render_whitted(jdiff.apply_params(js, p), jc, cfg) ** 2)

    grads = jax.jacfwd(loss)(params)
    np.savez(out, loss=np.asarray(loss(params)),
             **{k: np.asarray(v) for k, v in grads["materials"].items()})


@pytest.fixture(scope="module")
def jax_grads():
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


def test_whitted_gradients_match_jax(jax_grads):
    scene, cam = builtins.fur_patch(**FUR, device="cpu")
    params = {"materials": {k: getattr(scene.materials, k).detach().clone().requires_grad_()
                            for k in FIELDS}}
    img = whitted.render_whitted(diff.apply_params(scene, params), cam,
                                 whitted.WhittedConfig(hair_lobes="all"))
    loss = (img ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jax_grads["loss"]), rtol=1e-5)
    reached = 0
    for k in FIELDS:
        g, w = params["materials"][k].grad.numpy(), jax_grads[k]
        assert np.isfinite(g).all() and np.isfinite(w).all(), k
        tol = 1e-3 * np.abs(w) + 1e-3 * np.abs(w).max()
        bad = np.abs(g - w) > tol
        assert not bad.any(), f"{k}: {np.abs(g - w).max()} past {tol[bad].min()}"
        reached += np.abs(w).max() > 0.0
    assert reached >= 4


if __name__ == "__main__":
    _jax_child(sys.argv[1])
