"""The port's Whitted raytracer against the benchmark's plain reference
(`furbench/furref/models/whitted.py`), on the CPU, without JAX.

* `render_whitted(hair_lobes="all")` on a tiny hair ball (2,000 fibers of
  the seeded groom, 24x24, depth 8), on a one-level BVH (K2's plain version)
  and on a two-level one with the scalp on K5's (K3's), against the
  reference's `render_pixels`: every pixel within the benchmark driver's
  TOL x (1 + the reference's largest channel);
* each planted fault of the driver (and its bfloat16 control) fails that
  comparison;
* the misses' shadow rays (from o + 3.4e38 d, the quirk of t_max = inf)
  are blocked by no primitive under the leaf tests run on every primitive,
  and the reference's search and the port both answer so;
* the reference's modules import neither JAX nor the port.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from ba_pathtracing_fur_torch.models import whitted  # noqa: E402
from ba_pathtracing_fur_torch.ops import traverse  # noqa: E402
from ba_pathtracing_fur_torch.scene import builtins  # noqa: E402
from furbench.drivers import whitted as driver  # noqa: E402
from furbench.furref.core import camera as ref_cam, vecmath as ref_vm  # noqa: E402
from furbench.furref.models import whitted as ref  # noqa: E402
from furbench.furref.ops import bvh as ref_bvh, traverse as ref_traverse  # noqa: E402
from furbench.furref.scene import builtins as ref_builtins  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
#: the tiny ball: the configuration's groom at 2,000 fibers and 24x24
BALL = dict(resolution=(24, 24), n_fibers=2000, fiber_verts=10, fiber_radius=0.004,
            sphere_radius=0.5, on_device=True, seed=0, device=CPU)
CFG = dict(depth=8, supersamples=1, hair_lobes="all")
#: the port's BVH layouts: attach_bvh's keywords
LAYOUTS = {"one_level": dict(method="median"),
           "two_level": dict(method="median", leaf_size=16, fanout=8)}
_CACHE = {}


def _port_image(layout, monkeypatch):
    if layout not in _CACHE:
        if layout == "two_level":
            monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)  # the scalp on K5's twin
        scene, cam = builtins.hair_ball(**BALL)
        scene = traverse.attach_bvh(scene, **LAYOUTS[layout])
        assert traverse._two_level(scene.cone_bvh) == (layout == "two_level")
        _CACHE[layout] = whitted.render_whitted(
            scene, cam, whitted.WhittedConfig(**CFG)).reshape(-1, 3)
    return _CACHE[layout]


def _reference(**knobs):
    scene, cam = ref_builtins.hair_ball(**BALL)
    ids = torch.arange(BALL["resolution"][0] * BALL["resolution"][1])
    cfg = ref.RefConfig.of(CFG, **knobs)
    # in blocks, as the benchmark's check renders them
    return torch.cat([ref.render_pixels(scene, cam, ids[s:s + 100], cfg)
                      for s in range(0, ids.shape[0], 100)])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_render_whitted_matches_the_reference(layout, monkeypatch):
    """Every pixel within TOL x (1 + max channel): the reference runs the
    port's arithmetic in the port's order and its search finds the rows the
    traversal finds, so the image is expected bit for bit; TOL is the
    driver's room for float32 rounding alone."""
    got, want = _port_image(layout, monkeypatch), _reference()
    err, off = driver.errors(got, want)
    assert int(off.sum()) == 0, (int(off.sum()), float(err.max()))
    assert torch.isfinite(want).all() and want.amax() > 0.1
    # the tiny ball's image has every kind of node: hair, scalp and misses
    assert len(set(want.amax(-1).tolist())) > 100


@pytest.mark.parametrize("side", ["control", *sorted(driver.FAULTS)])
def test_each_planted_fault_fails_the_comparison(side, monkeypatch):
    knobs = dict(round_to=torch.bfloat16) if side == "control" else dict(driver.FAULTS[side])
    # `wrong_any` is the driver's own: the reference's any-hit answers inverted
    answer = driver.wrong_any if knobs.pop("flip_any", False) else None
    with driver.shadow_rays(ref, ref_traverse, answer=answer):
        got = _reference(**knobs)
    _, off = driver.errors(got, _port_image("one_level", monkeypatch))
    assert int(off.sum()) > 0, side


def _miss_shadow_rays():
    """The shadow rays of the misses of the tiny ball's camera wavefront, as
    `light_shading` fires them -> (origins, directions) [2M, 3]."""
    scene, cam = ref_builtins.hair_ball(**BALL)
    w, h = cam.resolution
    ids = torch.arange(w * h)
    jit = torch.full((w * h, 2), 0.5)
    o, d = ref_cam.rays_from_pixels(cam, (ids % w).float(), (ids // w).float(), jit)
    hit = ref_traverse.closest_hit(o, d, scene, t_max=torch.full((w * h,), float("inf")))
    miss = hit.t == ref_traverse.INF
    assert hit.valid[miss].all()  # the quirk: a miss is a valid hit at 3.4e38
    pos, norm, view = hit.position[miss], hit.normal[miss], ref_vm.normalize(d[miss])
    origin = pos + 1e-2 * ref._norm_view_flip(norm, view)
    dirs = [ref._light_target(scene.lights, i, pos) - origin
            for i in range(scene.lights.count)]
    return scene, torch.cat([origin] * len(dirs)), torch.cat(dirs)


def test_no_primitive_blocks_a_miss_shadow_ray():
    scene, o, d = _miss_shadow_rays()
    assert o.shape[0] > 200 and (o.abs().amax(-1) > 1e35).all()
    t_max = torch.ones(o.shape[0])
    # the leaf tests on every primitive (the JAX package's arithmetic)
    cones = ref_traverse._components(scene.cones, "cone")
    tris = ref_traverse._components(scene.tris, "tri")
    t_cone = ref_bvh._cone_core(o, d, [cones[None, :, i] for i in range(16)], 1e-4, t_max)
    t_tri = ref_bvh._tri_core(o, d, [tris[None, :, i] for i in range(9)], 1e-4, t_max)
    assert not (t_cone < ref_traverse.INF).any() and not (t_tri < ref_traverse.INF).any()
    # the reference's search and the port's traversal answer the same
    assert not ref_traverse.any_hit(o, d, scene, t_max).any()
    port, _ = builtins.hair_ball(**BALL)
    port = traverse.attach_bvh(port, method="median")
    assert not traverse.any_hit(o, d, port, t_max).any()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_neither_jax_nor_the_port():
    for path in (CHECKOUT / "furbench" / "furref").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "ba_pathtracing_fur_tpu",
                           "ba_pathtracing_fur_torch"}, path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from furbench.furref.models import whitted\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "furbench" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "ba_pathtracing_fur_tpu", "ba_pathtracing_fur_torch"}
