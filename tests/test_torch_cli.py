"""The port's command line against the JAX package's, on the JSON skin
scene of `chip_smoke.py`'s CLI phase made small (a 6x6-quad skin with a
noise-textured diffuse map and the "Fur" section's 5 fibers a face: 72
triangles, 3,240 cones on a median BVH) at 16x16, depth 2, spp 2:

* `convert` writes the bytes JAX's writes;
* `render --device cpu` runs `--engine pt` (with `--tonemap` and
  `--report`: the HTML holds both BVHs' overlays) and `--engine whitted
  --hair-lobes all`; each image, the float image handed to the PNG writer
  and the PNG itself, is held to the JAX package's CLI under the image
  gate of tests/test_fused_shade.py::_compare. The JAX CLI runs in a child
  process with XLA's ISA capped below FMA (as tests/test_torch_hairball.py
  does: contracted a*b + c moves grazing fiber hits), both renders in one
  process;
* `python -m ba_pathtracing_fur_torch.cli` is the entry point;
* the fused path on the textured JSON scene (K1's plain version with the
  texture fetch) against JAX's fused `render_image` on the same scene, run
  in the same child.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402
from ba_pathtracing_fur_torch import cli  # noqa: E402
from ba_pathtracing_fur_torch.utils import film  # noqa: E402
from test_torch_fur import _compare_images  # noqa: E402

torch.set_num_threads(2)

_NO_FMA = "--xla_cpu_max_isa=SSE4_2"
RES, QUADS = (16, 16), 6
RENDER = ["-r", "2", "-W", str(RES[0]), "-H", str(RES[1]), "-d", "2"]
#: the renders both packages' CLIs make: name -> extra flags
CASES = {"pt": ["--tonemap"], "whitted": ["--engine", "whitted", "--hair-lobes", "all"]}


def _capture(film_mod, store: dict, name: str):
    """Wrap film_mod.write_png so that the float image the CLI writes lands
    in store[name]."""
    write = film_mod.write_png

    def spy(path, img, gamma=2.2):
        store[name] = (np.array(img, np.float32), gamma)
        return write(path, img, gamma)

    film_mod.write_png = spy
    return write


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    chip_smoke.write_skin_scene(d, QUADS, RES, "cpu")
    return d


@pytest.fixture(scope="module")
def jax_cli(scene_dir):
    """The JAX package's CLI renders of CASES: {name: (float image, PNG path)}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {_NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join([_ROOT, _HERE]))
    subprocess.run([sys.executable, os.path.abspath(__file__), str(scene_dir)], env=env,
                   check=True, timeout=900)
    return {n: (np.load(scene_dir / f"jax_{n}.npy"), scene_dir / f"jax_{n}.png") for n in CASES}


def test_convert_writes_jax_bytes(scene_dir):
    from ba_pathtracing_fur_tpu import cli as jcli

    src = str(scene_dir / "skin.obj")
    assert cli.main(["convert", src, str(scene_dir / "port.b3df")]) == 0
    assert jcli.main(["convert", src, str(scene_dir / "jax.b3df")]) == 0
    assert cli.main(["convert", "--raw", src, str(scene_dir / "port_raw.b3df")]) == 0
    assert jcli.main(["convert", "--raw", src, str(scene_dir / "jax_raw.b3df")]) == 0
    for name in ("", "_raw"):
        assert (scene_dir / f"port{name}.b3df").read_bytes() == \
            (scene_dir / f"jax{name}.b3df").read_bytes()


@pytest.mark.parametrize("name", list(CASES))
def test_cli_render_matches_jax_cli(scene_dir, jax_cli, name):
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse

    store = {}
    write = _capture(film, store, "img")
    out = scene_dir / f"port_{name}.png"
    extra = list(CASES[name])
    if name == "pt":
        extra += ["--report", str(scene_dir / "report.html")]
    refs = ctraverse.REF_CALLS + cstream.REF_CALLS
    try:
        assert cli.main(["render", "-s", str(scene_dir / "scene.json"), *RENDER, "-o",
                         str(out), "--device", "cpu", *extra]) == 0
    finally:
        film.write_png = write
    assert ctraverse.REF_CALLS + cstream.REF_CALLS > refs  # the cone BVH's twin
    want_img, want_png = jax_cli[name]
    got_img, gamma = store["img"]
    assert got_img.shape == (RES[1], RES[0], 3) and gamma == (1.0 if name == "pt" else 2.2)
    _compare_images(want_img, got_img)
    _compare_images(film.read_png(str(want_png), 1.0), film.read_png(str(out), 1.0),
                    atol_mean=5e-3, flip_frac=0.02)
    if name == "pt":
        html = (scene_dir / "report.html").read_text()
        assert html.count("structure overlay (cones)") >= 1 and "accel structure" in html
        assert "total_build_s" in html and "data:image/png;base64," in html


def test_cli_runs_as_a_module(scene_dir):
    out = scene_dir / "module.png"
    env = dict(os.environ, PYTHONPATH=_ROOT)
    subprocess.run([sys.executable, "-m", "ba_pathtracing_fur_torch.cli", "render", "-s",
                    "cornell", "-r", "1", "-W", "8", "-H", "6", "-d", "1", "--accel", "none",
                    "-o", str(out), "--device", "cpu"], env=env, check=True, timeout=300)
    img = film.read_png(str(out))
    assert img.shape == (6, 8, 3) and img.max() > 0.0


#: the fused render of the textured JSON scene both packages make
FUSED = dict(depth=2, spp=2, compact=False, fused_shading=True)


def _flat_jax_scene(d: Path):
    from ba_pathtracing_fur_tpu.ops import traverse as jtraverse
    from ba_pathtracing_fur_tpu.scene import graph as jgraph, io as jio

    js, jc = jgraph.flatten(jio.load_scene_json(str(d / "scene.json")))
    return jtraverse.attach_bvh(js), jc


def test_fused_textured_json_scene_matches_jax(scene_dir, jax_cli):
    """The fused bounce (K1's plain version with the texture fetch) on the
    textured JSON scene with its median cone BVH, against JAX's compiled
    fused render_image of the same flattened scene (in the child, without
    FMA)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.core.camera import camera_from_numpy
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene.types import scene_from_numpy

    js, jc = _flat_jax_scene(scene_dir)
    assert js.textures is not None and tuple(js.tex_slots) == ("diffuse",)
    refs = cshade.SHADE_REF_CALLS
    got = pt.render_image(scene_from_numpy(js, device="cpu"), camera_from_numpy(jc, "cpu"),
                          rng.key(0, "cpu"), pt.RenderConfig(**FUSED))
    assert cshade.SHADE_REF_CALLS - refs == FUSED["depth"] * FUSED["spp"]
    _compare_images(np.load(scene_dir / "jax_fused.npy"), got.numpy())


if __name__ == "__main__":
    # python tests/test_torch_cli.py DIR: the JAX package's CLI renders of
    # CASES of DIR/scene.json -> DIR/jax_<name>.npy (the float image handed
    # to the PNG writer) and DIR/jax_<name>.png; its fused render_image
    # (FUSED) of the flattened scene -> DIR/jax_fused.npy
    import jax

    from ba_pathtracing_fur_tpu import cli as jcli
    from ba_pathtracing_fur_tpu.models import pathtracer as jpt
    from ba_pathtracing_fur_tpu.utils import film as jfilm

    jax.config.update("jax_platforms", "cpu")
    d = Path(sys.argv[1])
    js, jc = _flat_jax_scene(d)
    np.save(d / "jax_fused.npy", np.asarray(jpt.render_image(
        js, jc, jax.random.key(0), jpt.RenderConfig(**FUSED, ray_chunk=256))))
    for name, extra in CASES.items():
        store = {}
        _capture(jfilm, store, "img")
        assert jcli.main(["render", "-s", str(d / "scene.json"), *RENDER, "-o",
                          str(d / f"jax_{name}.png"), *extra]) == 0
        np.save(d / f"jax_{name}.npy", store["img"][0])
