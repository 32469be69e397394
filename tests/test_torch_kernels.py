"""Kernel dispatch, build and import hygiene of the PyTorch/CUDA port.

The CUDA kernels themselves run only on a GPU: the `cuda`-marked tests here
build and check them there and skip elsewhere. On the card (which has no
jax, so without tests/conftest.py):
`python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider`.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ba_pathtracing_fur_torch import kernels
from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt
from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
from ba_pathtracing_fur_torch.scene import builtins

torch.set_num_threads(2)

PKG = Path(__file__).resolve().parent.parent / "ba_pathtracing_fur_torch"
KW = dict(depth=2, spp=2, compact=False, fused_shading=True)


def test_cpu_tensors_take_the_plain_version():
    scene, cam = builtins.cornell_box(resolution=(6, 4))
    launches, refs = cshade.KERNEL_LAUNCHES, cshade.REF_CALLS
    img = pt.render_image(scene, cam, rng.key(0), pt.RenderConfig(**KW))
    assert cshade.REF_CALLS - refs == KW["spp"] * KW["depth"]
    assert cshade.KERNEL_LAUNCHES == launches
    assert torch.isfinite(img).all()


def test_device_without_kernel_raises():
    scene, cam = builtins.cornell_box(resolution=(4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pt.render_image(scene, cam, rng.key(0, "meta"), pt.RenderConfig(**KW))


def test_nvcc_command_targets_hopper_without_fast_math(tmp_path):
    cmd = kernels.build_command(tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert [Path(c).name for c in cmd if c.endswith(".cu")] == ["full_bounce.cu"]


def test_failed_build_raises(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'nvcc: refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match="nvcc: refused"):
        kernels.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_c_signatures_match_the_sources():
    src = (PKG / "csrc" / "full_bounce.cu").read_text()
    decl = src[src.index('extern "C" int full_bounce_launch('):]
    params = decl[decl.index("(") + 1:decl.index(")")].split(",")
    assert len(params) == len(kernels.SIGNATURES["full_bounce_launch"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_sources_never_import_jax():
    files = list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    bad = [(str(f), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "ba_pathtracing_fur_tpu")]
    assert not bad


def test_port_renders_with_jax_unimportable():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from ba_pathtracing_fur_torch.core import rng\n"
        "from ba_pathtracing_fur_torch.models import pathtracer as pt\n"
        "from ba_pathtracing_fur_torch.scene import builtins\n"
        "from ba_pathtracing_fur_torch.utils import film\n"
        "import ba_pathtracing_fur_torch.kernels\n"
        "scene, cam = builtins.cornell_box(resolution=(8, 8))\n"
        "img = pt.render_image(scene, cam, rng.key(0), pt.RenderConfig("
        "depth=2, spp=1, compact=False, fused_shading=True))\n"
        "assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())\n"
        "assert film.encode_png(img.numpy())[:4] == b'\\x89PNG'\n"
        "assert 'jax' not in {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, cwd=PKG.parent)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    for variant, mis in (("diffuse", False), ("glossy", True)):
        scene, cam = builtins.cornell_box(resolution=(64, 64), variant=variant, device=dev)
        cfg = pt.RenderConfig(**{**KW, "spp": 4}, mis=mis, rr=mis)
        launches = cshade.KERNEL_LAUNCHES
        got = pt.render_image(scene, cam, rng.key(0, dev), cfg)
        assert cshade.KERNEL_LAUNCHES - launches == cfg.spp * cfg.depth
        cpu_scene, cpu_cam = builtins.cornell_box(resolution=(64, 64), variant=variant)
        want = pt.render_image(cpu_scene, cpu_cam, rng.key(0), cfg)
        d = (got.cpu() - want).abs()
        assert d.mean() < 5e-3 and (d.amax(-1) > 1e-3).double().mean() <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("mis", [False, True])
def test_kernel_all_bsdfs_and_light_kinds_on_the_card(mis):
    """Every surface BSDF and light kind through the kernel, bounce by
    bounce, against the plain version on the same CUDA inputs."""
    import dataclasses

    import numpy as np

    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, _ = builtins.cornell_box(resolution=(64, 64))
    _, cam = builtins.cornell_box(resolution=(64, 64), device=dev)
    table = types.make_material_table([
        dict(bsdf=b, diffuse=(0.7, 0.5, 0.3), specular=(0.9, 0.8, 0.7), volume=(0.8, 0.9, 1.0),
             emission=(2.0, 1.5, 1.0), ior=1.45, roughness=0.35) for b in range(9)])
    mat_id = np.random.default_rng(4).integers(0, 9, scene.tris.count)
    scene = dataclasses.replace(
        scene, tris=dataclasses.replace(scene.tris, mat_id=torch.from_numpy(mat_id).int()),
        materials=table, bsdfs_present=types.scene_bsdfs_present(table),
        lights=types.make_light_pack([
            dict(kind="quad", color=(6.0, 6.0, 6.0), position=(0.0, 0.98, 0.0),
                 direction=(0.0, -1.0, 0.0), size=(0.5, 0.5)),
            dict(kind="point", color=(2.0, 1.0, 1.0), position=(-0.5, 0.5, 0.3), radius=0.1),
            dict(kind="spot", color=(1.0, 2.0, 1.0), position=(0.5, 0.8, 0.2),
                 direction=(-0.2, -1.0, 0.0), radius=0.2),
            dict(kind="sun", color=(0.3, 0.3, 0.5), direction=(0.3, -1.0, 0.2), radius=0.05)]),
        env=types.Environment(color=torch.tensor([0.2, 0.3, 0.4]),
                              ambient=torch.tensor([0.1, 0.1, 0.1])))
    scene = types.to_device(scene, dev)
    cfg = pt.RenderConfig(**KW, mis=mis, rr=mis)
    tables = pt.BounceTables.of(scene)
    ids = torch.arange(64 * 64, device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    for bounce in range(4):
        kw = pt.full_bounce_inputs(state, scene, keys, bounce, cfg, tables)
        got = cshade.shade_bounce_full(**kw)
        want = cshade.shade_bounce_full_ref(**kw)
        for f, a in want.items():
            a, b = a.double().reshape(len(a), -1), got[f].double().reshape(len(a), -1)
            bad = ((a - b).abs() > 1e-4 + 1e-4 * a.abs()).any(-1).double().mean().item()
            assert bad < 0.02, f"bounce {bounce} {f}: {bad:.4f} of rows mismatched"
        state = pt.RayState(**want)
