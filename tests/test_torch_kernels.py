"""Kernel dispatch, build and import hygiene of the PyTorch/CUDA port.

The CUDA kernels themselves run only on a GPU: the `cuda`-marked tests here
build and check them there and skip elsewhere. On the card (which has no
jax, so without tests/conftest.py):
`python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider`.
"""

import ast
import contextlib
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
    scene, cam = builtins.cornell_box(resolution=(6, 4), device="cpu")
    launches, refs = cshade.KERNEL_LAUNCHES, cshade.REF_CALLS
    img = pt.render_image(scene, cam, rng.key(0, "cpu"), pt.RenderConfig(**KW))
    assert cshade.REF_CALLS - refs == KW["spp"] * KW["depth"]
    assert cshade.KERNEL_LAUNCHES == launches
    assert torch.isfinite(img).all()


def test_device_without_kernel_raises():
    scene, cam = builtins.cornell_box(resolution=(4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pt.render_image(scene, cam, rng.key(0, "meta"), pt.RenderConfig(**KW))


def test_nvcc_command_targets_hopper_without_fast_math(tmp_path):
    srcs = kernels.sources()
    assert [s.name for s in srcs] == ["bruteforce.cu", "camera.cu", "full_bounce.cu", "hit.cu",
                                      "shade.cu", "traverse.cu", "traverse_stream.cu"]
    for src in srcs:  # one nvcc per source, each into its own library
        cmd = kernels.build_command(src, tmp_path / f"lib{src.stem}.so")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
        assert [Path(c).name for c in cmd if c.endswith(".cu")] == [src.name]
        # the ray-primitive tests, the shade stage and the camera round as
        # their twins: no FMA contraction (the full-bounce kernel keeps it)
        assert ("-fmad=false" in cmd) == (src.name in ("bruteforce.cu", "camera.cu", "hit.cu",
                                                         "shade.cu", "traverse.cu",
                                                         "traverse_stream.cu"))


def test_failed_build_raises(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'nvcc: refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match="nvcc: refused"):
        kernels.build()
    assert not list((tmp_path / "build").rglob("*.so"))


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_c_signatures_match_the_sources(name):
    src_name, argtypes = kernels.SIGNATURES[name]
    src = (PKG / "csrc" / src_name).read_text()
    decl = src[src.index(f'extern "C" int {name}('):]
    params = decl[decl.index("(") + 1:decl.index(")")].split(",")
    assert len(params) == len(argtypes)


@pytest.mark.parametrize("struct,fields", [("ShadeIn", cshade.SHADE_IN_FIELDS),
                                           ("ShadeOut", cshade.SHADE_OUT_FIELDS)])
def test_shade_structs_match_the_source(struct, fields):
    """The ctypes mirrors of csrc/shade.cu's pointer structs list the same
    fields in the same order."""
    import re

    src = (PKG / "csrc" / "shade.cu").read_text()
    body = src[src.index(f"struct {struct} {{"):]
    body = body[body.index("{") + 1:body.index("};")]
    names = re.findall(r"\*\s*(\w+)", body)
    assert tuple(names) == fields


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
        "scene, cam = builtins.cornell_box(resolution=(8, 8), device='cpu')\n"
        "img = pt.render_image(scene, cam, rng.key(0, 'cpu'), pt.RenderConfig("
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
        cpu_scene, cpu_cam = builtins.cornell_box(resolution=(64, 64), variant=variant,
                                                  device="cpu")
        want = pt.render_image(cpu_scene, cpu_cam, rng.key(0, "cpu"), cfg)
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
    scene, _ = builtins.cornell_box(resolution=(64, 64), device="cpu")
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


def _fur_wavefront(dev, res=(48, 48), bounces=1):
    """A fur-patch scene with a cone BVH and the wavefront of `bounces`
    plain bounces from the camera, on `dev`."""
    from ba_pathtracing_fur_torch.ops import traverse

    scene, cam = builtins.fur_patch(resolution=res, fibers_per_face=200, device=dev)
    scene = traverse.attach_bvh(scene)
    cfg = pt.RenderConfig(**KW)
    ids = torch.arange(res[0] * res[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    return scene, state, keys, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cone", "tri"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_matches_plain_on_the_card(kind, any_hit):
    """K2 against its brute-force twin on the same CUDA inputs: the same
    found rays and t bit for bit, and on closest hits the same rows (the
    lexicographic minimum (t, row), exact t ties across clusters included)."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse
    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    if kind == "cone":
        scene, state, _, _ = _fur_wavefront(dev)
        bvh, o, d = scene.cone_bvh, state.origin, state.direction
    else:
        g = torch.Generator().manual_seed(0)
        v = torch.rand((3000, 3, 3), generator=g) * 2 - 1
        v[:, 1:] = v[:, :1] + 0.1 * v[:, 1:]
        soup = types.make_triangle_pack(v[:, 0].numpy(), v[:, 1].numpy(), v[:, 2].numpy())
        scene, _ = builtins.cornell_box(resolution=(4, 4), device="cpu")
        scene = traverse.attach_bvh(types.to_device(
            __import__("dataclasses").replace(scene, tris=soup), dev), min_prims=1)
        bvh = scene.tri_bvh
        o = (torch.rand((4096, 3), generator=g) * 4 - 2).to(dev)
        d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g), dim=-1).to(dev)
    t_max = torch.full((o.shape[0],), 3.0 if any_hit else 3.4e38, device=dev)
    launches = ctraverse.KERNEL_LAUNCHES
    t1, r1, f1 = ctraverse.traverse(o, d, t_max, bvh, kind, any_hit=any_hit)
    assert ctraverse.KERNEL_LAUNCHES == launches + 1
    t0, r0, f0 = ctraverse.traverse_ref(o, d, t_max, bvh, kind, any_hit=any_hit)
    torch.cuda.synchronize()
    # built without FMA contraction, the kernel rounds as the twin does
    assert torch.equal(f0, f1) and torch.equal(t0, t1) and f0.any()
    if not any_hit:
        assert torch.equal(r0, r1)


def _hit_fields_bit_equal(got, want, what):
    """Every field of two Hits equal bit for bit (floats by their bits, so
    that NaN and the sign of 0 count too)."""
    import dataclasses

    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name).detach(), getattr(want, f.name).detach()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f.name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad = (a != b).reshape(a.shape[0], -1).any(-1)
        assert not bad.any(), f"{what} {f.name}: {int(bad.sum())} of {a.shape[0]} rays differ"


def _hit_case_rays(scene, dev, n, seed):
    """n rays at the scene: origins around its bounds aimed at points inside
    them (camera-like and bounce-like at once), t_max INF but on every 7th
    lane 0 (dead) and on every 5th a random cut below the box's size."""
    lo = torch.cat([x.reshape(-1, 3) for x in (scene.tris.v0, scene.cones.base)]).amin(0)
    hi = torch.cat([x.reshape(-1, 3) for x in (scene.tris.v0, scene.cones.base)]).amax(0)
    g = torch.Generator().manual_seed(seed)
    lo, hi = lo.detach().cpu(), hi.detach().cpu()
    size = (hi - lo).norm()
    o = lo + (hi - lo) * (torch.rand((n, 3), generator=g) * 1.6 - 0.3)
    target = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    d = torch.nn.functional.normalize(target - o, dim=-1)
    t_max = torch.full((n,), 3.4e38)
    t_max[::5] = torch.rand((len(t_max[::5]),), generator=g) * size
    t_max[::7] = 0.0
    return o.to(dev), d.to(dev), t_max.to(dev)


def _capture_hit_inputs(monkeypatch, chit):
    """Keep the arguments of every `hit_of_rows` call (the winner rows that
    `closest_hit` and `joint_closest_any` hand the Hit assembly)."""
    seen = []
    real = chit.hit_of_rows

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(chit, "hit_of_rows", spy)
    return seen


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms inside the block: the torch
    assembly's backward sums each primitive's gradient over many rays, in an
    order that otherwise changes from run to run on the CPU."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _hit_loss(hit):
    """A scalar of every float field of a Hit on its valid lanes."""
    v = hit.valid
    return (hit.t[v].sum() + hit.position[v].sum() + hit.normal[v].sum() + hit.uv[v].sum()
            + hit.fiber_u[v].sum() + hit.fiber_v[v].sum() + hit.fiber_w[v].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hairball", "cone_bvh", "tri_bvh", "grid", "joint", "misses",
                                  "ties", "autograd"])
def test_hit_kernel_matches_torch_assembly_on_the_card(case, monkeypatch):
    """K6 against the torch assembly on the same winner rows, every field
    of the Hit bit for bit: the hair ball (cones on K3, its scalp on K5), a
    cone-only and a triangle-only BVH scene, BVH-less packs on the dense
    grid, the joint pass, rays that all miss, and hand-made dense-grid
    winners with t ties between the kinds. Every case has dead lanes
    (t_max 0) and per-ray t_max cuts. Under autograd (rays that require
    grad, a cone pack that does, on the dense grid) K6 still makes the Hit,
    and the gradients reaching o, d and the cone pack are the torch
    assembly's bit for bit."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit, intersect as cisect
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream
    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    if case in ("hairball", "joint", "misses", "ties"):
        scene, _ = builtins.hair_ball(resolution=(8, 8), n_fibers=3000, on_device=True,
                                      device=dev)
        if case != "ties":
            scene = traverse.attach_bvh(scene, leaf_size=16, fanout=8)
            assert scene.tri_bvh is None and traverse.joint_eligible(scene)
        monkeypatch.setattr(traverse, "_BRUTE_MIN", 1)  # the scalp on K5
    elif case == "cone_bvh":
        scene, _ = builtins.fur_patch(resolution=(8, 8), fibers_per_face=200, device="cpu")
        scene = traverse.attach_bvh(types.to_device(dataclasses.replace(
            scene, tris=types.empty_triangle_pack()), dev))
        assert scene.cone_bvh is not None and scene.tris.count == 0
    elif case == "tri_bvh":
        g = torch.Generator().manual_seed(0)
        v = torch.rand((3000, 3, 3), generator=g) * 2 - 1
        v[:, 1:] = v[:, :1] + 0.1 * v[:, 1:]
        soup = types.make_triangle_pack(v[:, 0].numpy(), v[:, 1].numpy(), v[:, 2].numpy())
        scene, _ = builtins.cornell_box(resolution=(4, 4), device="cpu")
        scene = traverse.attach_bvh(types.to_device(dataclasses.replace(scene, tris=soup), dev),
                                    min_prims=1)
        assert scene.tri_bvh is not None and scene.cones.count == 0
    else:  # grid, autograd
        scene, _ = builtins.fur_patch(resolution=(8, 8), fibers_per_face=3, device=dev)
        assert scene.cone_bvh is None and scene.tri_bvh is None
    o, d, t_max = _hit_case_rays(scene, dev, 2048 if case in ("grid", "autograd") else 40000, 3)
    if case == "misses":  # from outside the ball, away from it
        o, d = o + 4.0 * d.abs(), d.abs()
    if case == "autograd":
        base = scene.cones.base.clone().requires_grad_()
        scene = dataclasses.replace(scene, cones=dataclasses.replace(scene.cones, base=base))
        o, d = o.requires_grad_(), d.requires_grad_()
    counts = lambda: (chit.HIT_LAUNCHES, chit.HIT_REF_CALLS, chit.HIT_GRAD_CALLS)  # noqa: E731
    before = counts()
    k3, k5 = cstream.KERNEL_LAUNCHES + cstream.MIXED_LAUNCHES, cisect.TRI_LAUNCHES
    seen = _capture_hit_inputs(monkeypatch, chit)
    if case == "ties":
        r = o.shape[0]
        g = torch.Generator().manual_seed(5)
        t_tri = torch.rand((r,), generator=g) * 2
        t_cone = torch.where(torch.arange(r) % 3 == 0, t_tri, torch.rand((r,), generator=g) * 2)
        t_cone[1::4] = traverse.INF
        t_tri[2::6] = traverse.INF
        won = {kind: (aos_fn(pack), torch.randint(0, pack.count, (r,), generator=g,
                                                  dtype=torch.int32).to(dev), None,
                      t.to(dev), None)
               for kind, pack, aos_fn, t in (("tri", scene.tris, chit.tri_aos, t_tri),
                                             ("cone", scene.cones, chit.cone_aos, t_cone))}
        got = chit.hit_of_rows(o, d, t_max, 1e-4, won)
        assert (got.prim_type == 0).any() and (t_tri == t_cone).any()
    elif case == "joint":
        o_a, d_a, tmax_a = _hit_case_rays(scene, dev, o.shape[0], 4)
        got, blocked = traverse.joint_closest_any(o, d, t_max, o_a, d_a, tmax_a, scene)
        assert blocked.any()
    else:
        got = traverse.closest_hit(o, d, scene, t_max=t_max)
    assert len(seen) == 1
    want = chit._torch_hit(*seen[0])
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2])
    if case in ("hairball", "joint"):
        assert cstream.KERNEL_LAUNCHES + cstream.MIXED_LAUNCHES > k3 and cisect.TRI_LAUNCHES > k5
    _hit_fields_bit_equal(got, want, case)
    valid = got.valid
    if case == "misses":
        assert not valid.any()
    else:
        assert not valid[::7].any() and valid.any()
    if case in ("hairball", "joint", "ties"):
        assert ((got.prim_type == 1) & valid).any() and ((got.prim_type == 0) & valid).any()
    if case == "autograd":
        assert got.t.requires_grad and want.t.requires_grad
        with _deterministic():
            g_k6 = torch.autograd.grad(_hit_loss(got), (o, d, base), retain_graph=True)
            assert counts() == (before[0] + 1, before[1], before[2] + 1)
            g_torch = torch.autograd.grad(_hit_loss(want), (o, d, base))
        for a, b in zip(g_k6, g_torch):
            assert a.abs().sum() > 0 and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_hit_assembly_takes_the_torch_path_on_the_cpu():
    """On the CPU closest_hit assembles the Hit in torch: HIT_REF_CALLS
    counts it, K6 never launches, and the span `hit` counts the rays."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit
    from ba_pathtracing_fur_torch.utils import profiling

    scene, cam = builtins.fur_patch(resolution=(8, 8), fibers_per_face=120, device="cpu")
    scene = traverse.attach_bvh(scene, min_prims=1)
    o, d, t_max = _hit_case_rays(scene, torch.device("cpu"), 500, 1)
    launches, refs = chit.HIT_LAUNCHES, chit.HIT_REF_CALLS
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        hit = traverse.closest_hit(o, d, scene, t_max=t_max)
    assert chit.HIT_REF_CALLS == refs + 1 and chit.HIT_LAUNCHES == launches
    spans = [s for s in profiling.spans() if s.name == "hit"]
    assert len(spans) == 1 and spans[0].count("hit_rays") == 500
    assert hit.valid.any() and not hit.valid[::7].any()


def test_hit_work_ref_counts_the_bytes(monkeypatch):
    """K6's bound: per ray 28 B of o, d and t_max, 5 B of row and found a
    BVH kind (8 B of row and t a dense-grid kind), 86 B of Hit; a BVH
    kind's row read where found, a dense-grid kind's where it won, and the
    winning BVH kind's perm entry."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit

    scene, _ = builtins.fur_patch(resolution=(8, 8), fibers_per_face=120, device="cpu")
    scene = traverse.attach_bvh(scene)
    assert scene.cone_bvh is not None and scene.tri_bvh is None and scene.tris.count
    o, d, t_max = _hit_case_rays(scene, torch.device("cpu"), 500, 7)
    seen = _capture_hit_inputs(monkeypatch, chit)
    hit = traverse.closest_hit(o, d, scene, t_max=t_max)
    kinds = seen[0][4]
    found = kinds["cone"][2]
    cones = int((hit.valid & (hit.prim_type == 1)).sum())
    tris = int((hit.valid & (hit.prim_type == 0)).sum())
    assert found.any() and cones and tris
    work = chit.work_ref(hit, kinds)
    assert work["rows"] == int(found.sum()) + tris
    assert work["bytes"] == (500 * (28 + 5 + 8 + 86) + int(found.sum()) * 19 * 4 + cones * 4
                             + tris * 34 * 4)


def test_hit_assembly_under_autograd_takes_the_torch_path():
    """On the CPU a call whose rays and cone pack require grad takes the
    torch assembly, and the gradients of the Hit reach o, d and the cone
    pack. The BVH-less pack's row table is made anew for it, not kept, while
    that of a pack without grad is kept for the pack's next call."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit

    scene, _ = builtins.fur_patch(resolution=(8, 8), fibers_per_face=3, device="cpu")
    plain = scene
    base = scene.cones.base.clone().requires_grad_()
    scene = dataclasses.replace(scene, cones=dataclasses.replace(scene.cones, base=base))
    o, d, t_max = _hit_case_rays(scene, torch.device("cpu"), 1000, 2)
    o, d = o.requires_grad_(), d.requires_grad_()
    refs, launches = chit.HIT_REF_CALLS, chit.HIT_LAUNCHES
    hit = traverse.closest_hit(o, d, scene, t_max=t_max)
    assert chit.HIT_REF_CALLS == refs + 1 and chit.HIT_LAUNCHES == launches
    cone = hit.valid & (hit.prim_type == 1)
    assert cone.any()
    (hit.t[hit.valid].sum() + hit.normal[cone].sum() + hit.uv[cone].sum()).backward()
    for x in (o, d, base):
        assert x.grad is not None and torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert chit.pack_aos(scene.cones, "cone") is not chit.pack_aos(scene.cones, "cone")
    assert chit.pack_aos(plain.cones, "cone") is chit.pack_aos(plain.cones, "cone")
    with torch.no_grad():
        assert chit.pack_aos(scene.cones, "cone").grad_fn is None


def test_kernel_hit_backward_is_the_torch_assemblys_gradient(monkeypatch):
    """`_KernelHit` (K6's Hit under autograd on the card) on the CPU, with
    the kernel's launch replaced by the torch assembly under no_grad: its
    outputs carry a gradient only on the float fields, its backward
    recomputes the torch assembly once, and the gradients reaching o, d,
    the cone pack (through its row table and the dense grid's t) equal
    those of the torch assembly itself bit for bit."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.bruteforce import Hit
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit

    def launch(o, d, t_max, t_min, kinds):
        with torch.no_grad():
            return chit._torch_hit(o, d, t_max, t_min, kinds)

    monkeypatch.setattr(chit, "_hit_cuda", launch)
    scene, _ = builtins.fur_patch(resolution=(8, 8), fibers_per_face=3, device="cpu")
    base = scene.cones.base.clone().requires_grad_()
    scene = dataclasses.replace(scene, cones=dataclasses.replace(scene.cones, base=base))
    o, d, t_max = _hit_case_rays(scene, torch.device("cpu"), 1000, 6)
    o, d = o.requires_grad_(), d.requires_grad_()
    seen = _capture_hit_inputs(monkeypatch, chit)
    want = traverse.closest_hit(o, d, scene, t_max=t_max)
    o_, d_, t_max_, t_min, kinds = seen[0]
    diff = chit._differentiable(o_, d_, t_max_, kinds)
    # o, d, t_max, the triangles' table and grid t, the cones' table and grid t
    assert [x.requires_grad for x in diff] == [True, True, False, False, True, True, True]
    grads0 = chit.HIT_GRAD_CALLS
    out = chit._KernelHit.apply(t_min, kinds, *diff)
    got = Hit(**dict(zip((f.name for f in dataclasses.fields(Hit)), out)))
    for f in dataclasses.fields(Hit):
        assert getattr(got, f.name).requires_grad == (f.name in chit._FLOAT_FIELDS), f.name
    _hit_fields_bit_equal(got, want, "cpu")
    with _deterministic():
        g_k6 = torch.autograd.grad(_hit_loss(got), (o, d, base), retain_graph=True)
        assert chit.HIT_GRAD_CALLS == grads0 + 1
        g_torch = torch.autograd.grad(_hit_loss(want), (o, d, base))
    for a, b in zip(g_k6, g_torch):
        assert a.abs().sum() > 0 and torch.equal(a.view(torch.int32), b.view(torch.int32))


#: a large seed, so that both words of the base key are non-zero
CAMERA_SEED = (1 << 33) + 977
#: the gate's sample indices (2^20: a sample index past any pass count)
CAMERA_SAMPLES = [0, 7, 1 << 20]


def _dof_camera(res, dev):
    """The hair ball's camera with the thin lens on, focused on the ball."""
    from ba_pathtracing_fur_torch.core import camera as cam_mod

    return cam_mod.make_camera(position=(0.0, 0.3, 2.2), look_at=(0.0, -0.1, -1.0),
                               resolution=res, focus_distance=2.2, use_dof=True, device=dev)


def _camera_chain(cam, ids, key, samples, qmc, spp):
    """The camera wavefront written out from core/rng and core/camera, as
    models/pathtracer made it before the camera kernel -> (keys, o, d)."""
    from ba_pathtracing_fur_torch.core import camera as cam_mod

    w = cam.resolution[0]
    keys = [rng.keys_for_pixels(key, ids, s) for s in samples]
    jitter = [rng.qmc_jitter(key, ids, s, spp) if qmc else rng.bounce_uniform(k, -1, 2, tag=7)
              for s, k in zip(samples, keys)]
    dof_u = (torch.cat([rng.bounce_uniform(k, -1, 2, tag=8) for k in keys]) if cam.use_dof
             else None)
    px = (ids % w).to(torch.float32).repeat(len(samples))
    py = (ids // w).to(torch.float32).repeat(len(samples))
    o, d = cam_mod.rays_from_pixels(cam, px, py, torch.cat(jitter), dof_u)
    return torch.cat(keys), o, d


@pytest.mark.parametrize("qmc,dof", [(False, False), (True, False), (False, True),
                                     (True, True)])
def test_camera_wavefront_takes_the_torch_chain_on_the_cpu(qmc, dof, monkeypatch):
    """CPU tensors take the camera kernel's plain version: CAMERA_REF_CALLS
    counts one call a wavefront, the kernels are never loaded, and the
    wavefront is the chain of core/rng and core/camera, with the initial
    state of every ray."""
    from ba_pathtracing_fur_torch.ops.cuda import camera as ccamera

    def refuse():
        raise AssertionError("the camera's CPU path loaded the kernels")

    monkeypatch.setattr(kernels, "load_library", refuse)
    cam = _dof_camera((12, 8), "cpu") if dof else builtins.hair_ball(
        resolution=(12, 8), n_fibers=16, device="cpu")[1]
    ids = torch.tensor([0, 5, 11, 12, 50, 95])
    key = rng.key(CAMERA_SEED, "cpu")
    launches, refs = ccamera.CAMERA_LAUNCHES, ccamera.CAMERA_REF_CALLS
    state, keys = pt.camera_wavefront(cam, ids, key, CAMERA_SAMPLES,
                                      pt.RenderConfig(spp=4, qmc=qmc))
    assert ccamera.CAMERA_REF_CALLS == refs + 1 and ccamera.CAMERA_LAUNCHES == launches
    want_keys, o, d = _camera_chain(cam, ids, key, CAMERA_SAMPLES, qmc, 4)
    n = len(CAMERA_SAMPLES) * ids.shape[0]
    assert torch.equal(keys, want_keys) and keys.shape == (n, 2)
    assert torch.equal(state.origin, o) and torch.equal(state.direction, d)
    assert torch.equal(state.radiance, torch.ones(n, 3))
    assert torch.equal(state.color, torch.zeros(n, 3))
    assert state.flags.dtype == torch.int32 and not state.flags.any()
    assert torch.equal(state.theta_i, torch.zeros(n))
    assert torch.equal(state.prev_pdf, torch.full((n,), -1.0))


def test_camera_work_ref_counts_bytes_and_threefry():
    """The camera kernel's bound: 8 B read and 76 B written a ray (88 MB at
    1024^2), and the threefry calls of each branch."""
    from ba_pathtracing_fur_torch.ops.cuda import camera as ccamera

    r = 1 << 20
    for qmc, dof, calls in ((False, False, 5), (True, False, 6), (False, True, 8),
                            (True, True, 9)):
        w = ccamera.work_ref(r, qmc, dof)
        draws = 4 if dof else 2
        assert w["bytes"] == 84 * r == 88_080_384 and w["threefry"] == calls
        assert w["int_ops"] == r * (calls * cshade.THREEFRY_INT_OPS
                                    + draws * cshade.DRAW_INT_OPS)


def _camera_case(case, dev):
    """(camera, pixel ids, sample ids, qmc, spp) of a camera-kernel gate case:
    the hair ball's 1024^2 camera on every pixel, a shard's pixel ids, one
    and three samples, the Hammersley jitter, a thin-lens camera."""
    res = (1024, 1024)
    _, cam = builtins.hair_ball(resolution=res, n_fibers=16, device=dev)
    ids = torch.arange(res[0] * res[1], device=dev)
    if case == "shard":  # the third of four dp rows, then a scattered subset
        pick = torch.randperm(ids.shape[0], generator=torch.Generator().manual_seed(5))[:4099]
        ids = torch.cat([ids[2 * (1 << 18):3 * (1 << 18)], pick.to(dev)])
    samples = {"hairball": [0], "shard": [7], "samples_3": CAMERA_SAMPLES,
               "qmc": [1 << 20], "qmc_samples_3": CAMERA_SAMPLES, "dof": [7],
               "dof_samples_3": CAMERA_SAMPLES}[case]
    if case.startswith("dof"):
        cam = _dof_camera(res, dev)
    return cam, ids, samples, case.startswith("qmc"), 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hairball", "shard", "samples_3", "qmc", "qmc_samples_3",
                                  "dof", "dof_samples_3"])
def test_camera_kernel_matches_the_torch_chain_on_the_card(case):
    """The camera kernel's keys, o, d and every initial RayState field equal
    its torch chain's on the same card tensors bit for bit (floats by their
    int32 views); one launch a sample, and the chain never runs on the
    card's path."""
    from ba_pathtracing_fur_torch.ops.cuda import camera as ccamera

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    cam, ids, samples, qmc, spp = _camera_case(case, dev)
    key = rng.key(CAMERA_SEED, dev)
    launches, refs = ccamera.CAMERA_LAUNCHES, ccamera.CAMERA_REF_CALLS
    state, keys = pt.camera_wavefront(cam, ids, key, samples, pt.RenderConfig(spp=spp, qmc=qmc))
    torch.cuda.synchronize()
    assert ccamera.CAMERA_LAUNCHES == launches + len(samples)
    assert ccamera.CAMERA_REF_CALLS == refs
    want_keys, want = ccamera.camera_rays_ref(cam, ids, key, samples, qmc, spp)
    assert torch.equal(keys, want_keys)
    for name, b in zip(pt.RayState.__dataclass_fields__, want):
        a = getattr(state, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{case}: {name} differs in {int((a != b).sum())} values"


def _shade_gate(want, got, what):
    """K1 against its twin under the per-field gate (shadow rays compared
    where they are traced)."""
    live = want["shadow_tmax"] > 0
    for f, a in want.items():
        b = got[f]
        if f in ("shadow_o", "shadow_d"):
            a, b = a[live], b[live]
        a, b = a.double().reshape(len(a), -1), b.double().reshape(len(b), -1)
        bad = ((a - b).abs() > 1e-4 + 1e-4 * a.abs()).any(-1).double().mean().item()
        assert bad < 0.02, f"{what} {f}: {bad:.4f} of rows mismatched"


@pytest.mark.cuda
@pytest.mark.parametrize("p_random", [False, True])
@pytest.mark.parametrize("mis,rr", [(False, False), (True, False), (False, True),
                                    (True, True)])
def test_shade_kernel_matches_plain_on_the_card(p_random, mis, rr):
    """K1 against its twin on fur-patch hits, bounce by bounce, from the
    same keys and material ids (RR gated on from bounce 1)."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, state, keys, cfg = _fur_wavefront(dev)
    cfg = dataclasses.replace(cfg, hair_p_random=p_random, mis=mis, rr=rr, rr_start=1)
    tables = pt.BounceTables.of(scene)
    for bounce in range(3):
        hit = traverse.closest_hit(state.origin, state.direction, scene)
        kw = pt.shade_inputs(state, scene, keys, bounce, cfg, hit, tables)
        launches = cshade.SHADE_LAUNCHES
        got = cshade.shade_bounce(**kw)
        assert cshade.SHADE_LAUNCHES == launches + 1
        want = cshade.shade_bounce_ref(**kw)
        _shade_gate(want, got, f"bounce {bounce}")
        state = pt.RayState(**{f: want[f] for f in cshade.SHADE_OUT_FIELDS
                               if f in pt.RayState.__dataclass_fields__})


def test_kernel_draws_take_the_plain_version_on_the_cpu():
    """The draws of K1's test launch come, for CPU tensors, from its plain
    version, the torch threefry."""
    keys = rng.keys_for_pixels(rng.key(3, "cpu"), torch.arange(77), 2)
    assert torch.equal(cshade.kernel_draws(keys, 1, 5), rng.bounce_uniforms(keys, 1, 5, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 127, 1000, 4096])
def test_shade_kernel_draws_equal_threefry_on_the_card(n_rays):
    """The draws K1 makes from each ray's key (through the test-only
    launch of csrc/shade.cu, on the same threefry.cuh functions and tag
    keys) equal `rng.bounce_uniforms` bit for bit, for every tag and
    bounce, on wavefronts that are not a multiple of the block."""
    import numpy as np

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    ids = torch.from_numpy(np.random.default_rng(n_rays).integers(0, 1 << 22, n_rays)).to(dev)
    keys = rng.keys_for_pixels(rng.key(n_rays, dev), ids, 3)
    for bounce in range(5):
        got = cshade.kernel_draws(keys, bounce, 5)
        want = rng.bounce_uniforms(keys, bounce, 5, 2)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), bounce


@pytest.mark.cuda
def test_shade_kernel_edge_material_ids_on_the_card():
    """Ids -1, 0, M-1 and M read the rows the twin reads (jnp's gather: a
    negative id wraps, one past the end clamps)."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, state, keys, cfg = _fur_wavefront(dev)
    cfg = dataclasses.replace(cfg, mis=True)
    tables = pt.BounceTables.of(scene)
    m = tables.mats.shape[0]
    hit = traverse.closest_hit(state.origin, state.direction, scene)
    ids = torch.tensor([-1, 0, m - 1, m], dtype=torch.int32, device=dev)
    hit = dataclasses.replace(hit, mat_id=ids.repeat(state.origin.shape[0] // 4))
    kw = pt.shade_inputs(state, scene, keys, 0, cfg, hit, tables)
    _shade_gate(cshade.shade_bounce_ref(**kw), cshade.shade_bounce(**kw), "edge ids")


@pytest.mark.cuda
def test_shade_kernel_large_material_table_on_the_card():
    """A material table beyond 48 KB of shared memory (1,000 rows: the
    launch raises the kernel's dynamic shared-memory limit) against the
    twin, each ray on a random row."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, state, keys, cfg = _fur_wavefront(dev)
    tables = pt.BounceTables.of(scene)
    g = torch.Generator().manual_seed(2)
    mats = tables.mats.repeat(500, 1)[:1000].contiguous()
    mats[:, 0:3] *= torch.rand((1000, 3), generator=g).to(dev)
    hit = traverse.closest_hit(state.origin, state.direction, scene)
    hit = dataclasses.replace(hit, mat_id=torch.randint(0, 1000, hit.mat_id.shape, generator=g,
                                                        dtype=torch.int32).to(dev))
    kw = dict(pt.shade_inputs(state, scene, keys, 0, cfg, hit, tables), mats_table=mats)
    assert 4 * mats.numel() > 48 * 1024
    _shade_gate(cshade.shade_bounce_ref(**kw), cshade.shade_bounce(**kw), "1,000 materials")


@pytest.mark.cuda
def test_shade_kernel_takes_a_per_ray_environment_on_the_card():
    """The environment colour reaches K1 either once (a constant: 3 floats)
    or per ray ([R,3] rows), beside the keys and material ids; both agree
    with the plain version."""
    from ba_pathtracing_fur_torch.ops import traverse

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, state, keys, cfg = _fur_wavefront(dev)
    hit = traverse.closest_hit(state.origin, state.direction, scene)
    kw = pt.shade_inputs(state, scene, keys, 0, cfg, hit, pt.BounceTables.of(scene))
    assert kw["env_color"].stride(0) == 0
    g = torch.Generator().manual_seed(1)
    per_ray = torch.rand((state.origin.shape[0], 3), generator=g).to(dev)
    for env in (kw["env_color"], per_ray):
        got = cshade.shade_bounce(**{**kw, "env_color": env})
        want = cshade.shade_bounce_ref(**{**kw, "env_color": env})
        a, b = want["color"].double(), got["color"].double()
        assert ((a - b).abs() > 1e-4 + 1e-4 * a.abs()).any(-1).double().mean() < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cone", "tri"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_kernel_matches_plain_on_the_card(kind, any_hit):
    """K3 against its brute-force twin and against K2 on the same two-level
    BVH: the same found rays and t and, on closest hits, the same rows, bit
    for bit (all three evaluate the leaf tests without FMA contraction and
    return the lexicographic minimum (t, row))."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse
    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    if kind == "cone":
        scene, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=3000, on_device=True,
                                      device=dev)
        bvh = traverse.attach_bvh(scene, leaf_size=24, fanout=16).cone_bvh
        o = (torch.rand((4096, 3), generator=g) * 3 - 1.5).to(dev)
        d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g), dim=-1).to(dev)
    else:
        v = torch.rand((20000, 3, 3), generator=g) * 2 - 1
        v[:, 1:] = v[:, :1] + 0.05 * v[:, 1:]
        soup = types.make_triangle_pack(v[:, 0].numpy(), v[:, 1].numpy(), v[:, 2].numpy())
        scene, _ = builtins.cornell_box(resolution=(4, 4), device="cpu")
        scene = types.to_device(dataclasses.replace(scene, tris=soup), dev)
        bvh = traverse.attach_bvh(scene, leaf_size=16, fanout=8, min_prims=1).tri_bvh
        o = (torch.rand((4096, 3), generator=g) * 4 - 2).to(dev)
        d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g), dim=-1).to(dev)
    assert 0 < bvh.fanout < bvh.n_leaves and bvh.cboxes is not None
    t_max = torch.full((o.shape[0],), 1.0 if any_hit else 3.4e38, device=dev)
    t_max[::9] = 0.0
    launches = cstream.KERNEL_LAUNCHES
    t1, r1, f1 = cstream.traverse_stream(o, d, t_max, bvh, kind, any_hit=any_hit)
    assert cstream.KERNEL_LAUNCHES == launches + 1
    t0, r0, f0 = cstream.traverse_stream_ref(o, d, t_max, bvh, kind, any_hit=any_hit)
    t2, r2, f2 = ctraverse.traverse(o, d, t_max, dataclasses.replace(bvh, fanout=0), kind,
                                    any_hit=any_hit)
    torch.cuda.synchronize()
    assert torch.equal(f0, f1) and torch.equal(f2, f1) and f0.any() and not f0.all()
    assert torch.equal(t0, t1) and torch.equal(t2, t1)
    if any_hit:
        assert (t1[f1] == 0).all() and torch.equal(t1[~f1], t_max[~f1])
    else:
        assert torch.equal(r0, r1) and torch.equal(r2, r1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cone", "tri"])
def test_stream_kernel_mixed_mode_on_the_card(kind):
    """K3's mixed instance (`is_any`, one flag a ray) on interleaved pairs of
    a closest-hit and a shadow ray from one origin: each ray gets what its
    own mode's launch gives it (closest rays found, t and rows, shadow rays
    found and t = 0 on acceptance, bit for bit) and what the mixed plain
    version gives it; dead rays of either kind stay inert. Counted apart."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream
    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    if kind == "cone":
        bvh, _, o, d, t_max = _tile_case("fanout_2", dev)
        bvh = types._to(bvh, dev)
    else:
        g = torch.Generator().manual_seed(9)
        v = torch.rand((20000, 3, 3), generator=g) * 2 - 1
        v[:, 1:] = v[:, :1] + 0.05 * v[:, 1:]
        soup = types.make_triangle_pack(v[:, 0].numpy(), v[:, 1].numpy(), v[:, 2].numpy())
        scene, _ = builtins.cornell_box(resolution=(4, 4), device="cpu")
        scene = types.to_device(dataclasses.replace(scene, tris=soup), dev)
        bvh = traverse.attach_bvh(scene, leaf_size=16, fanout=8, min_prims=1).tri_bvh
        o = (torch.rand((4096, 3), generator=g) * 4 - 2).to(dev)
        d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g), dim=-1).to(dev)
        t_max = torch.where(torch.arange(4096, device=dev) % 9 == 0, 0.0, 3.4e38)
    n = o.shape[0] // 2
    g = torch.Generator().manual_seed(8)
    d_a = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1).to(dev)
    t_a = torch.where(torch.arange(n, device=dev) % 7 == 0, 0.0, 1.0)
    o2, d2, t2, is_any, _ = traverse.joint_wavefront(o[:n], d[:n], t_max[:n], o[:n], d_a, t_a,
                                                      bvh)
    launches, mixed = cstream.KERNEL_LAUNCHES, cstream.MIXED_LAUNCHES
    t, row, found = cstream.traverse_stream(o2, d2, t2, bvh, kind, is_any=is_any)
    assert (cstream.KERNEL_LAUNCHES, cstream.MIXED_LAUNCHES) == (launches, mixed + 1)
    want_c = cstream.traverse_stream(o2[0::2], d2[0::2], t2[0::2], bvh, kind)
    want_a = cstream.traverse_stream(o2[1::2], d2[1::2], t2[1::2], bvh, kind, any_hit=True)
    ref = cstream.traverse_stream_ref(o2, d2, t2, bvh, kind, is_any=is_any)
    torch.cuda.synchronize()
    for got, want in ((t[0::2], want_c[0]), (row[0::2], want_c[1]), (found[0::2], want_c[2]),
                      (t[1::2], want_a[0]), (found[1::2], want_a[2]), (t, ref[0]),
                      (found, ref[2]), (row[0::2], ref[1][0::2])):
        assert torch.equal(got, want)
    assert found[0::2].any() and found[1::2].any() and not found[1::2].all()
    assert not found[(t2 == 0.0)].any() and (t[1::2][found[1::2]] == 0.0).all()


def _variant_case(kind, mode, dev, leaf=16):
    """(bvh, o, d, t_max, is_any) on `dev` for K3's variants: the small hair
    ball's cones (leaf 24, fanout 16) or a soup of 20,000 triangles (leaf
    `leaf`, fanout 8), 4,096 rays from a seed; a shadow ray traces to 1.0,
    a closest one to 3.4e38, every 9th ray is dead; `mixed` makes every
    other ray a shadow ray."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import types

    g = torch.Generator().manual_seed(12)
    if kind == "cone":
        scene, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=3000, on_device=True,
                                      device=dev)
        bvh = traverse.attach_bvh(scene, leaf_size=24, fanout=16).cone_bvh
        o = (torch.rand((4096, 3), generator=g) * 3 - 1.5).to(dev)
    else:
        v = torch.rand((20000, 3, 3), generator=g) * 2 - 1
        v[:, 1:] = v[:, :1] + 0.05 * v[:, 1:]
        soup = types.make_triangle_pack(v[:, 0].numpy(), v[:, 1].numpy(), v[:, 2].numpy())
        scene, _ = builtins.cornell_box(resolution=(4, 4), device="cpu")
        scene = types.to_device(dataclasses.replace(scene, tris=soup), dev)
        bvh = traverse.attach_bvh(scene, leaf_size=leaf, fanout=8, min_prims=1).tri_bvh
        o = (torch.rand((4096, 3), generator=g) * 4 - 2).to(dev)
    assert 0 < bvh.fanout < bvh.n_leaves and bvh.leaf_size == (24 if kind == "cone" else leaf)
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g), dim=-1).to(dev)
    n = torch.arange(4096, device=dev)
    shadow = (n % 2 == 1) if mode == "mixed" else torch.full_like(n, mode == "any", dtype=bool)
    t_max = torch.where(n % 9 == 0, 0.0, torch.where(shadow, 1.0, 3.4e38))
    return bvh, o, d, t_max, shadow if mode == "mixed" else None


@pytest.mark.cuda
@pytest.mark.parametrize("kind,leaf", [("cone", 24), ("tri", 16), ("tri", 14), ("tri", 13)])
@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_stream_kernel_bf16_matches_plain_on_the_card(kind, leaf, mode):
    """K3's bf16 instances (`pack_prim_hbm(bvh, kind, torch.bfloat16)`)
    against their plain version, the brute force over the upcast pack:
    found and t bit for bit, rows on closest-hit rays; the leaf copies of 16
    bytes (cones, triangle leaf 16), 4 bytes (leaf 14) and plain loads (leaf
    13: an odd W*K); counted in BF16_LAUNCHES alone."""
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    bvh, o, d, t_max, is_any = _variant_case(kind, mode, dev, leaf)
    b16 = cstream.pack_prim_hbm(bvh, kind, torch.bfloat16)
    counts = (cstream.KERNEL_LAUNCHES, cstream.MIXED_LAUNCHES, cstream.MXU_LAUNCHES,
              cstream.BF16_LAUNCHES)
    t1, r1, f1 = cstream.traverse_stream(o, d, t_max, b16, kind, any_hit=mode == "any",
                                         is_any=is_any)
    assert (cstream.KERNEL_LAUNCHES, cstream.MIXED_LAUNCHES, cstream.MXU_LAUNCHES,
            cstream.BF16_LAUNCHES) == counts[:3] + (counts[3] + 1,)
    t0, r0, f0 = cstream.traverse_stream_ref(o, d, t_max, b16, kind, any_hit=mode == "any",
                                             is_any=is_any)
    torch.cuda.synchronize()
    assert torch.equal(f0, f1) and torch.equal(t0, t1) and f0.any() and not f0.all()
    closest = torch.full_like(f0, mode == "closest") if is_any is None else ~is_any
    assert torch.equal(r0[closest], r1[closest])
    assert not f1[t_max == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pack", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_stream_kernel_mxu_on_the_card(pack, mode):
    """K3's tensor-core instances (`mxu=True`, f32 or bf16 pack) against
    their plain version (`brute_force(mxu=True)`: the same formula with f32
    matrix products) and against the f32 test's kernel on the same pack: the
    same found on >= 99% of rays and rows on >= 98% of the both-found
    closest rays, every ray where they differ a near tie
    (`chip_smoke.near_ties`); counted in MXU_LAUNCHES (and BF16_LAUNCHES on a
    bf16 pack). Triangle leaves take the f32 test and its count."""
    import chip_smoke
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    bvh, o, d, t_max, is_any = _variant_case("cone", mode, dev)
    if pack == "bf16":
        bvh = cstream.pack_prim_hbm(bvh, "cone", torch.bfloat16)
    kw = dict(any_hit=mode == "any", is_any=is_any)
    mxu, bf = cstream.MXU_LAUNCHES, cstream.BF16_LAUNCHES
    t1, r1, f1 = cstream.traverse_stream(o, d, t_max, bvh, "cone", mxu=True, **kw)
    assert (cstream.MXU_LAUNCHES, cstream.BF16_LAUNCHES) == (mxu + 1, bf + (pack == "bf16"))
    closest = torch.full_like(f1, mode == "closest") if is_any is None else ~is_any
    for t0, r0, f0 in (cstream.traverse_stream_ref(o, d, t_max, bvh, "cone", mxu=True, **kw),
                       cstream.traverse_stream(o, d, t_max, bvh, "cone", **kw)):
        torch.cuda.synchronize()
        both = f0 & f1 & closest
        assert (f0 == f1).double().mean() >= 0.99 and f0.any() and not f0.all()
        assert not both.any() or (r0 == r1)[both].double().mean() >= 0.98
        r1c = torch.where(~closest & f0 & f1, r0, r1)  # an any hit's row is any accepted row
        assert chip_smoke.near_ties(o, d, bvh, (r0, f0), (r1c, f1))["tie"].all()  # TIE_REL
    assert not f1[t_max == 0].any() and (t1[f1 & ~closest] == 0).all()
    tri, _, _, tri_t, _ = _variant_case("tri", "closest", dev)
    launches = cstream.KERNEL_LAUNCHES
    got = cstream.traverse_stream(o, d, tri_t, tri, "tri", mxu=True)
    want = cstream.traverse_stream(o, d, tri_t, tri, "tri")
    assert cstream.KERNEL_LAUNCHES == launches + 2 and cstream.MXU_LAUNCHES == mxu + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _tile_case(case, dev):
    """(bvh, kind, o, d, t_max) on `dev` for one edge case of the leaf-tile
    kernels; the BVH is two-level except for `tri_leaf_13`."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import types

    g = torch.Generator().manual_seed(5)
    n = 4096
    o = (torch.rand((n, 3), generator=g) * 3 - 1.5)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    if case == "tri_leaf_13":  # leaf_k neither a multiple of 32 nor of 4 floats a block
        v = torch.rand((3000, 3, 3), generator=g) * 2 - 1
        v[:, 1:] = v[:, :1] + 0.1 * v[:, 1:]
        soup = types.make_triangle_pack(v[:, 0].numpy(), v[:, 1].numpy(), v[:, 2].numpy())
        scene, _ = builtins.cornell_box(resolution=(4, 4), device="cpu")
        scene = traverse.attach_bvh(dataclasses.replace(scene, tris=soup), leaf_size=13,
                                    min_prims=1)
        bvh, kind = scene.tri_bvh, "tri"
    else:
        scene, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=3000, device="cpu")
        if case == "ties":  # every cone twice: equal t in different leaves
            scene = dataclasses.replace(scene, cones=types.ConePack(**{
                f.name: torch.cat([getattr(scene.cones, f.name)] * 2)
                for f in dataclasses.fields(types.ConePack)}))
        fanout = {"fanout_2": 2, "fanout_256": 256}.get(case, 16)
        bvh, kind = traverse.attach_bvh(scene, leaf_size=24, fanout=fanout).cone_bvh, "cone"
        assert bvh.fanout == fanout < bvh.n_leaves
        if case == "one_leaf":  # every ray of a tile enters the same leaves
            o = torch.tensor([0.0, 0.0, 1.6]) + 1e-3 * o
            d = torch.nn.functional.normalize(torch.tensor([0.0, 0.0, -1.0]) + 0.01 * d,
                                              dim=-1)
    t_max = torch.full((n,), 3.4e38)
    t_max[::9] = 0.0
    return bvh, kind, o.to(dev), d.to(dev), t_max.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["tri_leaf_13", "fanout_2", "fanout_256", "ties", "one_leaf",
                                  "shuffled"])
def test_tile_kernels_edge_cases_on_the_card(case, any_hit):
    """K3 (two-level BVH) and K2 (the same BVH flat) against the twin on
    the leaf-tile kernels' edge cases: found and t bit for bit, rows on
    closest hits, dead rays (t_max = 0) missed; and the same results on the
    entry-morton sorted and on shuffled ray orders."""
    import dataclasses

    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse
    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    bvh, kind, o, d, t_max = _tile_case(case, dev)
    bvh = types._to(bvh, dev)
    if any_hit:
        t_max = torch.where(t_max > 0, 1.0, 0.0)
    want = ctraverse.traverse_ref(o, d, t_max, bvh, kind, any_hit=any_hit)
    assert want[2].any() and not want[2].all() and not want[2][::9].any()
    fns = [lambda *a: ctraverse.traverse(*a[:3], dataclasses.replace(bvh, fanout=0), kind,
                                         any_hit=any_hit)]
    if traverse._two_level(bvh):
        fns.append(lambda *a: cstream.traverse_stream(*a, bvh, kind, any_hit=any_hit))
    orders = [None]
    if case == "shuffled":
        perm, _ = traverse._entry_morton_perms(o, d, t_max, bvh)
        orders = [perm, torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(6))
                  .to(dev)]
    for fn in fns:
        for p in orders:
            if p is None:
                got = fn(o, d, t_max)
            else:
                inv = torch.empty_like(p)
                inv[p] = torch.arange(p.shape[0], device=dev)
                got = [x[inv] for x in fn(o[p].contiguous(), d[p].contiguous(),
                                          t_max[p].contiguous())]
            torch.cuda.synchronize()
            assert torch.equal(got[2], want[2]) and torch.equal(got[0], want[0])
            if not any_hit:
                assert torch.equal(got[1], want[1])
    if case == "ties" and not any_hit:  # the winner's copy lies in another leaf
        n = bvh.perm.shape[0]
        where = torch.empty(n, dtype=torch.long, device=dev)
        valid = bvh.perm >= 0
        where[bvh.perm[valid].long()] = torch.arange(n, device=dev)[valid]
        half = int(valid.sum()) // 2
        orig = bvh.perm[want[1][want[2]].long()].long()
        other = where[(orig + half) % (2 * half)]
        assert (other // bvh.leaf_size != want[1][want[2]].long() // bvh.leaf_size).any()


def _brute_case(case):
    """(pack, kind, o, d, t_max) on the CPU for one edge case of K5."""
    import dataclasses

    from test_torch_bruteforce import _case

    from ba_pathtracing_fur_torch.scene import types

    g = torch.Generator().manual_seed(3)
    if case in ("edges", "grazing", "axial", "shadow", "walls", "ties"):
        name = {"edges": "scalp_edges", "grazing": "fur_grazing", "axial": "fur_axial",
                "shadow": "scalp_shadow", "walls": "cornell_walls",
                "ties": "fur_duplicated"}[case]
        return _case(name)
    if case == "cone":
        scene, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=300, device="cpu")
        pack, kind = scene.cones, "cone"
    else:
        scene, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=10, device="cpu")
        pack, kind = scene.tris, "tri"
    if case == "p_1":  # one primitive
        pack = types.TrianglePack(**{f.name: getattr(pack, f.name)[300:301]
                                     for f in dataclasses.fields(types.TrianglePack)})
    if case == "p_ragged":  # not a multiple of the chunk of boxes
        pack = types.TrianglePack(**{f.name: getattr(pack, f.name)[:300]
                                     for f in dataclasses.fields(types.TrianglePack)})
    n = 5000
    o = torch.rand((n, 3), generator=g) * 2 - 1 + torch.tensor([0.0, 0.6 if kind == "cone"
                                                                  else 0.0, 0.0])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    if case == "p_1":  # aimed at the triangle
        d = torch.nn.functional.normalize(pack.v0 * 0.9 + pack.v1 * 0.05 + pack.v2 * 0.05 - o
                                          + 0.05 * d, dim=-1)
    if case == "coherent":  # tiles of one direction sign, one mixed tile
        o = torch.tensor([0.0, 0.1, 2.0]) + 0.01 * o
        d = torch.nn.functional.normalize(torch.tensor([0.0, 0.0, -1.0]) + 0.2 * d, dim=-1)
        d[128:256] = torch.nn.functional.normalize(torch.randn((128, 3), generator=g), dim=-1)
    t_max = torch.full((n,), 3.4e38)
    t_max[::13] = 0.0
    if case == "all_dead":
        t_max[:] = 0.0
    return pack, kind, o, d, t_max


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tri", "cone", "p_1", "p_ragged", "all_dead", "coherent",
                                  "ties", "edges", "grazing", "axial", "shadow", "walls",
                                  "shuffled"])
def test_bruteforce_kernel_matches_plain_on_the_card(kind):
    """K5 against its twin on its edge cases (a pack of one primitive, one
    not a multiple of the box chunk, all rays dead, coherent tiles and a
    tile of mixed direction signs, duplicated cones tied, rays at triangle
    edges and vertices, grazing cone silhouettes, rays nearly along cone
    axes, shadow rays with a finite
    t_max, the flat Cornell walls from inside, and a shuffled order against
    the sorted one): t and index bit for bit, dead rays missed."""
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect
    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    pack, kind_, o, d, t_max = _brute_case("edges" if kind == "shuffled" else kind)
    tables = cisect.brute_tables(types._to(pack, dev), kind_)
    o, d, t_max = o.to(dev), d.to(dev), t_max.to(dev)
    launches = cisect.TRI_LAUNCHES + cisect.CONE_LAUNCHES
    t1, i1 = cisect.closest(o, d, t_max, tables, kind_)
    assert cisect.TRI_LAUNCHES + cisect.CONE_LAUNCHES == launches + 1
    t0, i0 = cisect.closest_ref(o, d, t_max, tables, kind_)
    torch.cuda.synchronize()
    assert torch.equal(t0, t1) and torch.equal(i0, i1)
    assert (i1[t_max <= 0] == -1).all()
    assert (i1 >= 0).any() == (kind != "all_dead")
    if kind == "shuffled":  # a morton order and a random one give the same rays' results
        from ba_pathtracing_fur_torch.ops import bvh

        lo, hi = o.amin(0), o.amax(0)
        for perm in (torch.argsort(bvh.morton_codes(o, lo, hi)),
                     torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(6))
                     .to(dev)):
            t2, i2 = cisect.closest(o[perm].contiguous(), d[perm].contiguous(),
                                    t_max[perm].contiguous(), tables, kind_)
            torch.cuda.synchronize()
            assert torch.equal(t2, t1[perm]) and torch.equal(i2, i1[perm])


@pytest.mark.cuda
def test_full_bounce_division_free_rows_on_the_card():
    """K4's division-free row tests on their edges, against the plain
    version under the per-field gate: back faces, rays nearly parallel to a
    wall (det near 1.19e-7), hits at t near T_MIN, and shadow rays that end
    on the ceiling (a point light in its plane)."""
    import dataclasses

    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, cam = builtins.cornell_box(resolution=(64, 64), device="cpu")
    scene = types.to_device(dataclasses.replace(scene, lights=types.make_light_pack([
        dict(kind="point", color=(4.0, 4.0, 4.0), position=(0.3, 1.0, 0.2), radius=0.0)])),
        dev)
    _, cam = builtins.cornell_box(resolution=(64, 64), device=dev)
    cfg = pt.RenderConfig(**KW)
    n = 64 * 64
    g = torch.Generator().manual_seed(8)
    u = torch.rand((n, 3), generator=g) * 1.8 - 0.9
    q = n // 4
    o, dirs = u.clone(), torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    o[:q] = u[:q] * torch.tensor([1.0, 1.0, 0.0]) + torch.tensor([0.0, 0.0, -3.0])  # behind
    dirs[:q] = torch.nn.functional.normalize(torch.tensor([0.0, 0.0, 1.0]) + 0.1 * dirs[:q])
    tilt = torch.linspace(1e-8, 6e-8, q)  # nearly parallel to the floor: |det| ~ 4 tilt
    dirs[q:2 * q] = torch.nn.functional.normalize(
        torch.stack([torch.ones(q), -tilt, 0.3 * u[q:2 * q, 2]], -1), dim=-1)
    o[q:2 * q, 1] = -1.0 + 1e-6
    o[2 * q:3 * q, 1] = -1.0 + torch.linspace(0.5e-4, 2e-4, q)  # t near T_MIN
    dirs[2 * q:3 * q] = torch.tensor([0.0, -1.0, 0.0])
    state, keys = pt.camera_wavefront(cam, torch.arange(n, device=dev), rng.key(0, dev), [0],
                                      cfg)
    state = dataclasses.replace(state, origin=o.to(dev), direction=dirs.to(dev))
    tables = pt.BounceTables.of(scene)
    for bounce in range(3):
        kw = pt.full_bounce_inputs(state, scene, keys, bounce, cfg, tables)
        got = cshade.shade_bounce_full(**kw)
        want = cshade.shade_bounce_full_ref(**kw)
        for f, a in want.items():
            a, b = a.double().reshape(len(a), -1), got[f].double().reshape(len(a), -1)
            bad = ((a - b).abs() > 1e-4 + 1e-4 * a.abs()).any(-1).double().mean().item()
            assert bad < 0.02, f"bounce {bounce} {f}: {bad:.4f} of rows mismatched"
        state = pt.RayState(**want)


@pytest.mark.cuda
def test_large_bvh_less_pack_runs_k5_on_the_card():
    """On the card a BVH-less pack of 2^24 or more ray-primitive pairs goes
    through the brute-force kernel (K5): closest and any hit launch it and
    agree with the CPU twin's dispatch."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect
    from ba_pathtracing_fur_torch.scene import types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=2000, device=dev)
    r = -(-(1 << 24) // scene.cones.count)
    g = torch.Generator().manual_seed(4)
    o = (torch.rand((r, 3), generator=g) - 0.5) * torch.tensor([1.0, 0.0, 1.0]) \
        + torch.tensor([0.0, 0.3, 0.0])
    d = torch.nn.functional.normalize(torch.randn((r, 3), generator=g) * 0.3
                                      + torch.tensor([0.0, -1.0, 0.0]), dim=-1)
    launches = cisect.CONE_LAUNCHES
    hit = traverse.closest_hit(o.to(dev), d.to(dev), scene)
    tables = cisect.tables_of(scene.cones, "cone")  # made at the first call, then kept
    blocked = traverse.any_hit(o.to(dev), d.to(dev), scene, 0.2)
    assert cisect.CONE_LAUNCHES == launches + 2 and cisect.tables_of(scene.cones, "cone") is tables
    cpu_scene = types.to_device(scene, "cpu")
    want = traverse.closest_hit(o, d, cpu_scene)
    assert torch.equal(hit.prim_id.cpu(), want.prim_id) and hit.valid.any()
    assert torch.equal(blocked.cpu(), traverse.any_hit(o, d, cpu_scene, 0.2))


def _sah_terrain(dev, n_tris=20_000, res=(64, 64)):
    """A SAH terrain on `dev` with config 3's 200-row leaves (forced: the
    auto leaf size of 20,000 triangles is 160) and its camera rays."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins as tb

    scene, cam = tb.tri_terrain(resolution=res, n_tris=n_tris, device=dev)
    scene = traverse.attach_bvh(scene, method="sah", leaf_size=200)
    return scene, cam


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_on_sah_terrain_leaves_on_the_card(any_hit):
    """K2 on config 3's kind of BVH (a SAH terrain, 200-row triangle
    leaves) against its twin: camera rays and rays from the terrain toward
    the sky (the NEE rays' kind), found and t bit for bit, rows on closest
    hits."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, cam = _sah_terrain(dev)
    bvh = scene.tri_bvh
    assert (bvh.leaf_size, bvh.fanout) == (200, 0)
    cfg = pt.RenderConfig(depth=1, spp=1, compact=False)
    state, _ = pt.camera_wavefront(cam, torch.arange(64 * 64, device=dev), rng.key(0, dev),
                                   [0], cfg)
    o, d = state.origin, state.direction
    if any_hit:
        hit = traverse.closest_hit(o, d, scene)
        g = torch.Generator().manual_seed(1)
        d = torch.nn.functional.normalize(torch.randn(o.shape, generator=g), dim=-1).to(dev)
        o = torch.where(hit.valid[:, None], hit.position + 1e-4 * hit.normal, o)
    t_max = torch.full((o.shape[0],), 2.0 if any_hit else 3.4e38, device=dev)
    launches = ctraverse.KERNEL_LAUNCHES
    t1, r1, f1 = ctraverse.traverse(o, d, t_max, bvh, "tri", any_hit=any_hit)
    assert ctraverse.KERNEL_LAUNCHES == launches + 1
    t0, r0, f0 = ctraverse.traverse_ref(o, d, t_max, bvh, "tri", any_hit=any_hit)
    torch.cuda.synchronize()
    assert torch.equal(f0, f1) and torch.equal(t0, t1) and f0.any() and not f0.all()
    if not any_hit:
        assert torch.equal(r0, r1)


@pytest.mark.cuda
def test_textured_gather_on_the_card_equals_cpu():
    """gather_materials with the bilinear fetch on the card equals the CPU
    (ids -1 and M included, uv wrapping)."""
    from ba_pathtracing_fur_torch.models import bsdf
    from ba_pathtracing_fur_torch.scene import builtins as tb, types

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    scene, _ = tb.tri_terrain(resolution=(4, 4), n_tris=200, device="cpu")
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(-1, scene.materials.count + 1, (8192,), generator=g, dtype=torch.int32)
    uv = torch.rand((8192, 2), generator=g) * 6 - 3
    want = bsdf.gather_materials(scene.materials, ids, uv, scene.textures, scene.tex_slots)
    gs = types.to_device(scene, "cuda")
    got = bsdf.gather_materials(gs.materials, ids.cuda(), uv.cuda(), gs.textures, gs.tex_slots)
    for f in ("diffuse", "specular", "roughness", "bsdf_id"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f), rtol=0, atol=1e-6)
    assert not torch.equal(want.diffuse, bsdf.gather_materials(scene.materials, ids).diffuse)


@pytest.mark.cuda
def test_unfused_render_kernels_match_plain_on_the_card():
    """The unfused bounce on the card (K2 on a SAH terrain's triangle
    leaves, closest and NEE any hit, the rest in torch) against the same
    render through K2's twin on the card, under the image gate."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    scene, cam = _sah_terrain(dev)
    cfg = pt.RenderConfig(depth=4, spp=2, compact=False)
    launches, refs = ctraverse.KERNEL_LAUNCHES, ctraverse.REF_CALLS
    got = pt.render_image(scene, cam, rng.key(0, dev), cfg)
    assert ctraverse.KERNEL_LAUNCHES - launches == 2 * cfg.spp * cfg.depth
    assert ctraverse.REF_CALLS == refs
    kernel = ctraverse.traverse
    ctraverse.traverse = ctraverse.traverse_ref
    try:
        want = pt.render_image(scene, cam, rng.key(0, dev), cfg)
    finally:
        ctraverse.traverse = kernel
    d = (got - want).abs()
    assert torch.isfinite(got).all() and got.max() > 0.01
    assert d.mean() < 5e-3 and (d.amax(-1) > 1e-3).double().mean() <= 0.02
