"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `ba_pathtracing_fur_torch/csrc` (one
nvcc per source, started together), checks each against its plain torch
version on the card, drives the main paths through the entry points a user
calls (`scene/builtins` -> `ops/traverse.attach_bvh` -> `models/pathtracer.
render_image`) and checks the images:

  * the Cornell path (the JAX package's bench configs 0 and 2) through the
    full-bounce kernel (K4), timed and bounded on config-0 bounces 0-3 and
    config-2 bounce 0;
  * the fur patch (bench config 4: 512x512, 45,000 cones, depth 4, spp 8,
    no cut) through the traversal kernel (cone BVH) and the shade kernel
    (K1), which draws its uniforms from each ray's key and reads its
    material rows itself: its draws are held to the torch threefry bit for
    bit, the kernel to its plain version on bounces 0-3, timed and bounded
    per shading branch;
  * a Cornell box with a triangle BVH through the traversal kernel's
    triangle leaves and the shade kernel, gated against the full-bounce
    render of the same box; the traversal is held against its plain
    version, timed and bounded on this box's camera wavefront and shadow
    rays. A soup of random triangles checks the triangle leaves on a deeper
    BVH; its numbers go under `soup` in the traverse_tri entry;
  * the hair ball (bench config 5: 1,000,000 fibers = 9,000,000 cones on a
    768-triangle scalp, 1024x1024, depth 4; spp cut from 16 to 4),
    generated and its BVH built on the card, through the streaming
    traversal kernel (K3, two-level cone BVH), the brute-force kernel (K5,
    the BVH-less scalp) and the shade kernel (held to its plain version
    and its draws bit for bit on bounces 0-1, timed). K3 is held against its twin
    on ray subsets and against the heap-walk kernel (K2) on whole
    wavefronts, K5 against its twin on the camera and bounce-1 wavefronts
    and the bounce-0 shadow rays, each sorted and unsorted; both are timed
    and bounded (K5's bound from the exact tests these rays need, beside
    the TPU kernel's all-pairs work; its cull's margin measured on every
    wavefront). K5's cone variant runs on the fur patch without a BVH (its
    camera and bounce-1 wavefronts held whole, timed and bounded, then a
    render gated against the BVH render of the same patch),
    and a mid-size hair ball renders through the kernels and through the
    plain versions under the image gate.

The traversal kernels (K2, K3) run, as on the main path, on rays sorted by
the entry-morton key (`ops/traverse._entry_morton_perms`): each is held
against its plain version on the sorted rays (found, t and closest-hit rows
exact) and against itself on the unsorted rays, and timed on both; configs
4 and 5 are also rendered and traced once without the sort, which gives the
launches the sort adds a sample.

It exits non-zero, printing no result, when there is no CUDA device, when
any phase fails, or when the package is missing. The last line of its
output is `{"ok": true, "device": {...}}`; the line before it lists each
kernel with its launches on the main path, its error against the plain
version, its time beside the plain version's and its bound; the line before
that is the card's name and power limit. Before those lines it prints the
render times (rays/s) through the kernels and through the plain versions,
the BVH build times, the per-kernel work counts behind the bounds, and a
torch.profiler breakdown of one config-0, config-4 and config-5 sample. The
images go to `smoke_out/smoke_config0.png`, `smoke_out/smoke_fur_patch.png`
and `smoke_out/smoke_hair_ball.png` (git-ignored).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Config 0: the reference Demo's default workload (Demo/main.cpp:209-210), Cornell
# diffuse at 1280x720, depth 5; spp cut from 100 to SPP for the smoke run.
CONFIG0 = dict(variant="diffuse", res=(1280, 720), depth=5, mis=False)
# Config 2: glossy Cornell 512^2, depth 4, MIS + Russian roulette.
CONFIG2 = dict(variant="glossy", res=(512, 512), depth=4, mis=True)
SPP = 16
# Config 4: the fur patch (bench.py:313-317, bench_fur), the reference's
# Fur_SmallSkinPatch workload: 2 x 2500 fibers x 9 cones, median cone BVH,
# 512^2, depth 4, spp 8 -- bench.py's own setting, no cut.
CONFIG4 = dict(res=(512, 512), fibers_per_face=2500, depth=4, spp=8)
# The triangle-BVH path: Cornell diffuse 512^2 with a BVH over its 34
# triangles (attach_bvh min_prims=1), depth 4; spp cut to 4.
TRI_BVH = dict(variant="diffuse", res=(512, 512), depth=4, mis=False, spp=4)
# K2 on its triangle leaves: a soup of random triangles, rays into it.
TRI_SOUP, SOUP_RAYS = 20_000, 262_144
# Config 5: the hair ball (bench.py:318-324, bench_fur): 1,000,000 fibers x
# 9 cones on a 768-triangle UV-sphere scalp, generated on the card, median
# cone BVH (32,768 leaves x 280, fanout 64), 1024^2, depth 4; spp cut from
# 16 to 4.
CONFIG5 = dict(res=(1024, 1024), n_fibers=1_000_000, depth=4, spp=4, bvh=(32768, 280, 64))
# K3's twin is a brute force over 9.2M rows: it runs on TWIN_RAYS rays spread
# over each wavefront; K3's work count (for its bound) on WORK_RAYS, scaled.
TWIN_RAYS, WORK_RAYS = 2048, 65_536
# K5's cone variant: config 4's fur patch without a BVH; its work count (for
# its bound) on K5_CONE_TILES tiles of each wavefront, scaled.
K5_CONE_TILES = 256
# Config 3: the textured terrain (bench.py:150-182): tri_terrain at 512^2
# with 100,000 triangles (99,458 of its 223^2 grid), a SAH BVH (512 leaves x
# 200 rows, flat: K2's triangle leaves), depth 4, spp 16, ray_chunk 2048 --
# bench.py's own setting, no cut -- through the unfused trace_bounce
# (fused_shading at its default, False).
CONFIG3 = dict(res=(512, 512), n_tris=100_000, depth=4, spp=16, ray_chunk=2048,
               bvh=(512, 200, 0))
# The kernels-vs-plain image gate on a small terrain (K2's twin brute-forces
# every row, so the full terrain is out of its reach).
SMALL_TERRAIN = dict(res=(128, 128), n_tris=20_000, depth=4, spp=2)
# The unfused bounce against the fused one on the card: the triangle-BVH
# Cornell and the fur patch, each rendered both ways with the same streams.
UNFUSED_VS_FUSED = dict(res=(256, 256), depth=4, spp=2)
# The kernel-vs-plain image gate on a mid-size hair ball (two-level BVH).
# Depth cut from 4 to 3 to make room for config 3's phases: its plain render
# is the slowest gate of the run.
MID_HAIRBALL = dict(res=(256, 256), n_fibers=20_000, depth=3, spp=1)
TIMED_REPS = 3
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3;
# INT32 (the Hopper architecture white paper), for the shade kernel's threefry.
PEAK_FP32_FLOPS, PEAK_BYTES, PEAK_INT32_OPS = 67e12, 3.35e12, 33.5e12
# The full-bounce kernel's shading flops per ray, a rough count on
# shade_core.cuh: its bound is set by the triangle rows (config 0) or the
# bytes. The shade kernel's bound counts its branches (`cshade.work_ref`).
FULL_BOUNCE_SHADE_FLOPS = 400
# flops of one triangle row of full_bounce.cu's division-free test: the
# Möller-Trumbore numerators 45, |det| 1, sign flips 3, acceptance 7, and the
# cross-multiplied compare with the best row 3 (closest hit) or the scaled
# t_max compare 2 (shadow ray)
TRI_ROW_FLOPS, SHADOW_ROW_FLOPS = 55, 54
# Per-field gate of tests/test_fused_shade.py::test_fused_single_bounce_exact.
FIELD_ATOL, FIELD_RTOL, FIELD_MAX_FRAC = 1e-4, 1e-4, 0.02
# Image gate of tests/test_fused_shade.py::_compare.
IMG_MEAN, IMG_FLIP, IMG_FLIP_FRAC = 5e-3, 1e-3, 0.02
FIELDS = ("origin", "direction", "radiance", "color", "flags", "theta_i", "prev_pdf")
SHADE_FIELDS = FIELDS + ("shadow_tmax", "direct_rgb")
OUT_DIR = Path("smoke_out")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_bounces():
    """Route every kernel of a bounce through its plain torch version, on
    any device."""
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, shade as cshade, \
        stream as cstream, traverse as ctraverse

    swaps = ((cshade, "shade_bounce_full", cshade.shade_bounce_full_ref),
             (cshade, "shade_bounce", cshade.shade_bounce_ref),
             (ctraverse, "traverse", ctraverse.traverse_ref),
             (cstream, "traverse_stream", cstream.traverse_stream_ref),
             (cisect, "closest", cisect.closest_ref))
    kernels_fns = [getattr(m, name) for m, name, _ in swaps]
    for m, name, ref in swaps:
        setattr(m, name, ref)
    try:
        yield
    finally:
        for (m, name, _), fn in zip(swaps, kernels_fns):
            setattr(m, name, fn)


@contextlib.contextmanager
def unsorted_rays():
    """Run closest_hit / any_hit without the entry-morton ray sort."""
    from ba_pathtracing_fur_torch.ops import traverse

    traverse.SORT_RAYS = False
    try:
        yield
    finally:
        traverse.SORT_RAYS = True


def reset_counts():
    """Every kernel wrapper's launch and plain-call counts to 0."""
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, shade as cshade, \
        stream as cstream, traverse as ctraverse

    cshade.KERNEL_LAUNCHES = cshade.REF_CALLS = 0
    cshade.SHADE_LAUNCHES = cshade.SHADE_REF_CALLS = 0
    ctraverse.KERNEL_LAUNCHES = ctraverse.REF_CALLS = 0
    cstream.KERNEL_LAUNCHES = cstream.REF_CALLS = 0
    cisect.TRI_LAUNCHES = cisect.CONE_LAUNCHES = cisect.REF_CALLS = 0


def read_counts() -> dict:
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, shade as cshade, \
        stream as cstream, traverse as ctraverse

    return dict(full_bounce=cshade.KERNEL_LAUNCHES, full_bounce_ref=cshade.REF_CALLS,
                shade=cshade.SHADE_LAUNCHES, shade_ref=cshade.SHADE_REF_CALLS,
                traverse=ctraverse.KERNEL_LAUNCHES, traverse_ref=ctraverse.REF_CALLS,
                stream=cstream.KERNEL_LAUNCHES, stream_ref=cstream.REF_CALLS,
                bruteforce_tri=cisect.TRI_LAUNCHES, bruteforce_cone=cisect.CONE_LAUNCHES,
                bruteforce_ref=cisect.REF_CALLS)


def check_counts(counts: dict, what: str, **want) -> None:
    """Fail unless each count equals `want` (0 where not named): the main
    path ran on exactly these kernels and no plain version."""
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: the main path did not run on the kernels alone: "
                             f"{counts}, expected {want}")


def timed(fn, reps: int) -> float:
    """Milliseconds per call of `fn` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def dev_us(e) -> float:
    """Device microseconds of a torch.profiler key_averages() entry."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def bound(flops: float, n_bytes: float, int_ops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the FP32
    operations over the FP32 peak, the integer operations over the INT32
    peak and the bytes over the memory rate."""
    t_ops = max(flops / PEAK_FP32_FLOPS, int_ops / PEAK_INT32_OPS) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, int_ops=int_ops, bytes=n_bytes)


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def row_mismatch(a: torch.Tensor, b: torch.Tensor, rel: bool = False):
    """(fraction of rows off by more than atol + rtol*|a|, max |a - b|[,
    max |a - b| / max(|a|, 1)])."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    d = (a - b).abs()
    bad = (d > FIELD_ATOL + FIELD_RTOL * a.abs()).any(-1)
    out = (bad.double().mean().item(), d.max().item() if d.numel() else 0.0)
    if rel:
        out += ((d / a.abs().clamp(min=1.0)).max().item() if d.numel() else 0.0,)
    return out


def image_gate(a: np.ndarray, b: np.ndarray, what: str) -> dict:
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    mean, flips = float(d.mean()), float(np.mean(d.max(-1) > IMG_FLIP))
    log(f"{what}: mean |diff| {mean:.3e} (< {IMG_MEAN}), flipped pixels {flips:.4f} "
        f"(<= {IMG_FLIP_FRAC})")
    if not (mean < IMG_MEAN and flips <= IMG_FLIP_FRAC):
        raise AssertionError(f"{what}: image gate failed")
    return dict(mean=mean, flips=flips)


def check_image(img: torch.Tensor, shape, what: str) -> np.ndarray:
    a = img.cpu().numpy()
    if a.shape != shape or not np.all(np.isfinite(a)) or not a.max() > 0.01 \
            or np.ptp(a.reshape(-1, 3), axis=0).max() == 0.0:
        raise AssertionError(f"{what}: bad image shape={a.shape} finite={np.isfinite(a).all()} "
                             f"max={a.max()}")
    return a


def render_cfg(c, spp):
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    return pt.RenderConfig(depth=c["depth"], spp=spp, compact=False, fused_shading=True,
                           mis=c["mis"], rr=c["mis"])


def phase_kernel_vs_plain(dev) -> dict:
    """Each bounce 0-3 from a camera wavefront: kernel vs plain, per field."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins

    worst_frac, worst_abs = 0.0, 0.0
    cases = (("config0 diffuse 1280x720", dict(CONFIG0)),
             ("diffuse 256x256", dict(CONFIG0, res=(256, 256))),
             ("glossy 512x512 mis+rr", dict(CONFIG2)))
    for name, c in cases:
        scene, cam = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
        cfg = render_cfg(c, 1)
        tables = pt.BounceTables.of(scene)
        ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
        state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
        for bounce in range(4):
            kw = pt.full_bounce_inputs(state, scene, keys, bounce, cfg, tables)
            got = cshade.shade_bounce_full(**kw)
            ref = cshade.shade_bounce_full_ref(**kw)
            torch.cuda.synchronize()
            for f in FIELDS:
                frac, mx = row_mismatch(ref[f], got[f])
                worst_frac, worst_abs = max(worst_frac, frac), max(worst_abs, mx)
                if frac >= FIELD_MAX_FRAC:
                    raise AssertionError(f"{name} bounce {bounce} {f}: {frac:.4f} of rows "
                                         f"mismatched (max |diff| {mx:.3e})")
            log(f"kernel vs plain {name} bounce {bounce}: ok, "
                f"alive {int((ref['radiance'] != 0).any(-1).sum())}")
            state = pt.RayState(**ref)
    log(f"kernel vs plain: worst mismatched-row fraction {worst_frac:.5f} (gate: below "
        f"{FIELD_MAX_FRAC} of rows off by more than {FIELD_ATOL} + {FIELD_RTOL}*|plain|), "
        f"max |diff| {worst_abs:.3e}")
    return dict(max_abs_err=worst_abs, mismatch_frac=worst_frac)


def time_bounces(dev) -> dict:
    """Kernel time and bound of config-0 bounces 0-3 (921,600 rays, each
    wavefront from the plain version's last bounce) and of config-2 bounce
    0; the plain version's time on config-0 bounce 0."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins

    out = {}
    for name, c, bounces in (("config0", CONFIG0, 4), ("config2", CONFIG2, 1)):
        scene, cam = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
        cfg = render_cfg(c, 1)
        tables = pt.BounceTables.of(scene)
        ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
        state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
        for bounce in range(bounces):
            kw = pt.full_bounce_inputs(state, scene, keys, bounce, cfg, tables)
            res = dict(ms=timed(lambda: cshade.shade_bounce_full(**kw), 50),
                       **full_bounce_bound(kw))
            if (name, bounce) == ("config0", 0):
                res["plain_ms"] = timed(lambda: cshade.shade_bounce_full_ref(**kw), 5)
            log(f"full_bounce {name} bounce {bounce} ({ids.shape[0]} rays): kernel "
                f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms"
                + (f", plain {res['plain_ms']:.3f} ms" if "plain_ms" in res else ""))
            out[f"{name}_b{bounce}"] = res
            state = pt.RayState(**cshade.shade_bounce_full_ref(**kw))
    return out


def full_bounce_bound(kw) -> dict:
    """The full-bounce kernel's bound on these inputs: the triangle rows its
    closest hit must test (every row, for every ray that traces) at
    TRI_ROW_FLOPS and those its shadow any-hit must test (rows up to the
    first blocker, or all) at SHADOW_ROW_FLOPS, plus FULL_BOUNCE_SHADE_FLOPS;
    bytes are the per-ray state and draws read once and the new state
    written once."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    n_tris = kw["n_tris"]
    grids = []
    grid_fn = cshade.tri_grid

    def recording_grid(o, d, table, t_min, t_max):
        out = grid_fn(o, d, table, t_min, t_max)
        grids.append((out[1], t_max))
        return out

    cshade.tri_grid = recording_grid
    try:
        out = cshade.shade_bounce_full_ref(**kw)
    finally:
        cshade.tri_grid = grid_fn
    (_, cap), (shadow_valid, shadow_tmax) = grids
    tracing = int((cap > 0).sum())
    has_shadow = shadow_tmax > cshade.T_MIN
    first = torch.where(shadow_valid.any(-1), shadow_valid.int().argmax(-1) + 1, n_tris)
    shadow_rows = int(first[has_shadow].sum())
    flops = tracing * n_tris * TRI_ROW_FLOPS + shadow_rows * SHADOW_ROW_FLOPS \
        + kw["origin"].shape[0] * FULL_BOUNCE_SHADE_FLOPS
    io = [kw[k] for k in ("origin", "direction", "radiance", "color", "flags", "theta_i",
                          "prev_pdf", "u_bsdf", "u_pick", "u_light")] + list(out.values())
    res = bound(flops, nbytes(*io))
    log(f"full_bounce work: {tracing} tracing rays x {n_tris} rows + {shadow_rows} shadow "
        f"rows -> {flops:.4e} flops, {res['bytes']:.4e} bytes, bound {res['bound_ms']:.4f} "
        f"ms by {res['bound_by']}")
    return res


def render(scene, cam, key, cfg) -> torch.Tensor:
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    img = pt.render_image(scene, cam, key, cfg)
    torch.cuda.synchronize()
    return img


def phase_main_path(dev) -> dict:
    """render_image through the kernel on configs 0 and 2; counts and gates."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins
    from ba_pathtracing_fur_torch.utils import film

    launches = 0
    results = {}
    for name, c in (("config0", CONFIG0), ("config2", CONFIG2)):
        scene, cam = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
        cfg = render_cfg(c, SPP)
        key = rng.key(0, dev)
        reset_counts()
        img = render(scene, cam, key, cfg)
        n_k, n_ref = cshade.KERNEL_LAUNCHES, cshade.REF_CALLS
        log(f"{name}: KERNEL_LAUNCHES {n_k} (expected spp*depth = {SPP * c['depth']}), "
            f"REF_CALLS {n_ref}")
        if n_k != SPP * c["depth"] or n_ref != 0:
            raise AssertionError(f"{name}: the main path did not run on the kernel alone")
        launches += n_k
        w, h = c["res"]
        a = check_image(img, (h, w, 3), name)
        with plain_bounces():
            b = check_image(render(scene, cam, key, cfg), (h, w, 3), f"{name} plain")
        results[name] = image_gate(b, a, f"{name} kernel vs plain image")
        if name == "config0":
            OUT_DIR.mkdir(exist_ok=True)
            film.write_png(OUT_DIR / "smoke_config0.png", a)
            results["config0_scene"] = (scene, cam, key, cfg)
    results["launches"] = launches
    return results


def phase_small_reference(dev) -> None:
    """A small render through the kernel on the card against the plain
    version on the CPU: the port's own reference for this run."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.scene import builtins

    c = dict(CONFIG2, res=(32, 32), depth=3)
    cfg = render_cfg(c, 4)
    scene_g, cam_g = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
    scene_c, cam_c = builtins.cornell_box(resolution=c["res"], variant=c["variant"],
                                          device="cpu")
    a = render(scene_g, cam_g, rng.key(0, dev), cfg).cpu().numpy()
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    b = pt.render_image(scene_c, cam_c, rng.key(0, "cpu"), cfg).numpy()
    image_gate(b, a, "glossy 32x32 card kernel vs CPU plain")


def phase_timing(scene, cam, key, cfg, name="config0", with_plain=True) -> dict:
    """Median of TIMED_REPS renders, kernel and plain in turns."""
    w, h = cam.resolution
    rays = w * h * cfg.spp * cfg.depth
    kinds = ("kernel", "plain") if with_plain else ("kernel",)
    times = {k: [] for k in kinds}
    for rep in range(TIMED_REPS):
        for which in (kinds if rep % 2 == 0 else kinds[::-1]):
            ctx = plain_bounces() if which == "plain" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render(scene, cam, key, cfg)
                times[which].append(time.perf_counter() - t0)
    out = {}
    for which, ts in times.items():
        med = float(np.median(ts))
        out[which] = med
        out[f"{which}_reps"] = ts
        log(f"{name} render via {which}: median {med:.4f} s of {ts} "
            f"-> {rays / med:.4e} rays/s ({rays} rays: {w}x{h}, spp {cfg.spp}, "
            f"depth {cfg.depth})")
    return out


def phase_profile(scene, cam, key, cfg, name="config-0", marks=("full_bounce",)) -> dict:
    """Where one sample's time goes: device time by kernel under
    torch.profiler, against the host wall clock of the same traced run;
    `kernel_ms` / `kernel_launches` are the device milliseconds and launches
    of the kernels whose names hold each of `marks`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(cfg, spp=1)
    render(scene, cam, key, cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(scene, cam, key, cfg)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    parts, kernel_ms, kernel_launches = [], {}, {}
    for mark in marks:
        t = sum(dev_us(e) for e in kernels if mark in e.key) / 1e6
        kernel_ms[mark] = t * 1e3
        kernel_launches[mark] = sum(e.count for e in kernels if mark in e.key)
        parts.append(f"{mark} {t:.5f} s = {t / max(busy, 1e-12):.4f} of device time "
                     f"({kernel_launches[mark]} launches)")
    log(f"profile, one {name} sample (traced): wall {wall:.4f} s, device busy {busy:.4f} s "
        f"(idle share {max(0.0, 1.0 - busy / wall):.3f}), {launches} kernel launches, "
        + ", ".join(parts))
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:100]}")
    return dict(wall=wall, busy=busy, launches=launches, kernel_ms=kernel_ms,
                kernel_launches=kernel_launches)


def per_launch(prof: dict, mark: str) -> float:
    """Device milliseconds a launch of the `mark` kernels in a traced sample
    (`phase_profile`)."""
    return prof["kernel_ms"][mark] / max(prof["kernel_launches"][mark], 1)


def phase_sort_effect(scene, cam, key, cfg, name, marks) -> dict:
    """The render and one traced sample without the ray sort, beside the
    sorted ones measured before: rays/s and the launches the sort adds."""
    with unsorted_rays():
        times = phase_timing(scene, cam, key, cfg, name=f"{name} (unsorted)", with_plain=False)
        prof = phase_profile(scene, cam, key, cfg, name=f"{name} (unsorted)", marks=marks)
    return dict(times=times, profile=prof)


def fur_scene(dev):
    """Config 4 through the entry points: the fur patch on the card and its
    median cone BVH (the ground's 2 triangles stay BVH-less)."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    scene, cam = builtins.fur_patch(resolution=CONFIG4["res"],
                                    fibers_per_face=CONFIG4["fibers_per_face"], device=dev)
    n_cones = scene.cones.count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = traverse.attach_bvh(scene, method="median")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b, st = scene.cone_bvh, traverse.LAST_BUILD_STATS["cone"]
    log(f"config4: {n_cones} cones, {scene.tris.count} triangles; cone BVH "
        f"{b.n_leaves} leaves x {b.leaf_size}, packed {tuple(b.packed.shape)}, built on the "
        f"card in {build_s:.3f} s (aabb {st['aabb']:.3f}, split {st['split']:.3f}, reorder + "
        f"pack {st['reorder_pack']:.3f}, layouts {st['layouts']:.3f} s)")
    if n_cones != 2 * CONFIG4["fibers_per_face"] * 9 or b is None or scene.tri_bvh is not None:
        raise AssertionError("config4: unexpected scene")
    cfg = pt.RenderConfig(depth=CONFIG4["depth"], spp=CONFIG4["spp"], compact=False,
                          fused_shading=True)
    return scene, cam, cfg, build_s


def sorted_rays(o, d, t_max, bvh):
    """The rays in the entry-morton order closest_hit / any_hit feed the
    traversal kernels -> (o, d, t_max, perm)."""
    from ba_pathtracing_fur_torch.ops import traverse

    perm, _ = traverse._entry_morton_perms(o, d, t_max, bvh)
    return o[perm], d[perm], t_max[perm], perm


def same_unsorted(fn, rays, perm, got, any_hit, what) -> None:
    """`fn` on the unsorted rays gives `got` (its result on the sorted rays)
    ray for ray, bit for bit: found and t, and rows on closest hits (an any
    hit's row is whichever accepted row its tile met first)."""
    t, row, found = (x[perm] for x in fn(*rays))
    torch.cuda.synchronize()
    if not (torch.equal(t, got[0]) and torch.equal(found, got[2])
            and (any_hit or torch.equal(row, got[1]))):
        raise AssertionError(f"{what}: unsorted rays give another result than sorted ones")


def compare_traverse(o, d, t_max, bvh, kind, any_hit, what) -> dict:
    """K2 against its twin on the entry-morton sorted rays the main path
    feeds it: found and t bit for bit, rows on closest hits; and K2 on the
    unsorted rays equal to K2 on the sorted ones. Returns the sorted rays
    and K2's (t, row, found) on them (`hit`, which `traverse_bound` takes)."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    so, sd, st, perm = sorted_rays(o, d, t_max, bvh)
    fn = lambda a, b, c: ctraverse.traverse(a, b, c, bvh, kind, any_hit=any_hit)  # noqa: E731
    t1, r1, f1 = fn(so, sd, st)
    t0, r0, f0 = ctraverse.traverse_ref(so, sd, st, bvh, kind, any_hit=any_hit)
    torch.cuda.synchronize()
    found_mis, t_mis = int((f0 != f1).sum()), int((t0 != t1).sum())
    row_mis = 0 if any_hit else int((r0 != r1).sum())
    log(f"traverse {kind} {'any' if any_hit else 'closest'} hit vs plain, {what} (sorted): "
        f"{o.shape[0]} rays, found {int(f0.sum())}, found/t/row mismatches {found_mis}/"
        f"{t_mis}/{row_mis}")
    if found_mis or t_mis or row_mis:
        raise AssertionError(f"traverse {kind} {what}: kernel disagrees with plain")
    same_unsorted(fn, (o, d, t_max), perm, (t1, r1, f1), any_hit, f"traverse {kind} {what}")
    return dict(found_mismatches=found_mis, t_mismatches=t_mis, row_mismatches=row_mis,
                max_abs_err=float((t0 - t1).abs().max()), sorted=(so, sd, st),
                hit=(t1, r1, f1))


def traverse_bound(o, d, t_max, bvh, kind, any_hit, hit=None) -> dict:
    """The traversal's bound on these rays: the tests `work_ref` counts;
    the rays and boxes read once, the leaves those tests enter read once,
    (t, row, found) written once. `hit`: these rays' closest (t, row, found)
    where already known (work_ref's brute force is skipped)."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    w = ctraverse.work_ref(o, d, t_max, bvh, kind, any_hit=any_hit, hit=hit)
    n_bytes = nbytes(o, d, t_max, bvh.bmin, bvh.bmax) + w["leaf_bytes"] + o.shape[0] * 9
    res = bound(w["flops"], n_bytes)
    log(f"traverse {kind} {'any' if any_hit else 'closest'} work: {w['rays']} rays, "
        f"{w['box_tests']} box tests, {w['leaf_row_tests']} leaf-row tests, "
        f"{w['leaves_entered']} of {bvh.n_leaves} leaves entered -> {w['flops']:.4e} flops, "
        f"{n_bytes:.4e} bytes, bound {res['bound_ms']:.4f} ms by {res['bound_by']}")
    return res


def shade_bound(kw, got, what) -> dict:
    """The shade kernel's bound on these inputs (`cshade.work_ref`): the
    FP32 operations of the branches these rays take, counted on
    shade_core.cuh, the integer operations of the draws those branches
    read at the INT32 rate, the inputs these rays need (the hit's fields,
    key and material id only where the branch reads them) and the tables
    read once and the outputs written once. Beside it, the byte bound of
    every per-ray input of every ray, and of the interface before the
    kernel drew and gathered itself."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    w = cshade.work_ref(kw, got)
    res = bound(w["flops"], w["bytes"], w["int_ops"])
    r = kw["origin"].shape[0]
    old_ms, all_ms = (w[k] / PEAK_BYTES * 1e3 for k in ("old_bytes", "all_bytes"))
    log(f"shade work, {what}: {r} rays by branch {w['classes']}; {w['flops']:.4e} flops "
        f"({w['flops'] / r:.1f} a ray), {w['threefry']} threefry calls and {w['draws']} "
        f"draws = {w['int_ops']:.4e} integer ops, {w['bytes']:.4e} bytes -> bound "
        f"{res['bound_ms']:.4f} ms by {res['bound_by']}; every input of every ray: "
        f"{w['all_bytes']:.4e} bytes = {all_ms:.4f} ms; the drawn-and-gathered interface "
        f"before: {w['old_bytes']:.4e} bytes = {old_ms:.4f} ms")
    return dict(res, all_bytes_ms=all_ms, old_bound_ms=old_ms, classes=w["classes"])


def check_draws(keys, bounce, what) -> None:
    """The shade kernel's draws from every ray's key equal the torch
    threefry's bit for bit (tags 0-4)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    got = cshade.kernel_draws(keys, bounce, 5)
    want = rng.bounce_uniforms(keys, bounce, 5, 2)
    torch.cuda.synchronize()
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    log(f"shade draws, {what}: {keys.shape[0]} rays x 5 tags x 2, {bad} differ from "
        f"rng.bounce_uniforms")
    if bad:
        raise AssertionError(f"shade draws {what}: the kernel's threefry differs")


def compare_shade(got, want, what, k1) -> None:
    """K1 against its plain version on the same inputs under the per-field
    gate (shadow rays where they are traced); worst values into `k1`."""
    live = want["shadow_tmax"] > 0
    for f in SHADE_FIELDS + ("shadow_o", "shadow_d"):
        a, b = want[f], got[f]
        if f in ("shadow_o", "shadow_d"):
            a, b = a[live], b[live]
        frac, mx, rel = row_mismatch(a, b, rel=True)
        k1["worst_frac"], k1["max_abs_err"] = max(k1["worst_frac"], frac), \
            max(k1["max_abs_err"], mx)
        k1["max_rel_err"] = max(k1["max_rel_err"], rel)
        if frac >= FIELD_MAX_FRAC:
            raise AssertionError(f"shade {what} {f}: {frac:.4f} of rows mismatched (max "
                                 f"|diff| {mx:.3e})")


def shade_times(kw, what) -> dict:
    """K1's time on these inputs, its plain version's, and the time of the
    draws and the material gather that fed K1 before it made them itself
    (`rng.bounce_uniforms` of 4 or 5 tags and the gather, as the plain
    version runs them)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import bsdf
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    n_tags = 5 if kw["cfg"].rr else 4

    def glue():
        rng.bounce_uniforms(kw["keys"], kw["bounce"], n_tags, 2)
        bsdf.gather_rows(kw["mats_table"], kw["mat_id"])

    out = dict(ms=timed(lambda: cshade.shade_bounce(**kw), 50),
               plain_ms=timed(lambda: cshade.shade_bounce_ref(**kw), 3),
               glue_ms=timed(glue, 10))
    log(f"shade times, {what} ({kw['origin'].shape[0]} rays): " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    return out


def phase_fur_kernels(scene, cam, cfg, dev) -> dict:
    """Bounces 0-3 of config 4: K2 (cone closest and shadow any-hit) and K1
    against their plain versions on the same CUDA inputs, with the times of
    both kernels beside their plain versions at the bounce-0 and bounce-1
    shapes; there also K1's draws held to the torch threefry bit for bit,
    K1 against its plain version with hair_p_random, and K1's bound."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, traverse as ctraverse

    bvh = scene.cone_bvh
    tables = pt.BounceTables.of(scene)
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    k2, k1 = [], dict(worst_frac=0.0, max_abs_err=0.0, max_rel_err=0.0)
    out = {}
    for bounce in range(cfg.depth):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        t_cap = torch.where(alive, traverse.INF, 0.0)
        o, d = state.origin, state.direction
        what = "camera wavefront" if bounce == 0 else f"bounce-{bounce} wavefront"
        if bounce < 2:
            k2.append(compare_traverse(o, d, t_cap, bvh, "cone", False, what))
            os_, ds_, ts_ = k2[-1]["sorted"]
        hit = traverse.closest_hit(o, d, scene, t_max=t_cap)
        kw = pt.shade_inputs(state, scene, keys, bounce, cfg, hit, tables)
        got = cshade.shade_bounce(**kw)
        want = cshade.shade_bounce_ref(**kw)
        torch.cuda.synchronize()
        compare_shade(got, want, f"config4 bounce {bounce}", k1)
        live = want["shadow_tmax"] > 0
        log(f"shade vs plain, config4 bounce {bounce}: ok, {int(alive.sum())} rays alive, "
            f"{int((hit.prim_type == 1).sum())} cone hits, {int(live.sum())} shadow rays")
        so, sd, st_max = want["shadow_o"], want["shadow_d"], want["shadow_tmax"]
        if bounce < 2:
            k2.append(compare_traverse(so, sd, st_max, bvh, "cone", True,
                                       f"bounce-{bounce} shadow rays"))
            sso, ssd, sst = k2[-1]["sorted"]
            reps = 20
            times = dict(
                closest_ms=timed(lambda: ctraverse.traverse(os_, ds_, ts_, bvh, "cone"), reps),
                closest_unsorted_ms=timed(lambda: ctraverse.traverse(o, d, t_cap, bvh, "cone"),
                                          reps),
                closest_plain_ms=timed(lambda: ctraverse.traverse_ref(os_, ds_, ts_, bvh,
                                                                      "cone"), 1),
                any_ms=timed(lambda: ctraverse.traverse(sso, ssd, sst, bvh, "cone",
                                                        any_hit=True), reps),
                any_unsorted_ms=timed(lambda: ctraverse.traverse(so, sd, st_max, bvh, "cone",
                                                                 any_hit=True), reps),
                any_plain_ms=timed(lambda: ctraverse.traverse_ref(sso, ssd, sst, bvh, "cone",
                                                                  any_hit=True), 1),
                sort_ms=timed(lambda: sorted_rays(o, d, t_cap, bvh), reps))
            log(f"config4 bounce {bounce} times ({o.shape[0]} rays): " + ", ".join(
                f"{k} {v:.4f}" for k, v in times.items()))
            what = f"config4 bounce {bounce}"
            check_draws(keys, bounce, what)
            kw_p = pt.shade_inputs(state, scene, keys, bounce,
                                   dataclasses.replace(cfg, hair_p_random=True), hit, tables)
            compare_shade(cshade.shade_bounce(**kw_p), cshade.shade_bounce_ref(**kw_p),
                          f"{what} hair_p_random", k1)
            out[bounce] = dict(times=times,
                               closest_bound=traverse_bound(os_, ds_, ts_, bvh, "cone", False,
                                                            hit=k2[-2]["hit"]),
                               any_bound=traverse_bound(sso, ssd, sst, bvh, "cone", True,
                                                        hit=k2[-1]["hit"]),
                               shade=shade_times(kw, what),
                               shade_bound=shade_bound(kw, got, what))
        blocked = traverse.any_hit(so, sd, scene, st_max)
        color = want["color"] + torch.where(blocked[:, None], 0.0, want["direct_rgb"])
        state = pt.RayState(origin=want["origin"], direction=want["direction"],
                            radiance=want["radiance"], color=color, flags=want["flags"],
                            theta_i=want["theta_i"], prev_pdf=want["prev_pdf"])
    log(f"shade vs plain, config4: worst mismatched-row fraction {k1['worst_frac']:.5f} "
        f"(gate: below {FIELD_MAX_FRAC}), max |diff| {k1['max_abs_err']:.3e} (the sun's "
        f"shadow t_max is ~1e16, where an ulp is ~1e9), max |diff| / max(|plain|, 1) "
        f"{k1['max_rel_err']:.3e}")
    for x in k2:
        del x["sorted"]
    out.update(k2=k2, k1=k1)
    return out


def phase_fur_main_path(scene, cam, cfg, dev) -> dict:
    """render_image of config 4 through the kernels: launch counts, the
    image, rays/s, and the spp-1 image against the plain path's."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.utils import film

    key = rng.key(0, dev)
    reset_counts()
    img = render(scene, cam, key, cfg)
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"config4: launches {counts} (expected traverse {2 * want} = spp x depth x "
        f"(closest + shadow), shade {want}, no plain calls)")
    check_counts(counts, "config4", shade=want, traverse=2 * want)
    w, h = cam.resolution
    a = check_image(img, (h, w, 3), "config4")
    OUT_DIR.mkdir(exist_ok=True)
    film.write_png(OUT_DIR / "smoke_fur_patch.png", a)
    times = phase_timing(scene, cam, key, cfg, name="config4", with_plain=False)
    one = dataclasses.replace(cfg, spp=1)
    a1 = check_image(render(scene, cam, key, one), (h, w, 3), "config4 spp 1")
    with plain_bounces():
        t0 = time.perf_counter()
        b1 = check_image(render(scene, cam, key, one), (h, w, 3), "config4 spp 1 plain")
        plain_s = time.perf_counter() - t0
    log(f"config4 spp-1 render via plain: {plain_s:.3f} s")
    gate = image_gate(b1, a1, "config4 spp-1 kernel vs plain image")
    return dict(counts=counts, times=times, gate=gate)


def camera_and_shadow_rays(scene, cam, cfg, dev):
    """Bounce 0 of `scene`: the camera wavefront (o, d, t_max) and the NEE
    shadow rays (o, d, t_max) the plain shade stage emits for its hits."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
    t_cap = torch.where(alive, traverse.INF, 0.0)
    hit = traverse.closest_hit(state.origin, state.direction, scene, t_max=t_cap)
    kw = pt.shade_inputs(state, scene, keys, 0, cfg, hit, pt.BounceTables.of(scene))
    sh = cshade.shade_bounce_ref(**kw)
    return ((state.origin, state.direction, t_cap),
            (sh["shadow_o"], sh["shadow_d"], sh["shadow_tmax"]))


def phase_tri_bvh(dev) -> dict:
    """K2's triangle leaves. On the main path: a Cornell box with a
    triangle BVH, its camera wavefront (closest hit) and shadow rays (any
    hit) held against the plain version, timed and bounded there, then
    rendered through the traversal and shade kernels and held against the
    full-bounce render of the same box. Off it: a soup of random triangles
    against the plain version, reported under its own name."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse
    from ba_pathtracing_fur_torch.scene import builtins, types

    c = TRI_BVH
    scene, cam = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
    cfg = render_cfg(c, c["spp"])
    with_bvh = traverse.attach_bvh(scene, leaf_size=8, min_prims=1)
    bvh = with_bvh.tri_bvh
    (o, d, t_cap), (so, sd, st_max) = camera_and_shadow_rays(with_bvh, cam, cfg, dev)
    checks = [compare_traverse(o, d, t_cap, bvh, "tri", False, "cornell camera wavefront"),
              compare_traverse(so, sd, st_max, bvh, "tri", True, "cornell shadow rays")]
    (o1, d1, t1), (o2, d2, t2) = checks[0].pop("sorted"), checks[1].pop("sorted")
    times = dict(ms=timed(lambda: ctraverse.traverse(o1, d1, t1, bvh, "tri"), 20),
                 unsorted_ms=timed(lambda: ctraverse.traverse(o, d, t_cap, bvh, "tri"), 20),
                 plain_ms=timed(lambda: ctraverse.traverse_ref(o1, d1, t1, bvh, "tri"), 3),
                 any_ms=timed(lambda: ctraverse.traverse(o2, d2, t2, bvh, "tri",
                                                         any_hit=True), 20),
                 any_plain_ms=timed(lambda: ctraverse.traverse_ref(o2, d2, t2, bvh, "tri",
                                                                   any_hit=True), 3))
    log(f"traverse tri, cornell bounce 0 ({o.shape[0]} rays, BVH {bvh.n_leaves} leaves x "
        f"{bvh.leaf_size}): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    b = traverse_bound(o, d, t_cap, bvh, "tri", False)
    traverse_bound(so, sd, st_max, bvh, "tri", True)

    key = rng.key(0, dev)
    reset_counts()
    img = render(with_bvh, cam, key, cfg)
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"cornell with a triangle BVH ({bvh.n_leaves} leaves x {bvh.leaf_size}): "
        f"launches {counts}")
    check_counts(counts, "cornell tri BVH", shade=want, traverse=2 * want)
    w, h = c["res"]
    a = check_image(img, (h, w, 3), "cornell tri BVH")
    ref = check_image(render(scene, cam, key, cfg), (h, w, 3), "cornell full bounce")
    image_gate(ref, a, "cornell: triangle-BVH path vs full-bounce path image")

    g = np.random.default_rng(0)
    v0 = g.uniform(-1, 1, (TRI_SOUP, 3)).astype(np.float32)
    v1, v2 = (v0 + g.normal(0, 0.04, (TRI_SOUP, 3)).astype(np.float32) for _ in range(2))
    soup = traverse.attach_bvh(dataclasses.replace(
        scene, tris=types._to(types.make_triangle_pack(v0, v1, v2), dev)), min_prims=1).tri_bvh
    so_ = torch.from_numpy(g.uniform(-1.5, 1.5, (SOUP_RAYS, 3)).astype(np.float32)).to(dev)
    sd_ = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(SOUP_RAYS, 3)).astype(np.float32)), dim=-1).to(dev)
    t_inf = torch.full((SOUP_RAYS,), 3.4e38, device=dev)
    t_one = torch.full((SOUP_RAYS,), 1.0, device=dev)
    log(f"triangle soup: {TRI_SOUP} triangles, BVH {soup.n_leaves} leaves x {soup.leaf_size}")
    soup_checks = [compare_traverse(so_, sd_, t_inf, soup, "tri", False, "soup"),
                   compare_traverse(so_, sd_, t_one, soup, "tri", True, "soup, t_max 1")]
    (o3, d3, t3), _ = (x.pop("sorted") for x in soup_checks)
    soup_hit = soup_checks[0].pop("hit")
    soup_res = dict(ms=timed(lambda: ctraverse.traverse(o3, d3, t3, soup, "tri"), 20),
                    unsorted_ms=timed(lambda: ctraverse.traverse(so_, sd_, t_inf, soup, "tri"),
                                      20),
                    plain_ms=timed(lambda: ctraverse.traverse_ref(o3, d3, t3, soup, "tri"), 1))
    log(f"traverse tri closest, soup ({SOUP_RAYS} rays): kernel {soup_res['ms']:.4f} ms "
        f"sorted, {soup_res['unsorted_ms']:.4f} ms unsorted, plain {soup_res['plain_ms']:.3f} ms")
    sb = traverse_bound(o3, d3, t3, soup, "tri", False, hit=soup_hit)
    soup_res.update(bound_ms=sb["bound_ms"], bound_by=sb["bound_by"], rays=SOUP_RAYS,
                    triangles=TRI_SOUP,
                    max_abs_err=max(x["max_abs_err"] for x in soup_checks))
    return dict(launches=counts["traverse"], max_abs_err=max(x["max_abs_err"] for x in checks),
                ms=times["ms"], unsorted_ms=times["unsorted_ms"], any_ms=times["any_ms"],
                plain_ms=times["plain_ms"], bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], soup=soup_res)


def hair_ball_scene(dev):
    """Config 5 through the entry points: the 1M fibers generated on the
    card and the device median build of their cone BVH (the 768 scalp
    triangles stay BVH-less: K5 takes them)."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    c = CONFIG5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene, cam = builtins.hair_ball(resolution=c["res"], n_fibers=c["n_fibers"],
                                    on_device=True, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n_cones = scene.cones.count
    t0 = time.perf_counter()
    scene = traverse.attach_bvh(scene, method="median")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b, stats = scene.cone_bvh, traverse.LAST_BUILD_STATS["cone"]
    log(f"config5: {n_cones} cones generated on the card in {gen_s:.3f} s; cone "
        f"BVH {b.n_leaves} leaves x {b.leaf_size}, fanout {b.fanout}, built on the "
        f"card in {build_s:.3f} s (aabb {stats['aabb']:.3f}, split "
        f"{stats['split']:.3f}, reorder + pack {stats['reorder_pack']:.3f}, layouts "
        f"{stats['layouts']:.3f} s); {scene.tris.count} scalp triangles without a BVH; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if (n_cones, (b.n_leaves, b.leaf_size, b.fanout)) != (9 * c["n_fibers"], c["bvh"]) \
            or scene.tri_bvh is not None or b.perm.device != scene.cones.base.device:
        raise AssertionError("config5: unexpected scene or BVH")
    cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], compact=False, fused_shading=True)
    return scene, cam, cfg, dict(gen_s=gen_s, build_s=build_s, stages=stats)


def spread(n: int, k: int, dev) -> torch.Tensor:
    """k ray indices spread evenly over a wavefront of n."""
    return torch.arange(k, device=dev) * (n // k)


def compare_stream(o, d, t_max, bvh, any_hit, what) -> dict:
    """On the entry-morton sorted wavefront the main path feeds it: K3
    against its brute-force twin on TWIN_RAYS rays spread over it (found and
    t bit for bit, and closest-hit rows) and against K2 on the same BVH over
    the whole wavefront (found and t bit for bit, closest-hit rows: both
    return the lexicographic minimum (t, row)); K3 and K2 on the unsorted
    wavefront equal to themselves on the sorted one."""
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse

    kind = "cone"
    flat = dataclasses.replace(bvh, fanout=0)
    so, sd, st, perm = sorted_rays(o, d, t_max, bvh)
    k3 = lambda a, b, c: cstream.traverse_stream(a, b, c, bvh, kind, any_hit=any_hit)  # noqa
    k2 = lambda a, b, c: ctraverse.traverse(a, b, c, flat, kind, any_hit=any_hit)  # noqa
    t3, r3, f3 = k3(so, sd, st)
    t2, r2, f2 = k2(so, sd, st)
    sub = spread(o.shape[0], TWIN_RAYS, o.device)
    t0, r0, f0 = cstream.traverse_stream_ref(so[sub], sd[sub], st[sub], bvh, kind,
                                             any_hit=any_hit)
    torch.cuda.synchronize()
    twin = dict(found=int((f0 != f3[sub]).sum()), t=int((t0 != t3[sub]).sum()))
    vs_k2 = dict(found=int((f2 != f3).sum()), t=int((t2 != t3).sum()))
    if not any_hit:  # an any hit's row is whichever accepted row came first
        twin["rows"] = int((r0 != r3[sub]).sum())
        vs_k2["rows"] = int((r2 != r3).sum())
    err = float((t0 - t3[sub]).abs().max())
    log(f"traverse_stream cone {'any' if any_hit else 'closest'} hit, {what} (sorted): "
        f"{o.shape[0]} rays, found {int(f3.sum())}; vs twin on {TWIN_RAYS} rays (found "
        f"{int(f0.sum())}): found/t/row mismatches {twin}; vs traverse (K2) on all rays: "
        f"{vs_k2}")
    if any(twin.values()) or any(vs_k2.values()):
        raise AssertionError(f"traverse_stream {what}: kernel disagrees")
    same_unsorted(k3, (o, d, t_max), perm, (t3, r3, f3), any_hit, f"traverse_stream {what}")
    same_unsorted(k2, (o, d, t_max), perm, (t2, r2, f2), any_hit, f"traverse (K2) {what}")
    return dict(max_abs_err=err, t=t3, row=r3, found=f3, sorted=(so, sd, st))


def stream_bound(o, d, t_max, bvh, any_hit, t, row, found) -> dict:
    """K3's bound on this wavefront: the tests `work_ref` counts on WORK_RAYS
    rays spread over it (from K3's own hits, held to the twin above),
    scaled to the whole wavefront; the rays, boxes and tables read once,
    the distinct leaves the sampled rays enter read once (a lower count of
    the whole wavefront's), (t, row, found) written once."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    r = o.shape[0]
    sub = spread(r, WORK_RAYS, o.device)
    w = ctraverse.work_ref(o[sub], d[sub], t_max[sub], bvh, "cone", any_hit=any_hit,
                           hit=(t[sub], row[sub], found[sub]))
    scale = r / WORK_RAYS
    n_bytes = nbytes(o, d, t_max, bvh.bmin, bvh.bmax, bvh.sboxes, bvh.cboxes) \
        + w["leaf_bytes"] + r * 9
    res = bound(w["flops"] * scale, n_bytes)
    log(f"traverse_stream cone {'any' if any_hit else 'closest'} work on {WORK_RAYS} of {r} "
        f"rays: {w['box_tests']} box tests, {w['leaf_row_tests']} leaf-row tests "
        f"({w['leaf_row_tests'] / WORK_RAYS:.1f} a ray), {w['leaves_entered']} of "
        f"{bvh.n_leaves} leaves entered ({w['leaf_bytes']:.4e} bytes) -> x{scale:.1f} = "
        f"{res['flops']:.4e} flops, {n_bytes:.4e} bytes, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']}")
    return dict(res, row_tests_per_ray=w["leaf_row_tests"] / WORK_RAYS,
                leaves_entered=w["leaves_entered"])


def brute_bound(o, d, t_max, tables, kind, t, idx, max_tiles=0) -> dict:
    """K5's bound on these rays (`cisect.work_ref`): an exact test per pair
    whose padded box the ray enters by its final t, each input read once
    and each output written once. Beside it, the cull's own tests and the
    tiles' L2 re-reads (diagnostics, not in the bound), and the TPU
    kernel's work (every live ray against every primitive) and its bound."""
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect

    t_fin = torch.where(idx >= 0, t, t_max)
    w = cisect.work_ref(o, d, t_max, tables, kind, t_fin, max_tiles=max_tiles)
    res = bound(w["flops"], w["bytes"])
    old = bound(w["all_pairs_flops"], w["all_pairs_bytes"])
    log(f"bruteforce {kind} work ({w['counted_tiles']} of {w['tiles']} tiles counted): "
        f"{w['exact_tests']:.4e} exact tests = {w['exact_per_ray']:.3f} a live ray -> "
        f"{w['flops']:.4e} flops, {w['bytes']:.4e} bytes, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']}; the cull's own work: {w['live_tiles']:.0f} live tiles, "
        f"{w['survivors_per_tile']:.2f} survivors a tile of {tables.cm.shape[1]}, "
        f"{w['bundle_tests']:.4e} bundle and {w['slab_tests']:.4e} slab tests = "
        f"{w['cull_flops']:.4e} flops, {w['reread_bytes']:.4e} bytes re-read from L2; the "
        f"TPU kernel's work: {w['all_pairs']} pairs x {cisect.PAIR_FLOPS[kind]} flops, bound "
        f"{old['bound_ms']:.4f} ms by {old['bound_by']}")
    return dict(res, survivors_per_tile=w["survivors_per_tile"],
                exact_per_ray=w["exact_per_ray"], cull_flops=w["cull_flops"],
                reread_bytes=w["reread_bytes"], all_pairs_bound_ms=old["bound_ms"])


def k5_wavefront(o, d, t_max, pack, kind, bvh, what, max_tiles=0, plain=False) -> dict:
    """K5 on one wavefront as the main path feeds it: on the entry-morton
    sorted rays when the scene has a BVH (`bvh`), else as they come. Held
    against its twin on every ray (t and index bit for bit), the unsorted
    rays' result equal to the sorted rays' ray for ray; the cull's margin
    (`cisect.cull_margin`) over every accepted pair; timed sorted and
    unsorted; bounded by `brute_bound`."""
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect

    tables = cisect.tables_of(pack, kind)
    rays = (o, d, t_max)
    if bvh is not None:
        *rays, perm = sorted_rays(o, d, t_max, bvh)
    so, sd, st = rays
    t1, i1 = cisect.closest(so, sd, st, tables, kind)
    t0, i0 = cisect.closest_ref(so, sd, st, tables, kind)
    torch.cuda.synchronize()
    bad_t, bad_i = int((t0 != t1).sum()), int((i0 != i1).sum())
    log(f"bruteforce {kind} vs plain, {what}{' (sorted)' if bvh is not None else ''}: "
        f"{o.shape[0]} rays x {tables.cm.shape[1]} primitives, hits {int((i1 >= 0).sum())}; "
        f"t mismatches {bad_t}, index mismatches {bad_i}")
    if bad_t or bad_i:
        raise AssertionError(f"bruteforce {kind} {what}: kernel disagrees with plain")
    margin = cisect.cull_margin(so, sd, st, pack, kind)
    log(f"bruteforce {kind} cull margin, {what}: {margin['pairs']} accepted pairs, largest "
        f"entry into the padded box / t {margin['entry_ratio']:.7f} (pruned beyond "
        f"{cisect.PRUNE_SLACK}), boxes missed {margin['missed']}, furthest hit point outside "
        f"its unpadded box {margin['pad_needed']:.3e} of the pack's extent (padded by "
        f"{cisect.BOX_PAD_EXT} of it + {cisect.BOX_PAD_REL} of each coordinate)")
    if margin["missed"] or margin["entry_ratio"] > cisect.PRUNE_SLACK:
        raise AssertionError(f"bruteforce {kind} {what}: the cull could drop an accepted pair")
    reps = 20 if kind == "tri" else 3
    res = dict(max_abs_err=float((t0 - t1).abs().max()), margin=margin,
               ms=timed(lambda: cisect.closest(so, sd, st, tables, kind), reps))
    if bvh is not None:
        tu, iu = cisect.closest(o, d, t_max, tables, kind)
        torch.cuda.synchronize()
        if not (torch.equal(tu[perm], t1) and torch.equal(iu[perm], i1)):
            raise AssertionError(f"bruteforce {kind} {what}: unsorted rays give another result")
        res["unsorted_ms"] = timed(lambda: cisect.closest(o, d, t_max, tables, kind), reps)
    if plain:
        res["plain_ms"] = timed(lambda: cisect.closest_ref(so, sd, st, tables, kind), 1)
    res["bound"] = brute_bound(so, sd, st, tables, kind, t1, i1, max_tiles)
    log(f"bruteforce {kind}, {what}: kernel {res['ms']:.4f} ms"
        + (f" sorted, {res['unsorted_ms']:.4f} ms unsorted" if "unsorted_ms" in res else "")
        + (f"; plain {res['plain_ms']:.3f} ms" if plain else ""))
    return res


def phase_hairball_kernels(scene, cam, cfg, dev) -> dict:
    """Bounces 0-1 of config 5 through the kernels: K3 (closest hit on the
    wavefront, any hit on its shadow rays) against its twin and K2, timed
    beside K2 and bounded; K5 on the scalp (the camera and bounce-1
    wavefronts and the bounce-0 shadow rays, sorted as the main path feeds
    it and unsorted) against its twin, timed and bounded; K1 against its
    plain version on every ray (per-field gate), its draws held to the torch
    threefry bit for bit, timed and bounded."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, stream as cstream, \
        traverse as ctraverse

    bvh = scene.cone_bvh
    flat = dataclasses.replace(bvh, fanout=0)
    tables = pt.BounceTables.of(scene)
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    out = dict(k1=dict(worst_frac=0.0, max_abs_err=0.0, max_rel_err=0.0))
    for bounce in range(2):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        t_cap = torch.where(alive, traverse.INF, 0.0)
        o, d = state.origin, state.direction
        what = "camera wavefront" if bounce == 0 else "bounce-1 wavefront"
        closest = compare_stream(o, d, t_cap, bvh, False, what)
        hit = traverse.closest_hit(o, d, scene, t_max=t_cap)
        kw = pt.shade_inputs(state, scene, keys, bounce, cfg, hit, tables)
        sh = cshade.shade_bounce(**kw)
        compare_shade(sh, cshade.shade_bounce_ref(**kw), f"config5 bounce {bounce}", out["k1"])
        log(f"shade vs plain, config5 bounce {bounce}: ok, {o.shape[0]} rays")
        check_draws(keys, bounce, f"config5 bounce {bounce}")
        shade = dict(shade_times(kw, f"config5 bounce {bounce}"),
                     bound=shade_bound(kw, sh, f"config5 bounce {bounce}"))
        so, sd, st_max = sh["shadow_o"], sh["shadow_d"], sh["shadow_tmax"]
        shadow = compare_stream(so, sd, st_max, bvh, True, f"bounce-{bounce} shadow rays")
        sub = spread(o.shape[0], TWIN_RAYS, dev)
        (o1, d1, t1), (o2, d2, t2) = closest.pop("sorted"), shadow.pop("sorted")
        times = dict(
            closest_ms=timed(lambda: cstream.traverse_stream(o1, d1, t1, bvh, "cone"), 3),
            closest_k2_ms=timed(lambda: ctraverse.traverse(o1, d1, t1, flat, "cone"), 3),
            any_ms=timed(lambda: cstream.traverse_stream(o2, d2, t2, bvh, "cone",
                                                         any_hit=True), 3),
            any_k2_ms=timed(lambda: ctraverse.traverse(o2, d2, t2, flat, "cone",
                                                       any_hit=True), 3),
            sort_ms=timed(lambda: sorted_rays(o, d, t_cap, bvh), 3))
        if bounce == 0:
            times.update(
                closest_unsorted_ms=timed(lambda: cstream.traverse_stream(o, d, t_cap, bvh,
                                                                          "cone"), 3),
                closest_k2_unsorted_ms=timed(lambda: ctraverse.traverse(o, d, t_cap, flat,
                                                                        "cone"), 3),
                any_unsorted_ms=timed(lambda: cstream.traverse_stream(
                    so, sd, st_max, bvh, "cone", any_hit=True), 3),
                any_k2_unsorted_ms=timed(lambda: ctraverse.traverse(
                    so, sd, st_max, flat, "cone", any_hit=True), 3),
                closest_plain_ms=timed(lambda: cstream.traverse_stream_ref(
                    o1[sub], d1[sub], t1[sub], bvh, "cone"), 1))
        log(f"config5 bounce {bounce} K3 and K2 times ({o.shape[0]} rays, entry-morton "
            f"sorted unless named unsorted; plain on {TWIN_RAYS}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
        out[bounce] = dict(
            times=times, closest=closest, shadow=shadow, alive=int(alive.sum()), shade=shade,
            closest_bound=stream_bound(o1, d1, t1, bvh, False, closest["t"], closest["row"],
                                       closest["found"]),
            any_bound=stream_bound(o2, d2, t2, bvh, True, shadow["t"], shadow["row"],
                                   shadow["found"]))
        out[f"k5_tri_{bounce}"] = k5_wavefront(o, d, t_cap, scene.tris, "tri", bvh,
                                               f"config5 {what}", plain=bounce == 0)
        if bounce == 0:
            out["k5_tri_shadow"] = k5_wavefront(so, sd, st_max, scene.tris, "tri", bvh,
                                                "config5 bounce-0 shadow rays")
        blocked = traverse.any_hit(so, sd, scene, st_max)
        color = sh["color"] + torch.where(blocked[:, None], 0.0, sh["direct_rgb"])
        state = pt.RayState(origin=sh["origin"], direction=sh["direction"],
                            radiance=sh["radiance"], color=color, flags=sh["flags"],
                            theta_i=sh["theta_i"], prev_pdf=sh["prev_pdf"])
    return out


def phase_hairball_main_path(scene, cam, cfg, dev) -> dict:
    """render_image of config 5 through the kernels: launch counts, the
    image, rays/s (median of TIMED_REPS), peak device memory."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.utils import film

    key = rng.key(0, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    img = render(scene, cam, key, cfg)
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"config5: launches {counts} (expected stream and bruteforce_tri {2 * want} = spp x "
        f"depth x (closest + shadow), shade {want}, no plain calls)")
    check_counts(counts, "config5", shade=want, stream=2 * want, bruteforce_tri=2 * want)
    w, h = cam.resolution
    a = check_image(img, (h, w, 3), "config5")
    log(f"config5 image: finite, max {a.max():.4f}, mean {a.mean():.5f}, std {a.std():.5f}; "
        f"peak device memory of the render {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    OUT_DIR.mkdir(exist_ok=True)
    film.write_png(OUT_DIR / "smoke_hair_ball.png", a)
    times = phase_timing(scene, cam, key, cfg, name="config5", with_plain=False)
    return dict(counts=counts, times=times)


def phase_bruteforce_cone(dev) -> dict:
    """K5's cone variant on a user path: config 4's fur patch without a BVH
    (262,144 rays x 45,000 cones a call; no BVH, so no ray sort). On its
    camera and bounce-1 wavefronts: held against its twin on every ray,
    timed and bounded (the cull's work counted on K5_CONE_TILES tiles);
    then rendered through the kernels at spp 1 and
    gated against the render of the same patch with a cone BVH (K2)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins

    scene, cam = builtins.fur_patch(resolution=CONFIG4["res"],
                                    fibers_per_face=CONFIG4["fibers_per_face"], device=dev)
    cfg = pt.RenderConfig(depth=CONFIG4["depth"], spp=1, compact=False, fused_shading=True)
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    res = {}
    for bounce in range(2):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        t_cap = torch.where(alive, traverse.INF, 0.0)
        o, d = state.origin, state.direction
        what = "camera wavefront" if bounce == 0 else "bounce-1 wavefront"
        res[bounce] = k5_wavefront(o, d, t_cap, scene.cones, "cone", None,
                                   f"fur patch {what}", max_tiles=K5_CONE_TILES,
                                   plain=bounce == 0)
        hit = traverse.closest_hit(o, d, scene, t_max=t_cap)
        sh = cshade.shade_bounce(**pt.shade_inputs(state, scene, keys, bounce, cfg, hit,
                                                   pt.BounceTables.of(scene)))
        state = pt.RayState(origin=sh["origin"], direction=sh["direction"],
                            radiance=sh["radiance"], color=sh["color"], flags=sh["flags"],
                            theta_i=sh["theta_i"], prev_pdf=sh["prev_pdf"])
    key = rng.key(0, dev)
    shape = (cam.resolution[1], cam.resolution[0], 3)
    reset_counts()
    a = check_image(render(scene, cam, key, cfg), shape, "fur patch without a BVH")
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"fur patch without a BVH: launches {counts}")
    check_counts(counts, "fur patch without a BVH", shade=want, bruteforce_cone=2 * want)
    b = check_image(render(traverse.attach_bvh(scene), cam, key, cfg), shape,
                    "fur patch with a BVH")
    res["gate"] = image_gate(b, a, "fur patch spp 1: BVH-less (K5) vs BVH (K2) image")
    res["launches"] = counts["bruteforce_cone"]
    return res


def phase_mid_hairball(dev) -> dict:
    """A mid-size hair ball with a two-level cone BVH (so K3 runs) through
    the kernels and through their plain versions, under the image gate."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    c = MID_HAIRBALL
    scene, cam = builtins.hair_ball(resolution=c["res"], n_fibers=c["n_fibers"],
                                    on_device=True, device=dev)
    scene = traverse.attach_bvh(scene, method="median", fanout=64)
    b = scene.cone_bvh
    if not 0 < b.fanout < b.n_leaves:
        raise AssertionError(f"mid hair ball: the BVH of {b.n_leaves} leaves is not two-level")
    cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], compact=False, fused_shading=True)
    key = rng.key(0, dev)
    w, h = c["res"]
    reset_counts()
    a = check_image(render(scene, cam, key, cfg), (h, w, 3), "mid hair ball")
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"mid hair ball ({scene.cones.count} cones, BVH {b.n_leaves} leaves x {b.leaf_size}, "
        f"fanout {b.fanout}, {w}x{h}): launches {counts}")
    check_counts(counts, "mid hair ball", shade=want, stream=2 * want, bruteforce_tri=2 * want)
    t0 = time.perf_counter()
    with plain_bounces():
        p = check_image(render(scene, cam, key, cfg), (h, w, 3), "mid hair ball plain")
    log(f"mid hair ball render via plain: {time.perf_counter() - t0:.2f} s")
    return image_gate(p, a, "mid hair ball spp 1: kernels vs plain image")

def terrain_scene(dev, c):
    """Config 3 (or the terrain of config `c`) through the entry points: the
    textured terrain on the card and its SAH BVH (the split on the host in
    numpy, the boxes, reorder and kernel layouts on the card)."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene, cam = builtins.tri_terrain(resolution=c["res"], n_tris=c["n_tris"], device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n_tris = scene.tris.count
    t0 = time.perf_counter()
    scene = traverse.attach_bvh(scene, method="sah")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b, st = scene.tri_bvh, traverse.LAST_BUILD_STATS["tri"]
    log(f"terrain: {n_tris} triangles, atlas {tuple(scene.textures.images.shape)}, "
        f"slots {scene.tex_slots}, made in {gen_s:.3f} s; SAH BVH {b.n_leaves} leaves x "
        f"{b.leaf_size}, fanout {b.fanout}, built in {build_s:.3f} s (aabb {st['aabb']:.3f}, "
        f"SAH split on the host {st['split']:.3f}, reorder + pack {st['reorder_pack']:.3f}, "
        f"layouts {st['layouts']:.3f} s)")
    if b.perm.device != scene.tris.v0.device:
        raise AssertionError("terrain: the BVH is not on the card")
    return scene, cam, dict(gen_s=gen_s, build_s=build_s, stages=st)


@contextlib.contextmanager
def captured_shadow_rays(out: list):
    """Record the (o, d, t_max) of every `traverse.any_hit` call (the NEE
    shadow rays of the unfused bounce) into `out`."""
    from ba_pathtracing_fur_torch.ops import traverse

    fn = traverse.any_hit

    def spy(o, d, scene, t_max, *a, **k):
        out.append((o, d, t_max))
        return fn(o, d, scene, t_max, *a, **k)

    traverse.any_hit = spy
    try:
        yield
    finally:
        traverse.any_hit = fn


def compare_k2_subset(o, d, t_max, bvh, any_hit, what) -> dict:
    """K2 on a triangle BVH too big for its twin on a whole wavefront: on
    the entry-morton sorted rays the main path feeds it, against the twin on
    TWIN_RAYS rays spread over them (found, t bit for bit, rows on closest
    hits), and on the unsorted wavefront equal to itself on the sorted one.
    Times K2 sorted and unsorted, and the twin on the subset."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    so, sd, st, perm = sorted_rays(o, d, t_max, bvh)
    fn = lambda a, b, c: ctraverse.traverse(a, b, c, bvh, "tri", any_hit=any_hit)  # noqa: E731
    t1, r1, f1 = fn(so, sd, st)
    sub = spread(o.shape[0], TWIN_RAYS, o.device)
    t0, r0, f0 = ctraverse.traverse_ref(so[sub], sd[sub], st[sub], bvh, "tri", any_hit=any_hit)
    torch.cuda.synchronize()
    mis = dict(found=int((f0 != f1[sub]).sum()), t=int((t0 != t1[sub]).sum()))
    if not any_hit:
        mis["rows"] = int((r0 != r1[sub]).sum())
    log(f"traverse tri {'any' if any_hit else 'closest'} hit, {what} (sorted): {o.shape[0]} "
        f"rays, found {int(f1.sum())}; vs twin on {TWIN_RAYS} spread rays (found "
        f"{int(f0.sum())}): mismatches {mis}")
    if any(mis.values()):
        raise AssertionError(f"traverse tri {what}: kernel disagrees with plain")
    same_unsorted(fn, (o, d, t_max), perm, (t1, r1, f1), any_hit, f"traverse tri {what}")
    res = dict(max_abs_err=float((t0 - t1[sub]).abs().max()),
               ms=timed(lambda: fn(so, sd, st), 20), unsorted_ms=timed(lambda: fn(o, d, t_max), 20),
               plain_ms=timed(lambda: ctraverse.traverse_ref(so[sub], sd[sub], st[sub], bvh, "tri",
                                                             any_hit=any_hit), 3),
               plain_rays=TWIN_RAYS, found=int(f1.sum()))
    # the bound counts the walk these rays need: their closest hits (for a
    # shadow ray, whether one lies below t_max, and its row)
    hit = (t1, r1, f1) if not any_hit else ctraverse.traverse(so, sd, st, bvh, "tri")
    res.update(traverse_bound(so, sd, st, bvh, "tri", any_hit, hit=hit))
    log(f"traverse tri, {what}: kernel {res['ms']:.4f} ms sorted, {res['unsorted_ms']:.4f} ms "
        f"unsorted, plain {res['plain_ms']:.3f} ms on {TWIN_RAYS} rays, bound "
        f"{res['bound_ms']:.4f} ms by {res['bound_by']}")
    return res


def phase_terrain_kernels(scene, cam, cfg, dev) -> dict:
    """K2's triangle leaves on config 3's wavefronts: the camera wavefront,
    the bounce-0 NEE shadow rays and the bounce-1 wavefront of the unfused
    bounce, each held to the twin and timed (`compare_k2_subset`)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse

    bvh = scene.tri_bvh
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    out = {}
    for bounce in range(2):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        t_cap = torch.where(alive, traverse.INF, 0.0)
        what = "config-3 camera wavefront" if bounce == 0 else "config-3 bounce-1 wavefront"
        out[bounce] = compare_k2_subset(state.origin, state.direction, t_cap, bvh, False, what)
        shadow = []
        with captured_shadow_rays(shadow):
            nxt = pt.trace_bounce(state, scene, keys, bounce, cfg)
        if bounce == 0:
            (so, sd, st), = shadow
            out["shadow"] = compare_k2_subset(so, sd, st, bvh, True,
                                              "config-3 bounce-0 shadow rays")
        state = nxt
    return out


def phase_terrain_main_path(scene, cam, cfg, dev) -> dict:
    """render_image of config 3 through the unfused bounce: the launch
    counts (K2 alone, twice a bounce), the image, TIMED_REPS timed renders
    and a traced sample."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.utils import film

    key = rng.key(0, dev)
    reset_counts()
    img = render(scene, cam, key, cfg)  # also the warm-up of the timed reps
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"config3: launches {counts} (expected traverse {2 * want} = spp x depth x "
        f"(closest + shadow), no plain calls)")
    check_counts(counts, "config3", traverse=2 * want)
    w, h = cam.resolution
    a = check_image(img, (h, w, 3), "config3")
    OUT_DIR.mkdir(exist_ok=True)
    film.write_png(OUT_DIR / "smoke_config3.png", a)
    times = phase_timing(scene, cam, key, cfg, name="config3", with_plain=False)
    rays = w * h * cfg.spp * cfg.depth
    rates = sorted(rays / t for t in times["kernel_reps"])
    prof = phase_profile(scene, cam, key, cfg, name="config-3", marks=("traverse_kernel",))
    log(f"config3 end to end: {rays / times['kernel']:.4e} rays/s (median of {TIMED_REPS}; "
        f"reps {', '.join(f'{r:.4e}' for r in rates)}); traced sample: device busy "
        f"{prof['busy'] * 1e3:.2f} ms, idle share {max(0.0, 1 - prof['busy'] / prof['wall']):.3f}, "
        f"{prof['launches']} launches, K2 {prof['kernel_ms']['traverse_kernel']:.3f} ms = "
        f"{prof['kernel_ms']['traverse_kernel'] / 1e3 / max(prof['busy'], 1e-12):.4f} of device "
        f"time ({prof['kernel_launches']['traverse_kernel']} launches)")
    return dict(counts=counts, times=times, rays_per_s=rays / times["kernel"], rates=rates,
                profile=prof)


def phase_terrain_gate(dev) -> dict:
    """A small terrain (SAH BVH) through the kernels and through the plain
    versions on the card, under the image gate."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    c = SMALL_TERRAIN
    scene, cam, _ = terrain_scene(dev, c)
    cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], compact=False)
    key = rng.key(0, dev)
    w, h = c["res"]
    reset_counts()
    a = check_image(render(scene, cam, key, cfg), (h, w, 3), "small terrain")
    counts = read_counts()
    check_counts(counts, "small terrain", traverse=2 * cfg.spp * cfg.depth)
    with plain_bounces():
        b = check_image(render(scene, cam, key, cfg), (h, w, 3), "small terrain plain")
    return image_gate(b, a, f"terrain {c['n_tris']} triangles {w}x{h} spp {cfg.spp}: kernels "
                            "vs plain image")


def phase_unfused_vs_fused(dev) -> dict:
    """The unfused bounce against the fused one on the card, both through
    the kernels, the same streams: the triangle-BVH Cornell (K2 on triangle
    leaves, K1 on the fused side) and the fur patch with its cone BVH (K2
    cones, K1 with the hair walk), under the image gate of
    tests/test_fused_shade.py::_compare."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    c = UNFUSED_VS_FUSED
    cornell, ccam = builtins.cornell_box(resolution=c["res"], device=dev)
    fur, fcam = builtins.fur_patch(resolution=c["res"],
                                   fibers_per_face=CONFIG4["fibers_per_face"], device=dev)
    out = {}
    for name, scene, cam in (("cornell tri BVH", traverse.attach_bvh(cornell, leaf_size=8,
                                                                     min_prims=1), ccam),
                             ("fur patch", traverse.attach_bvh(fur), fcam)):
        imgs = {}
        for fused in (False, True):
            cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], compact=False,
                                  fused_shading=fused)
            reset_counts()
            imgs[fused] = check_image(render(scene, cam, rng.key(0, dev), cfg),
                                      (c["res"][1], c["res"][0], 3), f"{name} fused={fused}")
            want = cfg.spp * cfg.depth
            check_counts(read_counts(), f"{name} fused={fused}", traverse=2 * want,
                         shade=want if fused else 0)
        out[name] = image_gate(imgs[True], imgs[False], f"{name}: unfused vs fused image")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    from ba_pathtracing_fur_torch import kernels
    nvcc_v = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc_v}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.load_library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    for line in kernels.LAST_BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line or "stack frame" in line:
            log("ptxas:", line.strip())
    kernels_line = drive(dev, card)
    log(card)
    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def drive(dev, card: str) -> list:
    """Every phase on `dev`, in order -> the `kernels` line's entries."""
    # threefry on the card is bit-exact with the CPU
    from ba_pathtracing_fur_torch.core import rng
    ids = torch.arange(4096)
    kc = rng.bounce_uniforms(rng.keys_for_pixels(rng.key(0, "cpu"), ids, 3), 2, 5, 2)
    kg = rng.bounce_uniforms(rng.keys_for_pixels(rng.key(0, dev), ids.to(dev), 3), 2, 5, 2)
    if not torch.equal(kc, kg.cpu()):
        raise AssertionError("threefry uniforms on the card differ from the CPU")
    log("threefry: card uniforms bit-identical to CPU")

    check = phase_kernel_vs_plain(dev)
    k4 = time_bounces(dev)
    phase_small_reference(dev)
    main_res = phase_main_path(dev)
    times = phase_timing(*main_res["config0_scene"])
    phase_profile(*main_res["config0_scene"])
    log(f"config0 end to end: kernel path {times['kernel']:.4f} s, plain path "
        f"{times['plain']:.4f} s, on {card}")

    scene4, cam4, cfg4, build_s = fur_scene(dev)
    fur = phase_fur_kernels(scene4, cam4, cfg4, dev)
    fur_main = phase_fur_main_path(scene4, cam4, cfg4, dev)
    from ba_pathtracing_fur_torch.core import rng
    marks4 = ("traverse_kernel", "shade_kernel")
    prof4 = phase_profile(scene4, cam4, rng.key(0, dev), cfg4, name="config-4", marks=marks4)
    un4 = phase_sort_effect(scene4, cam4, rng.key(0, dev), cfg4, "config4", marks4)
    rays4 = cam4.resolution[0] * cam4.resolution[1] * cfg4.spp * cfg4.depth
    log(f"config4 end to end: kernel path {fur_main['times']['kernel']:.4f} s = "
        f"{rays4 / fur_main['times']['kernel']:.4e} rays/s sorted, "
        f"{rays4 / un4['times']['kernel']:.4e} rays/s unsorted; the sort adds "
        f"{prof4['launches'] - un4['profile']['launches']} launches a sample; BVH build "
        f"{build_s:.3f} s, on {card}")
    tri = phase_tri_bvh(dev)

    from ba_pathtracing_fur_torch.models import pathtracer as pt
    scene5, cam5, cfg5, build5 = hair_ball_scene(dev)
    hb = phase_hairball_kernels(scene5, cam5, cfg5, dev)
    hb_main = phase_hairball_main_path(scene5, cam5, cfg5, dev)
    marks5 = ("stream_kernel", "brute_kernel", "shade_kernel")
    prof5 = phase_profile(scene5, cam5, rng.key(0, dev), cfg5, name="config-5", marks=marks5)
    un5 = phase_sort_effect(scene5, cam5, rng.key(0, dev), cfg5, "config5", marks5)
    rays5 = cam5.resolution[0] * cam5.resolution[1] * cfg5.spp * cfg5.depth
    log(f"config5 end to end: kernel path {hb_main['times']['kernel']:.4f} s = "
        f"{rays5 / hb_main['times']['kernel']:.4e} rays/s sorted, "
        f"{rays5 / un5['times']['kernel']:.4e} rays/s unsorted; the sort adds "
        f"{prof5['launches'] - un5['profile']['launches']} launches a sample; generation "
        f"{build5['gen_s']:.3f} s, BVH build {build5['build_s']:.3f} s, on {card}")
    del scene5
    k5_cone = phase_bruteforce_cone(dev)
    phase_mid_hairball(dev)

    c3 = CONFIG3
    scene3, cam3, build3 = terrain_scene(dev, c3)
    cfg3 = pt.RenderConfig(depth=c3["depth"], spp=c3["spp"], ray_chunk=c3["ray_chunk"],
                           compact=False)
    if (scene3.tri_bvh.n_leaves, scene3.tri_bvh.leaf_size, scene3.tri_bvh.fanout) != c3["bvh"]:
        raise AssertionError(f"config3: unexpected BVH, not {c3['bvh']}")
    k2t = phase_terrain_kernels(scene3, cam3, cfg3, dev)
    main3 = phase_terrain_main_path(scene3, cam3, cfg3, dev)
    log(f"config3 end to end: {main3['rays_per_s']:.4e} rays/s; SAH build "
        f"{build3['build_s']:.3f} s (split {build3['stages']['split']:.3f} s), on {card}")
    del scene3
    phase_terrain_gate(dev)
    phase_unfused_vs_fused(dev)

    t0, s0 = fur[0]["times"], fur[0]["shade"]
    b0 = fur[0]["closest_bound"]
    h0, k5t, k4b = hb[0], hb["k5_tri_0"], k4["config0_b0"]
    k5c = k5_cone[0]
    kernels_line = [
        dict(name="full_bounce", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/full_bounce.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/shade.py:359",
             launches=main_res["launches"], max_abs_err=check["max_abs_err"],
             mismatch_frac=check["mismatch_frac"], ms=k4b["ms"], plain_ms=k4b["plain_ms"],
             bound_ms=k4b["bound_ms"], bound_by=k4b["bound_by"], library_ms=None,
             bounces={k: dict(ms=v["ms"], bound_ms=v["bound_ms"]) for k, v in k4.items()}),
        dict(name="traverse_cone", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/traverse.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/traverse.py:247",
             launches=fur_main["counts"]["traverse"],
             max_abs_err=max(x["max_abs_err"] for x in fur["k2"]), ms=t0["closest_ms"],
             plain_ms=t0["closest_plain_ms"], bound_ms=b0["bound_ms"],
             bound_by=b0["bound_by"], library_ms=None,
             unsorted_ms=t0["closest_unsorted_ms"], any_ms=t0["any_ms"],
             any_unsorted_ms=t0["any_unsorted_ms"], any_plain_ms=t0["any_plain_ms"],
             any_bound_ms=fur[0]["any_bound"]["bound_ms"],
             any_bound_by=fur[0]["any_bound"]["bound_by"], sort_ms=t0["sort_ms"]),
        dict(name="traverse_tri", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/traverse.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/traverse.py:247",
             launches=tri["launches"], max_abs_err=tri["max_abs_err"], ms=tri["ms"],
             plain_ms=tri["plain_ms"], bound_ms=tri["bound_ms"], bound_by=tri["bound_by"],
             library_ms=None, unsorted_ms=tri["unsorted_ms"], any_ms=tri["any_ms"],
             soup=tri["soup"],
             config3=dict(
                 launches=main3["counts"]["traverse"],
                 max_abs_err=max(k2t[k]["max_abs_err"] for k in (0, 1, "shadow")),
                 **{k: k2t[0][k] for k in ("ms", "unsorted_ms", "plain_ms", "plain_rays",
                                           "bound_ms", "bound_by")},
                 any_ms=k2t["shadow"]["ms"], any_unsorted_ms=k2t["shadow"]["unsorted_ms"],
                 any_plain_ms=k2t["shadow"]["plain_ms"],
                 any_bound_ms=k2t["shadow"]["bound_ms"], any_bound_by=k2t["shadow"]["bound_by"],
                 bounce1_ms=k2t[1]["ms"], bounce1_unsorted_ms=k2t[1]["unsorted_ms"],
                 bounce1_bound_ms=k2t[1]["bound_ms"],
                 traced_ms=main3["profile"]["kernel_ms"]["traverse_kernel"],
                 traced_launches=main3["profile"]["kernel_launches"]["traverse_kernel"],
                 leaves=c3["bvh"][0], leaf_rows=c3["bvh"][1])),
        dict(name="shade", route="cuda", source="ba_pathtracing_fur_torch/csrc/shade.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/shade.py:92",
             launches=fur_main["counts"]["shade"],
             max_abs_err=max(fur["k1"]["max_abs_err"], hb["k1"]["max_abs_err"]),
             mismatch_frac=max(fur["k1"]["worst_frac"], hb["k1"]["worst_frac"]),
             max_rel_err=max(fur["k1"]["max_rel_err"], hb["k1"]["max_rel_err"]),
             ms=s0["ms"], plain_ms=s0["plain_ms"], bound_ms=fur[0]["shade_bound"]["bound_ms"],
             bound_by=fur[0]["shade_bound"]["bound_by"], library_ms=None,
             old_bound_ms=fur[0]["shade_bound"]["old_bound_ms"],
             all_inputs_bound_ms=fur[0]["shade_bound"]["all_bytes_ms"], glue_ms=s0["glue_ms"],
             traced_ms_per_launch=per_launch(prof4, "shade_kernel"),
             bounce1_ms=fur[1]["shade"]["ms"],
             bounce1_bound_ms=fur[1]["shade_bound"]["bound_ms"],
             config5={k: dict(ms=hb[b]["shade"]["ms"],
                              plain_ms=hb[b]["shade"]["plain_ms"],
                              glue_ms=hb[b]["shade"]["glue_ms"],
                              bound_ms=hb[b]["shade"]["bound"]["bound_ms"],
                              bound_by=hb[b]["shade"]["bound"]["bound_by"])
                      for k, b in (("bounce0", 0), ("bounce1", 1))},
             config5_launches=hb_main["counts"]["shade"],
             config5_traced_ms_per_launch=per_launch(prof5, "shade_kernel")),
        dict(name="traverse_stream_cone", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/traverse_stream.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/stream.py:464",
             launches=hb_main["counts"]["stream"],
             max_abs_err=max(hb[b][k]["max_abs_err"] for b in (0, 1)
                             for k in ("closest", "shadow")),
             ms=h0["times"]["closest_ms"], plain_ms=h0["times"]["closest_plain_ms"],
             plain_rays=TWIN_RAYS, bound_ms=h0["closest_bound"]["bound_ms"],
             bound_by=h0["closest_bound"]["bound_by"], library_ms=None,
             k2_ms=h0["times"]["closest_k2_ms"], any_ms=h0["times"]["any_ms"],
             any_k2_ms=h0["times"]["any_k2_ms"], any_bound_ms=h0["any_bound"]["bound_ms"],
             any_bound_by=h0["any_bound"]["bound_by"],
             unsorted_ms=h0["times"]["closest_unsorted_ms"],
             k2_unsorted_ms=h0["times"]["closest_k2_unsorted_ms"],
             any_unsorted_ms=h0["times"]["any_unsorted_ms"],
             any_k2_unsorted_ms=h0["times"]["any_k2_unsorted_ms"],
             sort_ms=h0["times"]["sort_ms"], bounce1_ms=hb[1]["times"]["closest_ms"],
             bounce1_bound_ms=hb[1]["closest_bound"]["bound_ms"],
             bounce1_bound_by=hb[1]["closest_bound"]["bound_by"]),
        dict(name="bruteforce_tri", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/bruteforce.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/intersect.py:220",
             launches=hb_main["counts"]["bruteforce_tri"],
             max_abs_err=max(hb[k]["max_abs_err"] for k in ("k5_tri_0", "k5_tri_1",
                                                             "k5_tri_shadow")),
             ms=k5t["ms"], plain_ms=k5t["plain_ms"], bound_ms=k5t["bound"]["bound_ms"],
             bound_by=k5t["bound"]["bound_by"], library_ms=None,
             unsorted_ms=k5t["unsorted_ms"], all_pairs_bound_ms=k5t["bound"]["all_pairs_bound_ms"],
             survivors_per_tile=k5t["bound"]["survivors_per_tile"],
             exact_per_ray=k5t["bound"]["exact_per_ray"],
             entry_ratio=max(hb[k]["margin"]["entry_ratio"] for k in ("k5_tri_0", "k5_tri_1",
                                                                       "k5_tri_shadow")),
             **{f"{w}_{k}": hb[f"k5_tri_{w}"][k] for w in ("1", "shadow")
                for k in ("ms", "unsorted_ms")},
             **{f"{w}_bound_ms": hb[f"k5_tri_{w}"]["bound"]["bound_ms"] for w in ("1", "shadow")}),
        dict(name="bruteforce_cone", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/bruteforce.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/intersect.py:220",
             launches=k5_cone["launches"],
             max_abs_err=max(k5_cone[b]["max_abs_err"] for b in (0, 1)),
             ms=k5c["ms"], plain_ms=k5c["plain_ms"],
             bound_ms=k5c["bound"]["bound_ms"], bound_by=k5c["bound"]["bound_by"],
             library_ms=None, all_pairs_bound_ms=k5c["bound"]["all_pairs_bound_ms"],
             survivors_per_tile=k5c["bound"]["survivors_per_tile"],
             exact_per_ray=k5c["bound"]["exact_per_ray"],
             entry_ratio=max(k5_cone[b]["margin"]["entry_ratio"] for b in (0, 1)),
             bounce1_ms=k5_cone[1]["ms"],
             bounce1_bound_ms=k5_cone[1]["bound"]["bound_ms"]),
    ]
    return kernels_line


if __name__ == "__main__":
    sys.exit(main())
