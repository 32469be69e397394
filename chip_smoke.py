"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `ba_pathtracing_fur_torch/csrc`, checks
each against its plain torch version on the card, drives the main path
(`models/pathtracer.render_image` on the Cornell box, the JAX package's
bench configs 0 and 2) through the kernels, and checks the images. It exits
non-zero, printing no result, when there is no CUDA device, when any phase
fails, or when the package is missing. The last line of its output is
`{"ok": true, "device": {...}}`; the line before it lists each kernel with
its launches on the main path, its error against the plain version and
its time beside the plain version's. Before those lines it prints the
config-0 render time through the kernel and through the plain version, and
a torch.profiler breakdown of one config-0 sample. The config-0 image is
written to `smoke_out/smoke_config0.png` (git-ignored).
"""

from __future__ import annotations

import contextlib
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
TIMED_REPS = 3
# Per-field gate of tests/test_fused_shade.py::test_fused_single_bounce_exact.
FIELD_ATOL, FIELD_RTOL, FIELD_MAX_FRAC = 1e-4, 1e-4, 0.02
# Image gate of tests/test_fused_shade.py::_compare.
IMG_MEAN, IMG_FLIP, IMG_FLIP_FRAC = 5e-3, 1e-3, 0.02
FIELDS = ("origin", "direction", "radiance", "color", "flags", "theta_i", "prev_pdf")
OUT_DIR = Path("smoke_out")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_bounces():
    """Route every bounce through the plain torch version, on any device."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    kernel_fn = cshade.shade_bounce_full
    cshade.shade_bounce_full = cshade.shade_bounce_full_ref
    try:
        yield
    finally:
        cshade.shade_bounce_full = kernel_fn


def row_mismatch(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(fraction of rows off by more than atol + rtol*|a|, max |a - b|)."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    d = (a - b).abs()
    bad = (d > FIELD_ATOL + FIELD_RTOL * a.abs()).any(-1)
    return bad.double().mean().item(), d.max().item()


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


def time_one_bounce(dev) -> dict:
    """Kernel and plain time of one config-0 bounce (bounce 0, 921,600 rays)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins

    scene, cam = builtins.cornell_box(resolution=CONFIG0["res"], device=dev)
    cfg = render_cfg(CONFIG0, 1)
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    kw = pt.full_bounce_inputs(state, scene, keys, 0, cfg, pt.BounceTables.of(scene))

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    ms = timed(lambda: cshade.shade_bounce_full(**kw), 50)
    plain_ms = timed(lambda: cshade.shade_bounce_full_ref(**kw), 5)
    log(f"one config-0 bounce ({CONFIG0['res'][0] * CONFIG0['res'][1]} rays): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms")
    return dict(ms=ms, plain_ms=plain_ms)


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
        cshade.KERNEL_LAUNCHES = 0
        cshade.REF_CALLS = 0
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
    scene_c, cam_c = builtins.cornell_box(resolution=c["res"], variant=c["variant"])
    a = render(scene_g, cam_g, rng.key(0, dev), cfg).cpu().numpy()
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    b = pt.render_image(scene_c, cam_c, rng.key(0), cfg).numpy()
    image_gate(b, a, "glossy 32x32 card kernel vs CPU plain")


def phase_timing(scene, cam, key, cfg) -> dict:
    """Median of TIMED_REPS config-0 renders, kernel and plain, in turns."""
    w, h = cam.resolution
    rays = w * h * cfg.spp * cfg.depth
    times = {"kernel": [], "plain": []}
    for rep in range(TIMED_REPS):
        for which in (("kernel", "plain") if rep % 2 == 0 else ("plain", "kernel")):
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
        log(f"config0 render via {which}: median {med:.4f} s of {ts} "
            f"-> {rays / med:.4e} rays/s ({rays} rays: {w}x{h}, spp {cfg.spp}, "
            f"depth {cfg.depth})")
    return out


def phase_profile(scene, cam, key, cfg) -> None:
    """Where one config-0 sample's time goes: device time by kernel under
    torch.profiler, against the host wall clock of the same traced run."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(cfg, spp=1)
    render(scene, cam, key, cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(scene, cam, key, cfg)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in kernels) / 1e6
    fb = sum(dev_us(e) for e in kernels if "full_bounce" in e.key) / 1e6
    launches = sum(e.count for e in kernels)
    log(f"profile, one config-0 sample (traced): wall {wall:.4f} s, device busy {busy:.4f} s "
        f"(idle share {max(0.0, 1.0 - busy / wall):.3f}), {launches} kernel launches, "
        f"full_bounce {fb:.5f} s = {fb / max(busy, 1e-12):.4f} of device time")
    for e in sorted(kernels, key=dev_us, reverse=True)[:5]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:100]}")


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
        if "registers" in line or "Compiling entry" in line:
            log("ptxas:", line.strip())

    # threefry on the card is bit-exact with the CPU
    from ba_pathtracing_fur_torch.core import rng
    ids = torch.arange(4096)
    kc = rng.bounce_uniforms(rng.keys_for_pixels(rng.key(0), ids, 3), 2, 5, 2)
    kg = rng.bounce_uniforms(rng.keys_for_pixels(rng.key(0, dev), ids.to(dev), 3), 2, 5, 2)
    if not torch.equal(kc, kg.cpu()):
        raise AssertionError("threefry uniforms on the card differ from the CPU")
    log("threefry: card uniforms bit-identical to CPU")

    check = phase_kernel_vs_plain(dev)
    timing_bounce = time_one_bounce(dev)
    phase_small_reference(dev)
    main_res = phase_main_path(dev)
    times = phase_timing(*main_res["config0_scene"])
    phase_profile(*main_res["config0_scene"])
    log(f"config0 end to end: kernel path {times['kernel']:.4f} s, plain path "
        f"{times['plain']:.4f} s, on {card}")

    log(json.dumps({"kernels": [{
        "name": "full_bounce", "route": "cuda",
        "source": "ba_pathtracing_fur_torch/csrc/full_bounce.cu",
        "replaces": "ba_pathtracing_fur_tpu/ops/pallas/shade.py:359",
        "launches": main_res["launches"], "max_abs_err": check["max_abs_err"],
        "mismatch_frac": check["mismatch_frac"], "ms": timing_bounce["ms"],
        "plain_ms": timing_bounce["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
