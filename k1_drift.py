"""The shade kernel (K1) against a baseline build of it, on one NVIDIA GPU.

    python3 k1_drift.py [--baseline-src DIR]

First measures how torch's own CUDA ops round (`torch_rounding`: the sum
of a 3-vector's products, torch.linalg.cross, a division by a Python
float), which K1's plain version inherits and `csrc/shade_core.cuh`
mirrors. Then builds a baseline K1 beside the port's own build: the
`shade.cu` of DIR (default: this tree's `csrc`) with FMA contraction on
(the flags of `kernels.NVCC_FLAGS` without the `-fmad=false` of
`kernels.SOURCE_FLAGS`), which for an earlier checkout's `csrc` is that
checkout's build. It holds both against K1's plain version on the fused
path's bounces of the fur patch (bench config 4, bounces 0-3), the hair
ball (bench config 5, bounces 0-1) and the CLI skin
(`chip_smoke.write_skin_scene`, bounces 0-1): per build, the largest
fraction of rows of a field off by more than 1e-4 + 1e-4 |x| (the
per-field gate of `chip_smoke.compare_shade`) and the largest |diff|; on
bounce 0 the share per field and the shading branches of the rows off;
both builds timed in turns (baseline, port, port, baseline; CUDA events
over 50 calls). Then it renders config 4 at spp 8 and the CLI skin at spp
16 through each build,
and gives the image gate's numbers (mean |diff|, the share of pixels off by
more than 1e-3) against config 4 rendered through K1's plain version and
against the unfused CLI render. Prints one line per case and the card's
name and power limit; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import time
import types

import numpy as np
import torch

import chip_smoke as cs

REPS = 50
BUILDS = ("port", "baseline")


def torch_rounding(dev) -> dict:
    """How torch's own CUDA ops round, which the plain version inherits and
    K1 mirrors (csrc/shade_core.cuh: dot, cross, divisions by constants):
    the share of 2^20 random inputs on which each op equals each candidate
    formula, the candidates evaluated exactly in float64 and rounded once
    to float32 (so an FMA is emulated exactly)."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(1 << 20, 3, generator=g), torch.randn(1 << 20, 3, generator=g)
    x = torch.rand(1 << 20, generator=g) * 10
    A, B, X = a.double().numpy(), b.double().numpy(), x.numpy()
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)  # noqa: E731
    res = {}
    cross = torch.linalg.cross(a.to(dev), b.to(dev)).cpu().numpy()
    for k, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
        p, q = A[:, i] * B[:, j], A[:, j] * B[:, i]
        res[f"cross[{k}]"] = dict(
            plain=float(np.mean(cross[:, k] == f32(f32(p) - f32(q)))),
            fma_first=float(np.mean(cross[:, k] == f32(p - f32(q)))))
    prod = (a * b).numpy()
    s = (a.to(dev) * b.to(dev)).sum(-1).cpu().numpy()
    res["sum of 3"] = {"(x+y)+z": float(np.mean(s == (prod[:, 0] + prod[:, 1]) + prod[:, 2])),
                       "(x+z)+y": float(np.mean(s == (prod[:, 0] + prod[:, 2]) + prod[:, 1]))}
    q = (x.to(dev) / math.pi).cpu().numpy()
    res["x / pi"] = {"ieee": float(np.mean(q == X / np.float32(math.pi))),
                     "x * (1/pi)": float(np.mean(q == X * (np.float32(1) / np.float32(math.pi))))}
    cs.log(f"torch's CUDA rounding (share of 2^20 inputs equal to each formula): "
           f"{json.dumps(res)}")
    return res


def start_baseline_build(src_dir):
    """nvcc of `src_dir`/shade.cu with contraction on, started -> (library
    path, process)."""
    from ba_pathtracing_fur_torch import kernels

    out = kernels.BUILD_DIR / "k1_baseline"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libshade.so"
    src_dir = cs.Path(src_dir).resolve()
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(src_dir), "-o",
           str(lib), str(src_dir / "shade.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def load_baseline(lib, proc) -> dict:
    """The shade.cu entry points of the baseline build, argtypes set."""
    from ba_pathtracing_fur_torch import kernels

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the baseline shade.cu:\n{log}")
    handle = ctypes.CDLL(str(lib))
    fns = {}
    for name, (src, argtypes) in kernels.SIGNATURES.items():
        if src == "shade.cu":
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = fn
    return fns


@contextlib.contextmanager
def build(which: str, baseline: dict):
    """K1's wrappers launch the `which` build ("port" or "baseline")."""
    from ba_pathtracing_fur_torch import kernels

    base = kernels.load_library()
    if which == "baseline":
        kernels._lib = types.SimpleNamespace(**{**vars(base), **baseline})
    try:
        yield
    finally:
        kernels._lib = base


@contextlib.contextmanager
def plain_shade():
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    fn = cshade.shade_bounce
    cshade.shade_bounce = cshade.shade_bounce_ref
    try:
        yield
    finally:
        cshade.shade_bounce = fn


def bounces(scene, cam, cfg, n, name, baseline, dev) -> list:
    """Both builds against the plain version on bounces 0..n-1 of sample 0
    (the plain version's output feeds the next bounce), timed in turns."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    w, h = cam.resolution
    tables = pt.BounceTables.of(scene)
    state, keys = pt.camera_wavefront(cam, torch.arange(w * h, device=dev), rng.key(0, dev),
                                      [0], cfg)
    rows = []
    for bounce in range(n):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        hit = traverse.closest_hit(state.origin, state.direction, scene,
                                   t_max=torch.where(alive, traverse.INF, 0.0))
        kw = pt.shade_inputs(state, scene, keys, bounce, cfg, hit, tables)
        want = cshade.shade_bounce_ref(**kw)
        row = dict(bounce=bounce, rays=w * h)
        outs = {}
        for which in BUILDS:
            with build(which, baseline):
                got = outs[which] = cshade.shade_bounce(**kw)
            torch.cuda.synchronize()
            k1 = dict(worst_frac=0.0, max_abs_err=0.0, max_rel_err=0.0)
            cs.compare_shade(got, want, f"{name} bounce {bounce} ({which})", k1)
            row[which] = k1
        if bounce == 0:
            row["off"] = off_rows(kw, outs, want, f"{name}_b{bounce}")
        times = {b: [] for b in BUILDS}
        for which in BUILDS[::-1] + BUILDS + BUILDS + BUILDS[::-1]:
            with build(which, baseline):
                times[which].append(cs.timed(lambda: cshade.shade_bounce(**kw), REPS))
        for which in BUILDS:
            row[which]["ms"] = float(np.median(times[which]))
            row[which]["ms_reps"] = times[which]
        cs.log(f"K1 {name} bounce {bounce} ({w * h} rays): " + "; ".join(
            f"{b}: rows off {row[b]['worst_frac']:.6f}, max |diff| {row[b]['max_abs_err']:.3e}, "
            f"{row[b]['ms']:.4f} ms (reps {['%.4f' % t for t in row[b]['ms_reps']]})"
            for b in BUILDS))
        rows.append(row)
        blocked = traverse.any_hit(want["shadow_o"], want["shadow_d"], scene,
                                   want["shadow_tmax"])
        color = want["color"] + torch.where(blocked[:, None], 0.0, want["direct_rgb"])
        state = pt.RayState(origin=want["origin"], direction=want["direction"],
                            radiance=want["radiance"], color=color, flags=want["flags"],
                            theta_i=want["theta_i"], prev_pdf=want["prev_pdf"])
    return rows


def off_rows(kw, outs, want, tag) -> dict:
    """Per build and field, the share of rows off (compare_shade's gate),
    and the shading branches (`cshade.branch_classes`) of the rows off."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    r = kw["origin"].shape[0]
    live = want["shadow_tmax"] > 0
    res, any_off = {}, torch.zeros(r, dtype=torch.bool, device=live.device)
    for which, got in outs.items():
        per = {}
        for f in cs.SHADE_FIELDS + ("shadow_o", "shadow_d"):
            a = want[f].double().reshape(r, -1)
            b = got[f].double().reshape(r, -1)
            bad = ((a - b).abs() > cs.FIELD_ATOL + cs.FIELD_RTOL * a.abs()).any(-1)
            if f in ("shadow_o", "shadow_d"):
                bad &= live
            per[f] = float(bad.double().mean())
            any_off |= bad
        res[which] = per
    cls = cshade.branch_classes(kw)

    def counts(c):
        return {int(k): int(n) for k, n in zip(*torch.unique(c, return_counts=True))}

    res["classes_off"], res["classes_all"] = counts(cls[any_off]), counts(cls)
    cs.log(f"K1 rows off, {tag}: {json.dumps(res)}")
    return res


def gate_numbers(ref: np.ndarray, img: np.ndarray) -> dict:
    d = np.abs(ref.astype(np.float64) - img.astype(np.float64))
    mean, flips = float(d.mean()), float(np.mean(d.max(-1) > cs.IMG_FLIP))
    return dict(mean=mean, flips=flips,
                passes=bool(mean < cs.IMG_MEAN and flips <= cs.IMG_FLIP_FRAC))


def images(scene, cam, cfg, ref: np.ndarray, name, what, baseline, dev) -> dict:
    """The fused render through each build against `ref` (image gate numbers)."""
    from ba_pathtracing_fur_torch.core import rng

    out = {}
    for which in BUILDS:
        with build(which, baseline):
            t0 = time.perf_counter()
            img = cs.render(scene, cam, rng.key(0, dev), cfg).cpu().numpy()
            wall = time.perf_counter() - t0
        out[which] = dict(gate_numbers(ref, img), wall=wall)
        cs.log(f"K1 {name} fused image spp {cfg.spp} ({which} build) against {what}: mean "
               f"|diff| {out[which]['mean']:.3e}, pixels off by > {cs.IMG_FLIP}: "
               f"{out[which]['flips']:.4f} (the gate: mean < {cs.IMG_MEAN}, <= "
               f"{cs.IMG_FLIP_FRAC}) -> {'passes' if out[which]['passes'] else 'fails'}; "
               f"render {wall:.3f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_drift: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from ba_pathtracing_fur_torch import kernels
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene.graph import flatten
    from ba_pathtracing_fur_torch.scene.io import load_scene_json

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(card)
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--baseline-src", default=None,
                   help="the csrc directory of the baseline build (default: this tree's)")
    args = p.parse_args()
    lib, proc = start_baseline_build(args.baseline_src or kernels.SRC_DIR)
    res = dict(torch_rounding=torch_rounding(dev))
    kernels.load_library()
    baseline = load_baseline(lib, proc)
    cs.log(f"shade.cu: port {kernels.SRC_DIR} with {kernels.SOURCE_FLAGS.get('shade.cu', ())}; "
           f"baseline {args.baseline_src or kernels.SRC_DIR} with FMA contraction on")

    scene4, cam4, cfg4, _ = cs.fur_scene(dev)
    res["config4"] = bounces(scene4, cam4, cfg4, cfg4.depth, "config4", baseline, dev)
    with plain_shade():
        ref4 = cs.render(scene4, cam4, rng.key(0, dev), cfg4).cpu().numpy()
    res["config4_image"] = images(scene4, cam4, cfg4, ref4, "config4",
                                  "the render through K1's plain version", baseline, dev)
    del scene4

    scene5, cam5, cfg5, _ = cs.hair_ball_scene(dev)
    res["config5"] = bounces(scene5, cam5, cfg5, 2, "config5", baseline, dev)
    del scene5

    c = cs.CLI
    path = cs.write_skin_scene(cs.CLI_DIR, c["quads"], c["res"], dev)
    scene, cam = flatten(load_scene_json(str(path)), device=dev)
    scene = traverse.attach_bvh(scene, method="median")
    cam = dataclasses.replace(cam, resolution=c["res"])
    fused = pt.RenderConfig(depth=c["depth"], spp=c["spp"], fused_shading=True)
    res["cli"] = bounces(scene, cam, fused, 2, "cli skin", baseline, dev)
    unfused = cs.render(scene, cam, rng.key(0, dev), pt.RenderConfig(
        depth=c["depth"], spp=c["spp"])).cpu().numpy()
    res["cli_image"] = images(scene, cam, fused, unfused, "cli skin",
                              "the unfused CLI render", baseline, dev)
    cs.log(card)
    cs.log("k1_drift: " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
