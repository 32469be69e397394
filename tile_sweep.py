"""Sweep of the leaf-tile shape of the traversal kernels on one NVIDIA GPU,
and K3's two variants against a baseline build of them.

    python3 tile_sweep.py
    python3 tile_sweep.py --variants [--baseline-src DIR]

Builds `csrc/traverse.cu` (K2) and `csrc/traverse_stream.cu` (K3) once per
tile shape (rays a block, threads a block: -DFUR_TILE_RAYS / -DFUR_TILE_THREADS,
see csrc/leaf_tiles.cuh), and times each build on the entry-morton sorted
wavefronts the main path feeds them: K2 on the fur patch (bench config 4)
camera wavefront and its shadow rays, K3 on the hair ball (bench config 5)
camera wavefront and its shadow rays. Every build's (t, found) must equal
the default build's, and its closest-hit rows too. Then a build with the
kernels' work counters (-DFUR_TILE_STATS) gives, per case, the (ray, leaf)
pairs and (ray, unit) work items a ray, the leaf copies a tile, and the leaf
bytes copied into shared memory against those a read per pair would move.

With --variants it runs K3's variants instead: the tensor-core cone test
(`mxu=True`, on the f32 and the bf16 pack) and the bf16 pack's f32 test, on
config 5's four sorted wavefronts (camera, bounce 1, the bounce-0 shadow
rays, the bounce-1 pairs of the joint path) and the bf16 triangle instance
on the terrain's two (config 3's terrain on a two-level median BVH, fanout
64: camera and shadow rays), each timed beside the f32 test (CUDA events,
REPS calls a turn; the wavefronts as chip_smoke.py builds them). With
--baseline-src (a csrc directory, e.g. a parent commit's from `git archive`)
the baseline's traverse_stream.cu is built beside the port's, and each
variant is timed in TURNS rounds of baseline, port, port, baseline (the
median of each build's 2 x TURNS turns and their range printed), its
results compared with the port's (bf16: bit for bit; mxu: found and closest
rows alike), and both builds' ptxas reports and work counters printed:
leaves tested, (ray, leaf) pairs, (ray, unit) items, and the mxu instances'
mma tiles with their fill (rays a tile over its rays; a baseline mxu item
is one tile of 16 rays, which holds the f32 test's (ray, unit) items of the
same wavefront).

Prints one line per shape or case and the card's name and power limit;
exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

SHAPES = ((128, 512), (128, 256), (64, 256), (256, 512))
REPS = 10
TURNS = 4  # --variants: rounds of baseline, port, port, baseline


STATS = ("blocks", "supers", "joined", "rounds", "children", "leaves", "pairs", "copies",
         "items", "tiles")
# K3's variants: name -> (bf16 pack, mxu), and the rays of a baseline mxu tile
VARIANTS = {"f32": (False, False), "bf16": (True, False), "mxu": (False, True),
            "mxu_bf16": (True, True)}
BASE_MXU_RAYS = 16


def build(rays: int, threads: int, *flags: str) -> dict:
    """The C entry points of traverse.cu and traverse_stream.cu built with
    this tile shape and `flags`, argtypes set, and the libraries' handles."""
    from ba_pathtracing_fur_torch import kernels

    out = kernels.BUILD_DIR / f"sweep_{rays}_{threads}{''.join(flags)}"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in ("traverse.cu", "traverse_stream.cu"):
        src = kernels.SRC_DIR / name
        lib = out / f"lib{src.stem}.so"
        cmd = kernels.build_command(src, lib, kernels.nvcc_path()) + [
            f"-DFUR_TILE_RAYS={rays}", f"-DFUR_TILE_THREADS={threads}", *flags]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for tile {rays}x{threads}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        fns[lib.stem] = handle
        for fname, (src, argtypes) in kernels.SIGNATURES.items():
            if lib.name == f"lib{src[:-3]}.so":
                fn = getattr(handle, fname)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                fns[fname] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from ba_pathtracing_fur_torch import kernels
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    lib = kernels.load_library()
    scene4, cam4, cfg4, _ = cs.fur_scene(dev)
    scene5, cam5, cfg5, _ = cs.hair_ball_scene(dev)
    cases = []
    for name, scene, cam, cfg, fn in (
            ("K2 config4", scene4, cam4, cfg4, ctraverse.traverse),
            ("K3 config5", scene5, cam5, cfg5, cstream.traverse_stream)):
        bvh = scene.cone_bvh
        for wave, rays, any_hit in zip(("camera", "shadow"),
                                       cs.camera_and_shadow_rays(scene, cam, cfg, dev),
                                       (False, True)):
            o, d, t_max, _ = cs.sorted_rays(*rays, bvh)
            call = (lambda fn=fn, o=o, d=d, t_max=t_max, bvh=bvh, any_hit=any_hit:
                    fn(o, d, t_max, bvh, "cone", any_hit=any_hit))
            cases.append((f"{name} {wave}", call, any_hit))
    default = types.SimpleNamespace(**vars(lib))
    want = [call() for _, call, _ in cases]
    for rays, threads in SHAPES:
        fns = build(rays, threads)
        for fname in ("traverse_launch", "stream_launch"):
            setattr(lib, fname, fns[fname])
        times = []
        for (what, call, any_hit), ref in zip(cases, want):
            t, row, found = call()
            torch.cuda.synchronize()
            if not (torch.equal(t, ref[0]) and torch.equal(found, ref[2])
                    and (any_hit or torch.equal(row, ref[1]))):
                raise AssertionError(f"tile {rays}x{threads}, {what}: another result")
            times.append(f"{what} {cs.timed(call, REPS):.4f} ms")
        print(f"tile {rays} rays x {threads} threads: " + ", ".join(times), flush=True)
        for fname in ("traverse_launch", "stream_launch"):
            setattr(lib, fname, getattr(default, fname))
    counted = build(*SHAPES[0], "-DFUR_TILE_STATS")
    for fname in ("traverse_launch", "stream_launch"):
        setattr(lib, fname, counted[fname])
    for (what, call, _), ref in zip(cases, want):
        handle = counted["libtraverse" if what.startswith("K2") else "libtraverse_stream"]
        counts = (ctypes.c_ulonglong * 16)()
        handle.tile_stats_zero()
        call()
        torch.cuda.synchronize()
        handle.tile_stats_read(counts)
        c = dict(zip(STATS, counts))
        n_rays, bvh = ref[0].shape[0], (scene4 if what.startswith("K2") else scene5).cone_bvh
        leaf_bytes = bvh.packed[0].numel() * 4
        print(f"{what} counters ({n_rays} rays, tile {SHAPES[0][0]}): "
              + ", ".join(f"{k} {c[k]}" for k in STATS)
              + f"; pairs a ray {c['pairs'] / n_rays:.3f}, items a ray {c['items'] / n_rays:.3f}, "
              f"leaf copies a tile {c['copies'] / c['blocks']:.2f}, leaf bytes copied "
              f"{c['copies'] * leaf_bytes:.4e} against {c['pairs'] * leaf_bytes:.4e} read once "
              f"a pair", flush=True)
    for fname in ("traverse_launch", "stream_launch"):
        setattr(lib, fname, getattr(default, fname))
    print(card)
    return 0


def build_stream(src_dir: Path, out: Path, *flags: str):
    """Start nvcc of `src_dir`/traverse_stream.cu into `out` with the port's
    flags (and `flags`) -> (library path, process)."""
    from ba_pathtracing_fur_torch import kernels

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    lib = out / "libtraverse_stream.so"
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *kernels.SOURCE_FLAGS["traverse_stream.cu"],
           "-I", str(src_dir), "-o", str(lib), str(src_dir / "traverse_stream.cu"), *flags]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def load_stream(lib: Path, proc) -> tuple:
    """(library handle, stream_launch with argtypes set, ptxas of its K3
    instances) of a `build_stream` build; raises if nvcc failed."""
    from ba_pathtracing_fur_torch import kernels

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib}:\n{log}")
    handle = ctypes.CDLL(str(lib))
    fn = handle.stream_launch
    fn.argtypes, fn.restype = kernels.SIGNATURES["stream_launch"][1], ctypes.c_int
    saved = kernels.LAST_BUILD_LOG
    kernels.LAST_BUILD_LOG = log
    try:
        ptx = {k: v for k, v in cs.ptxas_report().items() if k.startswith("K3 ")}
    finally:
        kernels.LAST_BUILD_LOG = saved
    return handle, fn, ptx


def config5_waves(scene, cam, cfg, dev) -> dict:
    """Config 5's wavefronts as chip_smoke.py feeds K3's variants, entry-morton
    sorted: the camera rays, their shadow rays, the bounce-1 rays and the
    bounce-1 pairs of the joint path (`traverse.joint_wavefront`) -> name:
    (o, d, t_max, is_any, any_hit)."""
    from ba_pathtracing_fur_torch.ops import traverse

    bvh = scene.cone_bvh
    cam_w, shadow_w = cs.camera_and_shadow_rays(scene, cam, cfg, dev)
    pairs = cs.bounce1_pairs(scene, cam, cfg, dev)
    o2, d2, t2, is_any, _ = traverse.joint_wavefront(*pairs, bvh)
    return {"camera": (*cs.sorted_rays(*cam_w, bvh)[:3], None, False),
            "shadow": (*cs.sorted_rays(*shadow_w, bvh)[:3], None, True),
            "bounce1": (*cs.sorted_rays(*pairs[:3], bvh)[:3], None, False),
            "pairs": (o2, d2, t2, is_any, False)}


def terrain_waves(dev) -> tuple:
    """The terrain of chip_smoke.phase_stream_tri and its sorted camera and
    shadow wavefronts -> (bvh, name: (o, d, t_max, None, any_hit))."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    scene, cam = cs.terrain_stream(dev)
    bvh = scene.tri_bvh
    cfg = pt.RenderConfig(depth=4, spp=1, compact=False, fused_shading=True)
    cam_w, shadow_w = cs.camera_and_shadow_rays(scene, cam, cfg, dev)
    return bvh, {"terrain camera": (*cs.sorted_rays(*cam_w, bvh)[:3], None, False),
                 "terrain shadow": (*cs.sorted_rays(*shadow_w, bvh)[:3], None, True)}


def fill(c: dict, f32_items: int, baseline: bool) -> float:
    """Rays a tile over its rays: a port build's (ray, unit) items over
    UNIT_RAYS x its unit-major tiles; a baseline build's mxu items are its
    tiles of BASE_MXU_RAYS rays, holding the f32 test's (ray, unit) items."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    if baseline:
        return f32_items / max(1, BASE_MXU_RAYS * c["items"])
    return c["items"] / max(1, ctraverse.UNIT_RAYS * c["tiles"])


def main_variants(baseline_src) -> int:
    from ba_pathtracing_fur_torch import kernels
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    lib = kernels.load_library()
    port_fn = lib.stream_launch
    root = kernels.BUILD_DIR / "variants"
    jobs = {"port_stats": build_stream(kernels.SRC_DIR, root / "port_stats", "-DFUR_TILE_STATS")}
    if baseline_src:
        base = Path(baseline_src).resolve()
        jobs["base"] = build_stream(base, root / "base")
        jobs["base_stats"] = build_stream(base, root / "base_stats", "-DFUR_TILE_STATS")
    scene5, cam5, cfg5, _ = cs.hair_ball_scene(dev)
    cases = [(name, wf, scene5.cone_bvh, "cone") for name, wf in
             config5_waves(scene5, cam5, cfg5, dev).items()]
    tri, tri_waves = terrain_waves(dev)
    cases += [(name, wf, tri, "tri") for name, wf in tri_waves.items()]
    packs = {id(b): {False: b, True: cstream.pack_prim_hbm(b, k, torch.bfloat16)}
             for b, k in ((scene5.cone_bvh, "cone"), (tri, "tri"))}
    builds = {k: load_stream(*v) for k, v in jobs.items()}
    for name, (_, _, ptx) in builds.items():
        for k, v in ptx.items():
            print(f"ptxas {name} {k}: {v}", flush=True)
    fns = {"port": port_fn, **{k: v[1] for k, v in builds.items()}}

    def use(which):
        lib.stream_launch = fns[which]

    for name, (o, d, t_max, is_any, any_hit), bvh, kind in cases:
        closest = torch.full((o.shape[0],), not any_hit, device=dev) if is_any is None \
            else ~is_any
        res, runs = {}, {}
        for v, (b16, mxu) in VARIANTS.items():
            if kind == "tri" and mxu:
                continue
            pack = packs[id(bvh)][b16]
            runs[v] = (lambda pack=pack, mxu=mxu: cstream.traverse_stream(
                o, d, t_max, pack, kind, any_hit=any_hit, is_any=is_any, mxu=mxu))
            use("port")
            got = runs[v]()
            order = ["base", "port"] if baseline_src and v != "f32" else ["port"]
            for which in order:
                if which == "port":
                    continue
                use(which)
                want = runs[v]()
                torch.cuda.synchronize()
                same = dict(found=float((got[2] == want[2]).double().mean()),
                            rows=float(((got[1] == want[1]) | ~closest | ~got[2])
                                       .double().mean()),
                            t=float(((got[0] == want[0]) | ~got[2]).double().mean()))
                if not mxu and min(same.values()) < 1.0:
                    raise AssertionError(f"{name} {v}: the {which} build's bf16 results differ "
                                         f"from the port's: {same}")
                res[f"{v} {which} vs port"] = same
            times = {k: [] for k in order}
            for which in (order + order[::-1]) * TURNS:  # baseline, port, port, baseline
                use(which)
                times[which].append(cs.timed(runs[v], REPS))
            use("port")
            res[v] = {k: float(np.median(x)) for k, x in times.items()}
            res[f"{v} range"] = {k: f"{min(x):.4f}-{max(x):.4f} ms over {len(x)} turns"
                                 for k, x in times.items()}
        f32_ms = res["f32"]["port"]
        print(f"K3 variants, {name} ({o.shape[0]} rays): f32 test {f32_ms:.4f} ms; "
              + "; ".join(f"{v} " + ", ".join(f"{k} {t:.4f} ms ({t / f32_ms:.3f}x the f32 test)"
                                              for k, t in res[v].items())
                          for v in runs if v != "f32")
              + "".join(f"; {k}: {x}" for k, x in res.items() if "vs" in k or "range" in k),
              flush=True)
        stat_builds = [("port", "port_stats")] + ([("base", "base_stats")] if baseline_src
                                                  else [])
        f32_items = {}
        for label, build in stat_builds:
            handle = builds[build][0]
            use(build)
            for v in runs:
                if label == "base" and v == "f32":
                    continue
                counts = (ctypes.c_ulonglong * 16)()
                handle.tile_stats_zero()
                runs[v]()
                torch.cuda.synchronize()
                handle.tile_stats_read(counts)
                c = dict(zip(STATS, counts))
                if label == "port" and not VARIANTS[v][1]:
                    f32_items[VARIANTS[v][0]] = c["items"]
                extra = ""
                if c["tiles"] or (label == "base" and VARIANTS[v][1]):
                    fl = fill(c, f32_items[VARIANTS[v][0]], label == "base")
                    tiles = c["items"] if label == "base" else c["tiles"]
                    extra = f", unit-major tiles {tiles}, fill {fl:.4f}"
                print(f"counters {label} {v}, {name}: leaves {c['leaves']}, pairs {c['pairs']}, "
                      f"items {c['items']}, copies {c['copies']}; pairs a ray "
                      f"{c['pairs'] / o.shape[0]:.3f}, items a ray {c['items'] / o.shape[0]:.3f}"
                      + extra, flush=True)
        use("port")
    print(card)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="K2/K3 tile sweep, or K3's variants")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--baseline-src", default=None,
                    help="a csrc directory whose traverse_stream.cu is the baseline")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    # config 5's BVH builds use the perm cache: a temporary directory of this run
    cache = tempfile.mkdtemp(prefix="bvh_cache_")
    os.environ["BAPT_BVH_CACHE_DIR"] = cache
    try:
        rc = main_variants(a.baseline_src) if a.variants else main()
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    sys.exit(rc)
