"""Sweep of the leaf-tile shape of the traversal kernels on one NVIDIA GPU.

    python3 tile_sweep.py

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
Prints one line per shape and per case and the card's name and power limit;
exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import types

import torch

import chip_smoke as cs

SHAPES = ((128, 512), (128, 256), (64, 256), (256, 512))
REPS = 10


STATS = ("blocks", "supers", "joined", "rounds", "children", "leaves", "pairs", "copies",
         "items")


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


if __name__ == "__main__":
    sys.exit(main())
