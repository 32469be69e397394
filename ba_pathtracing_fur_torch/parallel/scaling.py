"""Strong-scaling sweep of the sharded render over 1, 2, 4, ... devices.

Counterpart of `ba_pathtracing_fur_tpu/parallel/scaling.py`: the same image
rendered by `render_image_sharded` on meshes of growing device count; per
mesh the best wall seconds of `repeats` renders (after one warm-up render),
rays/s, the speedup against one device and the parallel efficiency =
speedup / devices.

    python -m ba_pathtracing_fur_torch.parallel.scaling --devices cuda:0,cuda:1

`--devices` lists the devices (default: every visible CUDA device; a
device may repeat, e.g. `cpu,cpu,cpu,cpu` for a CPU rehearsal). The JAX
package re-executes itself on virtual CPU devices; the port takes the list.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from ..models.pathtracer import RenderConfig
from .mesh import make_mesh
from .render import render_image_sharded


def _powers_of_two_up_to(n: int) -> list[int]:
    out, k = [], 1
    while k <= n:
        out.append(k)
        k *= 2
    return out


def _default_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("measure_scaling: no CUDA device is visible; pass `devices`")
    return [torch.device("cuda", i) for i in range(n)]


def _sync(devices) -> None:
    for d in sorted({str(d) for d in devices if torch.device(d).type == "cuda"}):
        torch.cuda.synchronize(d)


def measure_scaling(scene, camera, cfg: RenderConfig,
                    device_counts: Sequence[int] | None = None, geo: int = 1,
                    repeats: int = 2, devices: Sequence | None = None) -> list[dict]:
    """Render the same image on meshes of increasing device count over
    `devices` (default: every visible CUDA device, counts 1, 2, 4, ... up to
    their number) -> one row a mesh: devices, geo, wall_s (the best of
    `repeats`, after a warm-up render), rays_per_s, speedup against the
    1-device row, efficiency = speedup / devices, and the device names."""
    from ..core import rng

    devices = [torch.device(d) for d in (devices or _default_devices())]
    if device_counts is None:
        device_counts = _powers_of_two_up_to(len(devices))
    if device_counts[0] != 1:
        device_counts = [1] + [n for n in device_counts if n > 1]
    w, h = camera.resolution
    rays = float(w * h) * cfg.spp * cfg.depth
    key = rng.key(0, devices[0])
    rows: list[dict] = []
    t1 = None
    for n in device_counts:
        if n > len(devices):
            break
        g = geo if geo <= n and n % max(geo, 1) == 0 else 1
        mesh = make_mesh(n, geo=g, devices=devices)
        used = devices[:n]
        render_image_sharded(scene, camera, key, cfg, mesh)
        _sync(used)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            render_image_sharded(scene, camera, key, cfg, mesh)
            _sync(used)
            best = min(best, time.perf_counter() - t0)
        t1 = best if t1 is None else t1
        speedup = t1 / best
        rows.append({"devices": n, "geo": g, "wall_s": best, "rays_per_s": rays / best,
                     "speedup": speedup, "efficiency": speedup / n,
                     "device_names": [str(d) for d in used]})
    return rows


def scaling_panel(rows: list[dict]) -> dict:
    """Flatten the sweep into a report-panel dict (utils/report add_panel)."""
    panel = {}
    for r in rows:
        panel[f"{r['devices']}dev_rays_per_s"] = r["rays_per_s"]
        panel[f"{r['devices']}dev_efficiency"] = r["efficiency"]
    return panel


def main(argv: Sequence[str] | None = None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", default=None,
                   help="comma-separated device list (default: every visible CUDA device)")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--scene", choices=["cornell", "fur"], default="cornell")
    p.add_argument("--geo", type=int, default=1)
    args = p.parse_args(argv)

    devices = ([torch.device(d.strip()) for d in args.devices.split(",")] if args.devices
               else _default_devices())
    from ..scene.builtins import cornell_box, fur_patch
    make = fur_patch if args.scene == "fur" else cornell_box
    scene, camera = make(resolution=(args.res, args.res), device=devices[0])
    cfg = RenderConfig(depth=args.depth, spp=args.spp, ray_chunk=4096)
    rows = measure_scaling(scene, camera, cfg,
                           device_counts=_powers_of_two_up_to(len(devices)), geo=args.geo,
                           devices=devices)
    print(json.dumps({"metric": "scaling_efficiency", "scene": args.scene, "res": args.res,
                      "rows": rows}))


if __name__ == "__main__":
    main()
