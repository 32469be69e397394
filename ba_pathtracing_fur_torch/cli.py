"""Command-line interface: the Demo and objToBinaryConverter executables.

Counterpart of `ba_pathtracing_fur_tpu/cli.py`, with its flags and
defaults (the Demo's 1280x720, 100 samples, depth 5: Demo/main.cpp:
185-210; the converter: objToBinaryConverter/main.cpp:14-44) and one flag
more, `--device` (default `cuda`: the card; `cpu` runs the kernels' plain
versions). A render builds the scene (a builtin or a JSON scene file with
OBJ, PLY or b3df meshes and its "Fur" section), attaches the `--accel` BVHs,
renders progressively (`--engine pt`: the JAX package's CLI config, the
unfused bounce with stream compaction) or with the Whitted raytracer, and
writes a PNG and, with `--report`, an HTML report with each BVH's overlay.
The image stays on the device until it is written.

Usage:
  python -m ba_pathtracing_fur_torch.cli render -s cornell -r 64 -W 256 -H 256 -o out.png
  python -m ba_pathtracing_fur_torch.cli render -s scene.json --engine whitted -o out.png
  python -m ba_pathtracing_fur_torch.cli render -s scene.json --device cpu -W 64 -H 36
  python -m ba_pathtracing_fur_torch.cli convert bunny.obj bunny.b3df
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

#: the builtin scenes `-s` takes besides a JSON path
BUILTIN_SCENES = ("cornell", "cornell_glossy", "fur_patch", "hair_ball")


def _build_scene(args):
    from .scene import builtins

    res = (args.width, args.height)
    dev = args.device
    if args.scene == "cornell":
        return builtins.cornell_box(resolution=res, device=dev)
    if args.scene == "cornell_glossy":
        return builtins.cornell_box(resolution=res, variant="glossy", device=dev)
    if args.scene == "fur_patch":
        return builtins.fur_patch(resolution=res, device=dev)
    if args.scene == "hair_ball":
        return builtins.hair_ball(resolution=res, device=dev)
    from .scene.graph import flatten
    from .scene.io import load_scene_json

    graph = load_scene_json(args.scene)
    if args.fur:
        n, v, r = args.fur.split(",")
        graph.add_fur_fibers_to_all_meshes(int(n), int(v), float(r))
    scene, cam = flatten(graph, device=dev)
    if cam is None:
        from .core.camera import make_camera
        cam = make_camera(position=(0, 0, 3.4), look_at=(0, 0, -1), resolution=res, device=dev)
    else:
        # the resolution only, as the JAX package replaces it
        cam = dataclasses.replace(cam, resolution=res)
    return scene, cam


def cmd_render(args) -> int:
    from .core import rng
    from .models.pathtracer import RenderConfig, render_progressive
    from .ops import traverse
    from .utils import clock as clock_mod, film, log

    scene, camera = _build_scene(args)
    build_time = None
    if args.accel != "none":
        build_clock = clock_mod.Clock()
        scene = traverse.attach_bvh(scene, method=args.accel)
        build_time = round(build_clock.elapsed(), 3)
        log.log_info("accel build (%): %s", args.accel, build_time)

    w, h = camera.resolution
    if args.engine == "whitted":
        from .models.whitted import WhittedConfig, render_whitted_jit
        cfg = WhittedConfig(depth=args.depth, supersamples=args.supersamples,
                            hair_lobes=args.hair_lobes)
        dc = clock_mod.DeviceClock()
        img = render_whitted_jit(scene, camera, cfg)
        log.log_info("whitted render: %s (% Mrays/s)", round(dc.stop(img), 3),
                     round(w * h / dc.elapsed() / 1e6, 2))
    else:
        cfg = RenderConfig(depth=args.depth, spp=args.samples, ray_chunk=args.ray_chunk,
                           tonemap=False)
        prog = clock_mod.RenderProgress(args.samples, w * h * args.depth,
                                        log_every=max(1, args.samples // 10))
        img = None
        for _, acc in render_progressive(scene, camera, rng.key(args.seed, scene.device), cfg):
            prog.update(1, acc)
            img = acc

    if args.tonemap:
        from .ops import tonemap as tm
        img = tm.tonemap(img, tm.TonemapParams(gamma=2.2))
    gamma = 1.0 if args.tonemap else 2.2
    host = img.cpu().numpy()
    film.write_png(args.output, host, gamma=gamma)
    log.log_info("wrote %", args.output)

    if args.report:
        from .utils.report import RenderReport
        rep = RenderReport(title=f"{args.scene} — {args.engine}")
        rep.add_image("render", host, gamma=gamma)
        rep.add_panel("render settings", {
            "scene": args.scene, "engine": args.engine, "resolution": f"{w}×{h}",
            "samples": args.samples, "depth": args.depth, "accel": args.accel,
            "seed": args.seed, "tonemap": args.tonemap, "device": args.device,
        })
        from .ops import bvh as bvh_mod, visualize
        for name, b in (("triangles", scene.tri_bvh), ("cones", scene.cone_bvh)):
            if b is None:
                continue
            info = bvh_mod.debug_info(b)
            if build_time is not None:
                # the wall time of every build of attach_bvh together
                info["total_build_s"] = build_time
            rep.add_panel(f"accel structure ({name})", info)
            # the overlay blends onto the display-encoded render, so it takes
            # the render's gamma
            rep.add_image(f"structure overlay ({name})",
                          visualize.visualize_structure(b, camera, base_image=img),
                          gamma=gamma)
        rep.write(args.report)
        log.log_info("wrote %", args.report)
    return 0


def cmd_convert(args) -> int:
    from .scene.binmesh import convert_obj
    from .utils import log

    convert_obj(args.input, args.output, compress=not args.raw)
    log.log_info("converted % -> %", args.input, args.output)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ba_pathtracing_fur_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene (the Demo)")
    r.add_argument("-s", "--scene", default="cornell",
                   help=f"builtin ({'|'.join(BUILTIN_SCENES)}) or scene.json")
    r.add_argument("-r", "--samples", type=int, default=100)  # the Demo's default
    r.add_argument("-W", "--width", type=int, default=1280)
    r.add_argument("-H", "--height", type=int, default=720)
    r.add_argument("-d", "--depth", type=int, default=5)
    r.add_argument("-o", "--output", default="render.png")
    r.add_argument("--engine", choices=("pt", "whitted"), default="pt")
    r.add_argument("--hair-lobes", choices=("r", "all"), default="r")
    r.add_argument("--supersamples", type=int, default=1)
    r.add_argument("--fur", default=None, help="N,V,R fur growth for json scenes")
    r.add_argument("--accel", default="median",
                   choices=("sah", "median", "morton", "grid", "none"),
                   help="accel structure (the Demo's swap, Demo/main.cpp:94-127)")
    r.add_argument("--tonemap", action="store_true")
    r.add_argument("--report", default=None, help="write an HTML render report")
    r.add_argument("--ray-chunk", type=int, default=65536)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda",
                   help="torch device of the render: cuda (the kernels) or cpu (their "
                        "plain versions)")
    r.set_defaults(fn=cmd_render)

    c = sub.add_parser("convert", help="obj -> b3df (objToBinaryConverter)")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--raw", action="store_true", help="skip compression")
    c.set_defaults(fn=cmd_convert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
