"""The hair ball: the JAX package's bench config 5 as the port grows it on
the card (`scene/builtins.hair_ball(on_device=True)`), a 768-triangle scalp
and `n_fibers` fibers of `fiber_verts` vertices as cone chains, grown from
the configuration's `groom_seed`: one groom for every run, as a user renders
one groom many times (the run's seed draws the paths, not the geometry).

`program` builds it with the port and attaches the port's BVH, as a user
does; `reference` regrows it with the frozen copy of the same builder
(`furbench/furref`), without a BVH.
"""

from __future__ import annotations


def _args(params: dict, dev) -> dict:
    return dict(resolution=tuple(params["resolution"]), n_fibers=params["n_fibers"],
                fiber_verts=params["fiber_verts"], fiber_radius=params["fiber_radius"],
                sphere_radius=params["sphere_radius"], on_device=True,
                seed=params["groom_seed"], device=dev)


def program(params: dict, seed: int, dev, workdir):
    """-> (scene with its BVH, camera, the build's stage seconds)."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    scene, cam = builtins.hair_ball(**_args(params, dev))
    traverse.LAST_BUILD_STATS.clear()
    scene = traverse.attach_bvh(scene, method=params["bvh"])
    return scene, cam, {k: dict(v) for k, v in traverse.LAST_BUILD_STATS.items()}


def reference(params: dict, seed: int, dev, workdir):
    """-> (scene, camera), regrown by the frozen builder."""
    from furbench.furref.scene import builtins

    return builtins.hair_ball(**_args(params, dev))
