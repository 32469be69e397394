"""Which kernel answers a pack, and the seams around that choice.

* `ops/traverse.route` names the kernel of each pack ("k3", "k2", "k5",
  "grid", or None for an empty pack), and `closest_hit` / `any_hit` run
  exactly that kernel's plain twin (counted by its module's REF_CALLS);
  `joint_eligible` is read off the routes.
* No kernel module under `ops/cuda/` imports the dispatcher `ops/traverse`.
* `parallel/render.shard_scene_bvh` finishes its BVHs with
  `traverse.finish_bvh`: at one shard it gives the packed rows, boxes and
  pack fact of the finishing step called directly.

No jax import.
"""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from ba_pathtracing_fur_torch.ops import bvh as bvh_mod, intersect as isect, traverse
from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, stream as cstream, \
    traverse as ctraverse
from ba_pathtracing_fur_torch.parallel import render as prender
from ba_pathtracing_fur_torch.scene import builtins, types

CPU = torch.device("cpu")
PKG = Path(traverse.__file__).resolve().parents[1]
#: the K5 threshold of these tests: the scalp's 768 triangles reach it at 22 rays
BRUTE_MIN = 1 << 14


def _ball(**attach):
    scene, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=600, device=CPU)
    return traverse.attach_bvh(scene, method="median", **attach) if attach else scene


def _rays(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g) * 0.2
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return o, d


def _counts():
    return cstream.REF_CALLS, ctraverse.REF_CALLS, cisect.REF_CALLS


#: case -> (scene maker, kind, rays, route, which of _counts() runs)
ROUTES = {
    "k3": (lambda: _ball(leaf_size=16, fanout=8), "cone", 64, "k3", 0),
    "k2": (lambda: _ball(leaf_size=16, fanout=0), "cone", 64, "k2", 1),
    "k5": (_ball, "tri", -(-BRUTE_MIN // 768), "k5", 2),
    "grid": (_ball, "tri", BRUTE_MIN // 768, "grid", None),
    "empty": (_ball, "cone", 64, None, None),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_names_the_kernel_the_queries_run(case, monkeypatch):
    """Each route on a scene whose other pack is empty: `route`'s name, and
    one closest hit and one any hit run that kernel's twin once each and
    no other kernel (the dense grid and an empty pack none)."""
    monkeypatch.setattr(traverse, "_BRUTE_MIN", BRUTE_MIN)
    make, kind, n, want, runs = ROUTES[case]
    scene = make()
    if case == "empty":
        scene = dataclasses.replace(scene, cones=types.empty_cone_pack(), cone_bvh=None)
    other = "tris" if kind == "cone" else "cones"
    empty = types.empty_triangle_pack() if kind == "cone" else types.empty_cone_pack()
    scene = dataclasses.replace(scene, **{other: empty, other[:-1] + "_bvh": None})
    pack = scene.cones if kind == "cone" else scene.tris
    bvh = scene.cone_bvh if kind == "cone" else scene.tri_bvh
    assert traverse.route(pack, bvh, n) == want
    o, d = _rays(n, 3)
    before = _counts()
    hit = traverse.closest_hit(o, d, scene)
    blocked = traverse.any_hit(o, d, scene, torch.full((n,), 1.0))
    ran = [b - a for a, b in zip(before, _counts())]
    assert ran == [2 if i == runs else 0 for i in range(3)]
    assert hit.t.shape == blocked.shape == (n,)
    if want is not None:
        assert hit.valid.any()


@pytest.mark.parametrize("fanout,eligible", [(8, True), (0, False)])
def test_joint_eligible_reads_the_routes(fanout, eligible):
    """The hair ball on its two-level cone BVH (K3) with the scalp BVH-less
    shares one mixed launch; on a flat cone BVH (K2) it does not."""
    scene = _ball(leaf_size=16, fanout=fanout)
    assert scene.tri_bvh is None
    assert traverse.route(scene.cones, scene.cone_bvh, 0) == ("k3" if fanout else "k2")
    assert traverse.joint_eligible(scene) == eligible


def _imported_modules(path: Path):
    """The absolute names of every module `path` imports, relative imports
    resolved against its package, `from X import name` also as X.name."""
    package = ".".join(path.relative_to(PKG.parent).with_suffix("").parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.split(".")[:len(package.split(".")) - node.level + 1]
                base = ".".join(parent + ([base] if base else []))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def test_no_kernel_module_imports_the_dispatcher():
    """`ops/cuda/*` keeps each kernel's plain version beside its kernel:
    none of its modules imports `ops/traverse`, which dispatches to them."""
    files = sorted((PKG / "ops" / "cuda").rglob("*.py"))
    assert files
    dispatcher = "ba_pathtracing_fur_torch.ops.traverse"
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m == dispatcher or m.startswith(dispatcher + ".")]
    assert not bad
    # the resolution itself: cuda/stream's `from . import traverse` is K2's module
    assert "ba_pathtracing_fur_torch.ops.cuda.traverse" in set(
        _imported_modules(PKG / "ops" / "cuda" / "stream.py"))


def test_shard_scene_bvh_at_one_shard_is_finish_bvh():
    """One geometry shard: `shard_scene_bvh`'s packs and (squeezed) BVHs
    equal a median split finished by `traverse.finish_bvh` directly, on both
    kinds: the reordered pack, the packed rows, the boxes, the unit boxes,
    the row table, the perm and the pack fact `far_inert`."""
    scene = _ball()
    sharded = prender.shard_scene_bvh(scene, 1)
    for kind, pack, aabbs in (("tri", scene.tris, isect.triangle_aabbs),
                              ("cone", scene.cones, isect.cone_aabbs)):
        b = bvh_mod.build_median(*aabbs(pack), traverse.auto_leaf_size(pack.count))
        b.fanout = traverse.auto_fanout(b.n_leaves)
        want_pack, want = traverse.finish_bvh(pack, b, kind)
        got_pack = sharded.tris if kind == "tri" else sharded.cones
        got = sharded.tri_bvh if kind == "tri" else sharded.cone_bvh
        assert got.geo_stacked and got.far_inert == want.far_inert
        assert want.far_inert == (kind == "cone")
        for f in dataclasses.fields(want_pack):
            assert torch.equal(getattr(got_pack, f.name), getattr(want_pack, f.name)), f.name
        for f in ("packed", "bmin", "bmax", "uboxes", "aos_rows", "perm"):
            assert torch.equal(getattr(got, f)[0], getattr(want, f)), (kind, f)
