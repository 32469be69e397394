"""Sharded rendering: pixels over the "dp" axis, geometry over "geo".

Counterpart of `ba_pathtracing_fur_tpu/parallel/render.py`. The JAX package
runs one `shard_map` program per sample; here one process drives the mesh
(`parallel/mesh.Mesh`):

  * each dp row renders its share of the global pixel ids on its first
    device, through `models/pathtracer.render_sample_ids`, whose keys depend
    on the global pixel id, so any split renders as the whole image does;
  * the padded primitive packs are split into `geo` equal row ranges, each
    shard's pack slice (and its BVH, from `shard_scene_bvh`) on its own
    device of the row. The row's closest hits run on every shard
    (`traverse.closest_hit`: a traversal kernel per BVH, K5 or the dense
    grid per BVH-less pack) and are merged on the row's device with the
    JAX package's tie rule (`_merge_hits_over_geo`); its shadow rays are
    blocked when any shard blocks them (`geo_occlude_fn`);
  * materials, lights, the environment and the textures are replicated.

The Hit carries its payload (normal, uv, material, fiber frame) from the
shard that won, and its prim_id is global (`shard_scene_bvh` globalizes the
slot permutation; a BVH-less shard's row is offset by the shards before
it), so no shading step reads a pack by a hit's index.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core import camera as cam_mod
from ..models.pathtracer import BounceTables, RenderConfig, render_sample_ids
from ..ops import bruteforce
from ..scene.types import ConePack, DeviceScene, TrianglePack, to_device
from .mesh import DP_AXIS, GEO_AXIS, Mesh


# ---------------------------------------------------------------------------
# Geometry padding / sharding
# ---------------------------------------------------------------------------

def _pad_rows(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), value)])


def _pad_tris(tris: TrianglePack, to: int) -> TrianglePack:
    """Pad with degenerate (all-zero) triangles: det == 0, never hit."""
    pad = to - tris.count
    if pad <= 0:
        return tris
    return TrianglePack(**{f.name: _pad_rows(getattr(tris, f.name), pad)
                           for f in dataclasses.fields(TrianglePack)})


def _pad_cones(cones: ConePack, to: int) -> ConePack:
    """Pad with inert cones whose axis slab is empty (min_d = 1 > max_d = -1)."""
    pad = to - cones.count
    if pad <= 0:
        return cones
    fill = {"min_d": 1.0, "max_d": -1.0}
    return ConePack(**{f.name: _pad_rows(getattr(cones, f.name), pad, fill.get(f.name, 0.0))
                       for f in dataclasses.fields(ConePack)})


def pad_scene_geo(scene: DeviceScene, n_geo: int) -> DeviceScene:
    """Pad primitive counts to multiples of n_geo (an empty pack to n_geo
    inert rows, as the JAX package does) so the packs split evenly."""
    def up(n):
        return int(-(-max(n, 1) // n_geo) * n_geo)

    return dataclasses.replace(scene, tris=_pad_tris(scene.tris, up(scene.tris.count)),
                               cones=_pad_cones(scene.cones, up(scene.cones.count)))


def scene_geo_bytes(scene: DeviceScene) -> int:
    """Bytes of primitive-pack storage (the arrays the "geo" axis shards).
    BVH layouts scale with the same factor, so this is the capacity-planning
    number of the geo axis."""
    return sum(getattr(pack, f.name).numel() * getattr(pack, f.name).element_size()
               for pack in (scene.tris, scene.cones) for f in dataclasses.fields(pack))


def required_geo(scene: DeviceScene, per_device_budget_bytes: int, max_geo: int = 64) -> int:
    """Smallest power-of-two geo factor whose per-device pack slice fits
    `per_device_budget_bytes`. The geo axis is a capacity axis, not a speed
    axis: where one device holds the scene, sharding only adds the merge;
    where it does not, sharding is what makes the render possible. Raises
    if even `max_geo` shards do not fit."""
    need = scene_geo_bytes(scene)
    g = 1
    while need > per_device_budget_bytes * g:
        g *= 2
        if g > max_geo:
            raise ValueError(f"scene packs ({need / 1e6:.0f} MB) exceed "
                             f"{max_geo} x {per_device_budget_bytes / 1e6:.0f} MB")
    return g


def scene_partition_specs(scene: DeviceScene, geo_axis: str = GEO_AXIS) -> dict:
    """Which fields of `scene` the mesh shards: {field: geo_axis} for the
    primitive packs (split on their rows) and for BVHs built per shard
    (`shard_scene_bvh`, split on their leading stack axis); {field: None}
    for the replicated ones (materials, lights, environment, textures, a
    BVH over the whole scene)."""
    def bvh_spec(b):
        return geo_axis if b is not None and b.geo_stacked else None

    return dict(tris=geo_axis, cones=geo_axis, materials=None, lights=None, env=None,
                textures=None, tri_bvh=bvh_spec(scene.tri_bvh),
                cone_bvh=bvh_spec(scene.cone_bvh))


def _slice_pack(pack, lo: int, hi: int):
    return type(pack)(**{f.name: getattr(pack, f.name)[lo:hi]
                         for f in dataclasses.fields(pack)})


def _stack_bvhs(bvhs: list):
    """One BVH whose tensors are the shards' stacked on a leading axis; its
    `far_inert` holds where every shard's does."""
    first = bvhs[0]
    out = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = torch.stack([getattr(b, f.name) for b in bvhs])
    return dataclasses.replace(first, geo_stacked=True,
                               far_inert=all(b.far_inert for b in bvhs), **out)


def shard_scene_bvh(scene: DeviceScene, n_geo: int, method: str = "median",
                    leaf_size: int | None = None, fanout: int | None = None) -> DeviceScene:
    """A geometry-sharded scene with one BVH per shard (any of
    `traverse.ACCEL_BUILDERS`). The packs are padded to n_geo equal ranges
    of S rows; each range is built and reordered on its own, so shard i's
    rows are rows [i*S', (i+1)*S') of the concatenated reordered pack (S'
    the slots of a shard). The BVHs' tensors carry a leading [n_geo] axis
    (`geo_stacked`); `perm` maps a slot to the GLOBAL original primitive
    id. All shards share (n_leaves, leaf_size, fanout)."""
    from ..ops import bvh as bvh_mod, intersect as isect, traverse

    if scene.tri_bvh is not None or scene.cone_bvh is not None:
        raise ValueError("shard_scene_bvh takes a scene without BVHs")
    scene = pad_scene_geo(scene, n_geo)
    build = traverse.ACCEL_BUILDERS[method]

    def build_stack(pack, kind, aabb_fn, reorder_fn, pack_fn):
        n = pack.count
        if n < n_geo:
            return pack, None
        m = n // n_geo
        k = leaf_size or traverse.auto_leaf_size(m)
        bvhs, packs = [], []
        for i in range(n_geo):
            part = _slice_pack(pack, i * m, (i + 1) * m)
            b = build(*aabb_fn(part), k)
            b.fanout = traverse.auto_fanout(b.n_leaves) if fanout is None else fanout
            rp = reorder_fn(part, b)
            b = traverse._cache_kernel_layouts(pack_fn(rp, b), kind, rp)
            b.perm = torch.where(b.perm >= 0, b.perm + i * m, -1).to(torch.int32)
            bvhs.append(b)
            packs.append(rp)
        cat = type(pack)(**{f.name: torch.cat([getattr(p, f.name) for p in packs])
                            for f in dataclasses.fields(pack)})
        return cat, _stack_bvhs(bvhs)

    tris, tri_bvh = build_stack(scene.tris, "tri", isect.triangle_aabbs, bvh_mod.reorder_tris,
                                bvh_mod.pack_tris)
    cones, cone_bvh = build_stack(scene.cones, "cone", isect.cone_aabbs,
                                  bvh_mod.reorder_cones, bvh_mod.pack_cones)
    return dataclasses.replace(scene, tris=tris, cones=cones, tri_bvh=tri_bvh,
                               cone_bvh=cone_bvh)


def _squeeze_local_bvhs(scene: DeviceScene) -> DeviceScene:
    """A shard's scene: drop the leading stack axis (size 1 in the shard)
    from geo-stacked BVHs so `ops/traverse` sees ordinary BVHs."""
    def sq(b):
        if b is None or not b.geo_stacked:
            return b
        return dataclasses.replace(b, geo_stacked=False, **{
            f.name: getattr(b, f.name)[0] for f in dataclasses.fields(b)
            if isinstance(getattr(b, f.name), torch.Tensor)})

    return dataclasses.replace(scene, tri_bvh=sq(scene.tri_bvh), cone_bvh=sq(scene.cone_bvh))


def geo_shards(scene: DeviceScene, n_geo: int) -> list:
    """The n_geo shard scenes of a padded scene: each its own pack objects
    (K5 keeps tables per pack) over its row range, its BVHs squeezed. A
    BVH over the whole scene is kept only when n_geo is 1."""
    for b in (scene.tri_bvh, scene.cone_bvh):
        if b is not None and not b.geo_stacked and n_geo > 1:
            raise ValueError("a BVH over the whole scene cannot be split over geo shards: "
                             "build one a shard with shard_scene_bvh")
    out = []
    for i in range(n_geo):
        parts = {}
        for name in ("tris", "cones"):
            pack = getattr(scene, name)
            s = pack.count // n_geo
            parts[name] = _slice_pack(pack, i * s, (i + 1) * s)
        for name in ("tri_bvh", "cone_bvh"):
            b = getattr(scene, name)
            if b is not None and b.geo_stacked:
                parts[name] = dataclasses.replace(b, **{
                    f.name: getattr(b, f.name)[i:i + 1] for f in dataclasses.fields(b)
                    if isinstance(getattr(b, f.name), torch.Tensor)})
        out.append(_squeeze_local_bvhs(dataclasses.replace(scene, **parts)))
    return out


# ---------------------------------------------------------------------------
# Geo-merged intersection
# ---------------------------------------------------------------------------

def _merge_hits_over_geo(hits: Sequence[bruteforce.Hit]) -> bruteforce.Hit:
    """Min-reduction with payload over the shards' Hits (each [R], on one
    device): keep the globally nearest hit per ray. At equal t a triangle
    beats a cone (the single-device merge's `cone_wins = t_cone < t_tri`);
    otherwise the lowest shard wins, which is the lowest global index, as
    the single-device argmin."""
    g = {f.name: torch.stack([getattr(h, f.name) for h in hits])
         for f in dataclasses.fields(bruteforce.Hit)}  # [G, R, ...]
    t = g["t"]
    cand = t == t.amin(0)[None]
    tri_cand = cand & (g["prim_type"] != bruteforce.PRIM_CONE)
    use_tri = tri_cand.any(0)
    # argmax of a 0/1 tensor is its FIRST 1: the lowest shard
    win = torch.where(use_tri, tri_cand.to(torch.uint8).argmax(0),
                      cand.to(torch.uint8).argmax(0))
    rows = torch.arange(t.shape[1], device=t.device)
    return bruteforce.Hit(**{k: v[win, rows] for k, v in g.items()})


def _global_ids(hit: bruteforce.Hit, shard: DeviceScene, i: int) -> bruteforce.Hit:
    """Shard i's Hit with a global prim_id: a pack with a per-shard BVH
    maps rows to global ids already (`shard_scene_bvh` globalizes `perm`);
    a BVH-less pack's row is offset by the i shards of its size before it
    (the JAX package leaves it shard-local)."""
    pid = hit.prim_id
    for kind, pack, bvh in ((bruteforce.PRIM_TRI, shard.tris, shard.tri_bvh),
                            (bruteforce.PRIM_CONE, shard.cones, shard.cone_bvh)):
        if bvh is None and i:
            pid = torch.where(hit.prim_type == kind, pid + i * pack.count, pid)
    return dataclasses.replace(hit, prim_id=pid)


def geo_closest_fn(shards: Sequence[DeviceScene]):
    """closest_fn for `render_sample_ids`: `traverse.closest_hit` on every
    shard scene on its own device (its BVH's traversal kernel, else K5 or
    the dense grid), the Hits brought to the rays' device with global
    prim_ids and merged. The hook's `scene` argument (the row's scene) is
    not read: the shards hold the geometry."""
    from ..ops import traverse

    def fn(o, d, scene):
        hits = [_global_ids(_hit_to(traverse.closest_hit(o.to(s.device), d.to(s.device), s),
                                    o.device), s, i) for i, s in enumerate(shards)]
        return hits[0] if len(hits) == 1 else _merge_hits_over_geo(hits)

    return fn


def geo_occlude_fn(shards: Sequence[DeviceScene]):
    """occlude_fn for `render_sample_ids`: a ray is blocked when any shard
    blocks it (`traverse.any_hit` on each shard's device)."""
    from ..ops import traverse

    def fn(o, d, scene, t_max):
        blocked = None
        for s in shards:
            b = traverse.any_hit(o.to(s.device), d.to(s.device), s, t_max.to(s.device))
            b = b.to(o.device)
            blocked = b if blocked is None else blocked | b
        return blocked

    return fn


def _hit_to(hit: bruteforce.Hit, device) -> bruteforce.Hit:
    return bruteforce.Hit(**{f.name: getattr(hit, f.name).to(device)
                             for f in dataclasses.fields(bruteforce.Hit)})


# ---------------------------------------------------------------------------
# Sharded render
# ---------------------------------------------------------------------------

def _camera_to(camera: cam_mod.Camera, device) -> cam_mod.Camera:
    return dataclasses.replace(camera, **{
        f.name: getattr(camera, f.name).to(device) for f in dataclasses.fields(camera)
        if isinstance(getattr(camera, f.name), torch.Tensor)})


def render_image_sharded(scene: DeviceScene, camera: cam_mod.Camera, key: torch.Tensor,
                         cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """The progressive render sharded over `mesh` -> [H, W, 3] on the mesh's
    first device, tone-mapped when `cfg.tonemap`. Each dp row renders its
    pixels sample by sample (the running mean `acc + (c - acc) / (i + 1)`)
    with the geo hooks; the image equals `render_image`'s for any mesh
    shape (keys are global-pixel-id keyed, and the merge keeps the
    single-device winner)."""
    w, h = camera.resolution
    r = w * h
    n_dp, n_geo = mesh.shape[DP_AXIS], mesh.shape[GEO_AXIS]
    if r % n_dp != 0:
        raise ValueError(f"pixel count {r} not divisible by dp={n_dp}")
    shards = geo_shards(pad_scene_geo(scene, n_geo), n_geo)
    per = r // n_dp
    fused = cfg.fused_shading and not cfg.bdpt
    rows = []
    for row, devs in enumerate(mesh.devices):
        local = [to_device(s, dev) for s, dev in zip(shards, devs)]
        row_scene, dev = local[0], devs[0]
        closest, occlude = geo_closest_fn(local), geo_occlude_fn(local)
        cam = _camera_to(camera, dev)
        tables = BounceTables.of(row_scene) if fused else None
        ids = torch.arange(row * per, (row + 1) * per, device=dev)
        acc = torch.zeros((per, 3), dtype=torch.float32, device=dev)
        for i in range(cfg.spp):
            c = render_sample_ids(row_scene, cam, ids, key, i, cfg, tables,
                                  closest_fn=closest, occlude_fn=occlude)
            acc = acc + (c - acc) / (i + 1.0)
        rows.append(acc.to(mesh.devices[0][0]))
    img = torch.cat(rows).reshape(h, w, 3)
    if cfg.tonemap:
        from ..ops import tonemap
        img = tonemap.tonemap(img)
    return img


#: the JAX package's jit-wrapped entry point; the port has no tracing step
render_image_sharded_jit = render_image_sharded
