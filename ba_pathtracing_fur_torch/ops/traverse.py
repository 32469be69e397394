"""Scene intersection with BVHs: build attachment, dispatch and Hit assembly.

Counterpart of `ba_pathtracing_fur_tpu/ops/traverse.py`. A scene carries
optional triangle and cone BVHs (attached by `attach_bvh`); `closest_hit`
and `any_hit` run, per pack, and merge the two kinds per ray:

  * a two-level BVH (`fanout > 0`): the streaming traversal kernel K3
    (`ops/cuda/stream.traverse_stream`);
  * a flat BVH: the heap-walk traversal kernel K2 (`ops/cuda/traverse.
    traverse`);
  * no BVH, at 2^24 or more ray-primitive pairs: the brute-force kernel K5
    (`ops/cuda/intersect.closest`; any hit is its closest t below t_max);
  * no BVH, fewer pairs: the dense all-pairs grid (`ops/intersect.py`).

Each kernel is the CUDA launch on the card and its plain twin on the CPU.

As in the JAX package, the traversal only selects the winning row; the
winner's t is recomputed outside it from the gathered row, with the same
arithmetic as the leaf test, and the Hit assembled from the rows: by the
hit kernel K6 (`ops/cuda/hit`, one launch) on the card, by the torch
assembly (`_torch_hit`) on the CPU and wherever autograd records. When the
scene has a BVH the rays are sorted by the JAX package's entry-morton key
(`_entry_morton_perms`, position only) before every kernel of the call, K5
on a BVH-less pack beside the BVH included (the JAX package's order), so
the tiles of K2, K3 and K5 hold rays that enter the same leaves or
primitives; the sort is a pure permutation, undone on the rows (closest
hit) or the blocked flags (any hit), so the Hit is the same per ray with it
or without it. K5's tables are made once per
pack (`cisect.tables_of`), not per call. `any_hit` gives a cone BVH the
lanes with |d|inf >= 2^127 dead where its pack meets `bvh.far_rays_inert`:
no row test accepts them there (the proof is beside `any_hit`).

`joint_closest_any` (the JAX package's joint pass, for
`RenderConfig.joint_shadows`) answers a closest-hit set and a shadow set of
rays in one mixed K3 launch over their interleaved pairs, on scenes that
`joint_eligible` passes; each ray's answer is the one `closest_hit` or
`any_hit` gives it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import weakref
from typing import Optional

import numpy as np

import torch

from ..core import vecmath as vm
from ..scene.types import ConePack, DeviceScene, TrianglePack
from ..utils import profiling
from . import bruteforce, bvh as bvh_mod, intersect as isect
from .compact import invert_permutation
from .cuda import hit as chit, intersect as cisect, stream as cstream, traverse as ctraverse

INF = isect.INF

#: leaf targets of auto_leaf_size per primitive kind (the JAX package's
#: values): cone packs of _STREAM_LEAF_MIN or more cones, whose leaves the
#: two-level traversal streams from device memory, take the bigger target
TRI_LEAF_TARGET = 256
CONE_LEAF_TARGET = 128
CONE_LEAF_TARGET_STREAM = 288
_STREAM_LEAF_MIN = 1 << 20
#: bound on the elements of one all-pairs grid chunk
_GRID_ELEMS = 1 << 24
#: ray-primitive pairs from which a BVH-less pack goes to the brute-force
#: kernel (K5) instead of the dense grid (the JAX package's threshold)
_BRUTE_MIN = 1 << 24

#: sort the rays of closest_hit / any_hit by their entry-morton key when
#: the scene has a BVH: the JAX package's default wherever a traversal
#: kernel runs (False measures the traversal without it)
SORT_RAYS = True

#: stage seconds of the last build per kind ("tri", "cone"): the AABBs,
#: the split (by the build method: see ACCEL_BUILDERS), the reorder +
#: pack, and the kernel layouts; where a median build used the perm cache,
#: `perm_cached` says whether its split came from the cache
LAST_BUILD_STATS: dict = {}

#: primitive count from which a median build keeps its slot permutation in
#: the on-disk perm cache (the JAX package's at-scale threshold); smaller
#: packs use it only with a caller's fingerprint. BAPT_BVH_CACHE_DIR moves
#: the cache (default ~/.cache/ba_pathtracing_fur_torch/bvh) and
#: BAPT_NO_BVH_CACHE=1 turns it off.
PERM_CACHE_MIN = 1 << 20

#: the BVH builds (the JAX package's ACCEL_BUILDERS, the reference's
#: runtime-switchable structures, Demo/main.cpp:94-127):
#:   median - longest-axis centroid-median splits, in torch on the pack's device
#:   sah    - capacity-clamped 16-bin SAH, split on the host in numpy
#:   morton - morton-code clustering (a linearized octree), in torch on the device
#:   grid   - uniform-grid cell binning, on the host in numpy
ACCEL_BUILDERS = {"median": bvh_mod.build_median, "sah": bvh_mod.build_sah,
                  "morton": bvh_mod.build, "grid": bvh_mod.build_grid}


def auto_leaf_size(n_prims: int, target: int = 256) -> int:
    """A leaf size near `target` that fills the power-of-two leaf count
    tightly, rounded up to a multiple of 8."""
    n_leaves = max(bvh_mod._next_pow2(-(-n_prims // target)), 1)
    k = -(-n_prims // n_leaves)
    return max(-(-k // 8) * 8, 8)


def auto_fanout(n_leaves: int, max_supers: int = 1024) -> int:
    """Leaf clusters per super-cluster of the two-level traversal: 0 (flat)
    up to 512 leaves, else 64, doubled until there are at most
    `max_supers` super-clusters (the JAX package's rule)."""
    if n_leaves <= 512:
        return 0
    f = 64
    while n_leaves // f > max_supers:
        f *= 2
    return min(f, n_leaves)


def _pack_fingerprint(pack, n_leaves: int, k: int) -> str:
    """Content hash of a primitive pack and the tree shape: every field's
    shape and a strided subsample of about 1M of its values (taken on the
    pack's device), so hashing costs little beside the split it skips."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{type(pack).__name__}:{pack.count}:{n_leaves}:{k}:v2".encode())
    for f in dataclasses.fields(pack):
        a = getattr(pack, f.name)
        h.update(str(tuple(a.shape)).encode())
        b = a.reshape(-1)
        stride = max(1, b.numel() // 1_000_000)
        h.update(np.ascontiguousarray(b[::stride].cpu().numpy()).tobytes())
    return h.hexdigest()


def _perm_cache_path(fingerprint: str) -> str:
    root = os.environ.get("BAPT_BVH_CACHE_DIR", os.path.join(
        os.path.expanduser("~"), ".cache", "ba_pathtracing_fur_torch", "bvh"))
    return os.path.join(root, f"perm_{fingerprint}.npz")


def _median_cached(pack, bmin, bmax, k, fingerprint):
    """The median build through the perm cache -> (BVH, hit: True, False,
    or None where the cache is not used). The cache is used at
    PERM_CACHE_MIN primitives or more, or with a caller's `fingerprint`
    (the key of a generated pack, no hashing), and not at all under
    BAPT_NO_BVH_CACHE; a file that cannot be read or written is a miss."""
    n = pack.count
    n_leaves = bvh_mod._next_pow2(max(-(-n // k), 1))
    if os.environ.get("BAPT_NO_BVH_CACHE") or (n < PERM_CACHE_MIN and fingerprint is None):
        return bvh_mod.build_median(bmin, bmax, k), None
    fp = (f"{fingerprint}_{n_leaves}x{k}" if fingerprint is not None
          else _pack_fingerprint(pack, n_leaves, k))
    path = _perm_cache_path(fp)
    try:
        perm = torch.from_numpy(np.load(path)["perm"].astype(np.int64))
        return bvh_mod.from_perm(perm, bmin, bmax, n_leaves, k), True
    except (OSError, KeyError, ValueError):
        pass
    b = bvh_mod.build_median(bmin, bmax, k)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, perm=b.perm.cpu().numpy())
    except OSError:
        pass
    return b, False


def _clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _attach_one(pack, kind, aabb_fn, reorder_fn, pack_fn, leaf_size, fanout, target,
                method, fingerprint=None):
    """One pack's build on its device -> (reordered pack, BVH)."""
    dev = pack.mat_id.device
    t0 = _clock(dev)
    k = leaf_size or auto_leaf_size(pack.count, target)
    bmin, bmax = aabb_fn(pack)
    t1 = _clock(dev)
    cached = None
    if method == "median":
        b, cached = _median_cached(pack, bmin, bmax, k, fingerprint)
    else:
        b = ACCEL_BUILDERS[method](bmin, bmax, k)
    b.fanout = auto_fanout(b.n_leaves) if fanout is None else fanout
    t2 = _clock(dev)
    pack = reorder_fn(pack, b)
    b = pack_fn(pack, b)
    t3 = _clock(dev)
    b = _cache_kernel_layouts(b, kind, pack)
    t4 = _clock(dev)
    LAST_BUILD_STATS[kind] = dict(aabb=t1 - t0, split=t2 - t1, reorder_pack=t3 - t2,
                                  layouts=t4 - t3)
    if cached is not None:
        LAST_BUILD_STATS[kind]["perm_cached"] = cached
    return pack, b


def _two_level(bvh) -> bool:
    return bool(bvh.fanout) and bvh.fanout < bvh.n_leaves


def _cache_kernel_layouts(bvh, kind: str, pack):
    """The kernel layouts of `bvh` over its reordered `pack`, made once
    instead of per call (None stays None): the winner-row AoS table (a
    per-call `cone_aos` is a 697 MB copy at hair-ball scale), the unit boxes
    of the leaves' row runs and, for a two-level BVH, its super-cluster and
    child box tables; for cones, the pack fact `far_inert`
    (`bvh.far_rays_inert` of the packed rows, which `any_hit` reads)."""
    if bvh is None:
        return None
    aabbs = isect.cone_aabbs if kind == "cone" else isect.triangle_aabbs
    out = {"aos_rows": (cone_aos if kind == "cone" else tri_aos)(pack),
           "uboxes": bvh_mod.unit_boxes(*aabbs(pack), bvh),
           "far_inert": kind == "cone" and bvh_mod.far_rays_inert(bvh.packed)}
    if _two_level(bvh):
        out.update(sboxes=cstream.pack_super_boxes(bvh), cboxes=cstream.pack_child_boxes(bvh))
    return dataclasses.replace(bvh, **out)


def attach_bvh(scene: DeviceScene, leaf_size: Optional[int] = None, method: str = "median",
               min_prims: int = 2048, fanout: Optional[int] = None,
               fingerprint: Optional[str] = None) -> DeviceScene:
    """Build BVHs by `method` (one of ACCEL_BUILDERS, or "none") over the
    packs of at least `min_prims` primitives and reorder those packs so leaf
    clusters are contiguous. Smaller packs stay BVH-less (the dense grid or
    K5 takes them). leaf_size/fanout default to `auto_leaf_size` /
    `auto_fanout`. Each BVH lands on its pack's device, bit-identical to
    the JAX package's build by the same method. A median build goes
    through the perm cache (`_median_cached`: at PERM_CACHE_MIN primitives,
    or keyed by the caller's `fingerprint` of the cone pack, e.g. of a
    generated hair ball's parameters). LAST_BUILD_STATS gets the stage
    times and, where the cache took part, whether the split came from it."""
    if method == "none":
        return scene
    if method not in ACCEL_BUILDERS:
        raise ValueError(f"unknown BVH method {method!r}: one of {sorted(ACCEL_BUILDERS)}")
    out = {}
    if scene.tris.count >= min_prims:
        tris, tri_bvh = _attach_one(scene.tris, "tri", isect.triangle_aabbs,
                                    bvh_mod.reorder_tris, bvh_mod.pack_tris, leaf_size, fanout,
                                    TRI_LEAF_TARGET, method)
        out.update(tris=tris, tri_bvh=tri_bvh)
    if scene.cones.count >= min_prims:
        target = (CONE_LEAF_TARGET_STREAM if scene.cones.count >= _STREAM_LEAF_MIN
                  else CONE_LEAF_TARGET)
        cones, cone_bvh = _attach_one(scene.cones, "cone", isect.cone_aabbs,
                                      bvh_mod.reorder_cones, bvh_mod.pack_cones, leaf_size,
                                      fanout, target, method, fingerprint)
        out.update(cones=cones, cone_bvh=cone_bvh)
    return dataclasses.replace(scene, **out)


# ---------------------------------------------------------------------------
# Winner rows
# ---------------------------------------------------------------------------

def _i2f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.float32)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def cone_aos(cones: ConePack) -> torch.Tensor:
    """[N, 19] AoS of every cone field the winner-t recompute and the Hit
    assembly need (the int mat_id bitcast into an f32 column)."""
    return torch.cat([cones.base, cones.u, cones.v, cones.w,
                      torch.stack([cones.slope, cones.r_base, cones.min_d, cones.max_d,
                                   cones.base_d, cones.height, _i2f(cones.mat_id)], dim=1)],
                     dim=1)


def tri_aos(tris: TrianglePack) -> torch.Tensor:
    """[N, 34] AoS of every triangle field the assembly needs."""
    return torch.cat([tris.v0, tris.v1, tris.v2, tris.n0, tris.n1, tris.n2,
                      tris.uv0, tris.uv1, tris.uv2, tris.fiber_u, tris.fiber_v,
                      tris.fiber_w, _i2f(tris.mat_id)[:, None]], dim=1)


#: pack_aos's cache: (id of a pack, kind) -> its row table, an entry dropped
#: when its pack is freed
_AOS: dict = {}


def pack_aos(pack, kind: str) -> torch.Tensor:
    """The row table (`tri_aos` / `cone_aos`) of a BVH-less pack, which the
    Hit assembly reads, made at the pack's first call and kept while the
    pack lives, as `cisect.tables_of` keeps K5's (a BVH keeps its own as
    `aos_rows`). A table that autograd records through is made anew each
    call and not kept, and one made under no_grad is not kept either: it
    cannot tell whether the pack requires grad."""
    key = (id(pack), kind)
    aos = _AOS.get(key)
    if aos is None:
        aos = (cone_aos if kind == "cone" else tri_aos)(pack)
        if torch.is_grad_enabled() and not aos.requires_grad:
            _AOS[key] = aos
            weakref.finalize(pack, _AOS.pop, key, None)
    return aos


def take_cone_rows(aos: torch.Tensor, rows: torch.Tensor) -> dict:
    """One [R, 19] row gather of the winning cones' fields from `cone_aos`'s
    table (the BVH's `aos_rows`)."""
    g = aos[rows.long()]
    return {"base": g[:, 0:3], "u": g[:, 3:6], "v": g[:, 6:9], "w": g[:, 9:12],
            "slope": g[:, 12], "r_base": g[:, 13], "min_d": g[:, 14], "max_d": g[:, 15],
            "base_d": g[:, 16], "height": g[:, 17], "mat_id": _f2i(g[:, 18]), "_g": g}


def take_tri_rows(aos: torch.Tensor, rows: torch.Tensor) -> TrianglePack:
    """One [R, 34] row gather of the winning triangles' fields from
    `tri_aos`'s table (the BVH's `aos_rows`)."""
    g = aos[rows.long()]
    return TrianglePack(
        v0=g[:, 0:3], v1=g[:, 3:6], v2=g[:, 6:9], n0=g[:, 9:12], n1=g[:, 12:15],
        n2=g[:, 15:18], uv0=g[:, 18:20], uv1=g[:, 20:22], uv2=g[:, 22:24],
        fiber_u=g[:, 24:27], fiber_v=g[:, 27:30], fiber_w=g[:, 30:33],
        mat_id=_f2i(g[:, 33]))


def _recompute_t_tri(rp: TrianglePack, o, d, t_min, t_best):
    """The winner's t from its gathered row (the leaf test's arithmetic)."""
    v0, e1, e2 = rp.v0, rp.v1 - rp.v0, rp.v2 - rp.v0
    comp = [v0[:, 0:1], v0[:, 1:2], v0[:, 2:3], e1[:, 0:1], e1[:, 1:2], e1[:, 2:3],
            e2[:, 0:1], e2[:, 1:2], e2[:, 2:3]]
    return bvh_mod._tri_core(o, d, comp, t_min, t_best)[:, 0]


def _recompute_t_cone(rc: dict, o, d, t_min, t_best):
    g = rc["_g"]
    return bvh_mod._cone_core(o, d, [g[:, i:i + 1] for i in range(16)], t_min, t_best)[:, 0]


def _cone_enter_rows(base, u_ax, v_ax, w_ax, slope, r_base, o, d, t):
    """Was the winning cone hit on its entering (nearer) root? Recompute the
    quadratic for the winner (Cylinder.cpp:126,140) and classify t by the
    closer root."""
    rel = o - base
    px, py, pz = vm.dot(rel, u_ax), vm.dot(rel, v_ax), vm.dot(rel, w_ax)
    dx, dy, dz = vm.dot(d, u_ax), vm.dot(d, v_ax), vm.dot(d, w_ax)
    a = dx * dx + dz * dz - slope * slope * dy * dy
    b = px * dx + pz * dz + r_base * slope * dy - slope * slope * py * dy
    disc = b * b - a * (px * px + pz * pz - (r_base - slope * py) ** 2)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a.abs() < 1e-12, 1e-12, a)
    ra = (-b - sq) / a_safe
    rb = (-b + sq) / a_safe
    t1 = torch.minimum(ra, rb)
    t2 = torch.maximum(ra, rb)
    return (t - t1).abs() <= (t - t2).abs()


def _use_brute(o, pack) -> bool:
    return o.shape[0] * pack.count >= _BRUTE_MIN


def _brute_rows(o, d, t_max, tables, kind, t_min, sort=None):
    """K5 over a BVH-less pack -> (winner row [R], 0 on a miss; found [R])
    in the callers' ray order, the kernel run on the sorted rays when `sort`
    holds them. K5 keeps only t below t_max, so found is row >= 0."""
    if sort is None:
        row = cisect.closest(o, d, t_max, tables, kind, t_min)[1]
    else:
        row = cisect.closest(*sort[:3], tables, kind, t_min)[1][sort[3]]
    return torch.clamp(row, min=0), row >= 0


def _traverse(o, d, t_max, bvh, kind, any_hit, t_min):
    """K3 for a two-level BVH, K2 for a flat one -> (t, row, found)."""
    fn = cstream.traverse_stream if _two_level(bvh) else ctraverse.traverse
    return fn(o, d, t_max, bvh, kind, any_hit=any_hit, t_min=t_min)


def _entry_morton_perms(o, d, t_max, bvh):
    """Stable permutation grouping rays by the 3D morton cell of their
    entry point into the BVH's root box (o + max(t_enter, 0) * d, clipped
    to the box), dead rays (t_max <= 0) last -> (perm, inverse). The JAX
    package's `_entry_morton_perms` with the position-only key: a bounce
    ray (origin inside the box) sorts by its origin, a camera ray by where
    it enters the scene."""
    lo = bvh.bmin[0] - 1e-3
    hi = bvh.bmax[0] + 1e-3
    eps = 1e-20
    inv = 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)
    tn = torch.minimum((lo - o) * inv, (hi - o) * inv).amax(1)
    p = torch.clamp(o + torch.clamp(tn, min=0.0)[:, None] * d, lo, hi)
    key = torch.where(t_max <= 0.0, 1 << 30, bvh_mod.morton_codes(p, lo, hi))
    perm = torch.argsort(key, stable=True)
    return perm, invert_permutation(perm)


def _sorted_rays(o, d, t_max, scene: DeviceScene):
    """(o, d, t_max, inverse) in the entry-morton order of the scene's
    cone BVH, else of its triangle BVH (the JAX package's choice); None when
    it has no BVH or SORT_RAYS is off."""
    bvh = scene.cone_bvh if scene.cone_bvh is not None else scene.tri_bvh
    if bvh is None or not SORT_RAYS:
        return None
    with profiling.span("sort"):
        perm, inv = _entry_morton_perms(o, d, t_max, bvh)
        return o[perm], d[perm], t_max[perm], inv


def _traverse_rows(o, d, t_max, bvh, kind, t_min, sort):
    """Closest-hit winner rows [R] (0 on a miss) and found [R] in the
    callers' ray order, the traversal run on the sorted rays when `sort`
    holds them."""
    if sort is None:
        _, row, found = _traverse(o, d, t_max, bvh, kind, False, t_min)
    else:
        row = _traverse(*sort[:3], bvh, kind, False, t_min)[1][sort[3]]
        found = row >= 0
    return torch.clamp(row, min=0), found


def _grid_chunks(r: int, p: int, n_alive):
    """Ray chunks (start, stop) of the dense grid over a pack of p
    primitives: chunks starting at or past `n_alive` (the live prefix of a
    compacted wavefront) are left out, as the JAX package's chunked grid
    skips them."""
    step = max(1, _GRID_ELEMS // max(p, 1))
    end = r if n_alive is None or r <= step else min(r, int(n_alive))
    return [(s, min(s + step, r)) for s in range(0, end, step)]


def _grid_closest(o, d, pack, grid_fn, t_min, t_max, n_alive=None):
    """Nearest hit over a BVH-less pack by the dense grid, chunked over
    rays -> (t [R] INF where none, row [R]); rays of skipped chunks get INF
    and row 0, what the grid gives a dead ray."""
    r = o.shape[0]
    ts, rows, n = [], [], 0
    for s, n in _grid_chunks(r, pack.count, n_alive):
        g = grid_fn(o[s:n], d[s:n], pack, t_min, t_max[s:n, None])[0]
        row = g.argmin(-1)
        ts.append(g.gather(-1, row[:, None])[:, 0])
        rows.append(row.to(torch.int32))
    if n < r:
        ts.append(torch.full((r - n,), INF, device=o.device))
        rows.append(torch.zeros((r - n,), dtype=torch.int32, device=o.device))
    return torch.cat(ts), torch.cat(rows)


def _grid_any(o, d, pack, grid_fn, t_min, t_max, n_alive=None):
    """Does any primitive of a BVH-less pack lie in (t_min, t_max)? -> [R];
    rays of skipped chunks are not blocked."""
    blocked = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for s, e in _grid_chunks(o.shape[0], pack.count, n_alive):
        blocked[s:e] = grid_fn(o[s:e], d[s:e], pack, t_min, t_max[s:e, None])[-1].any(-1)
    return blocked


def _assemble_hit(o, d, t_tri, tri_row, t_cone, cone_row, t_max, tri_rp, cone_rc,
                  tri_perm=None, cone_perm=None) -> bruteforce.Hit:
    """Merge the per-kind winners into a full Hit. Rows index the scene's
    current (reordered) packs, `tri_rp`/`cone_rc` hold them gathered (None
    for a kind with no primitives); a BVH's perm maps them back to the
    original primitive ids."""
    r = o.shape[0]
    cone_wins = t_cone < t_tri
    t = torch.where(cone_wins, t_cone, t_tri)
    valid = t < t_max
    prim_type = torch.where(~valid, bruteforce.PRIM_NONE,
                            torch.where(cone_wins, bruteforce.PRIM_CONE,
                                        bruteforce.PRIM_TRI)).to(torch.int32)
    position = o + t[:, None] * d

    n = torch.zeros_like(o)
    uv = torch.zeros((r, 2), dtype=torch.float32, device=o.device)
    mat_id = torch.zeros((r,), dtype=torch.int32, device=o.device)
    fu, fv, fw = torch.zeros_like(o), torch.zeros_like(o), torch.zeros_like(o)
    enter = torch.zeros((r,), dtype=torch.bool, device=o.device)
    prim_id = torch.zeros((r,), dtype=torch.int32, device=o.device)

    def w3(m, a, b):
        return torch.where(m[:, None], a, b)

    if tri_rp is not None:
        is_tri = prim_type == bruteforce.PRIM_TRI
        # the other lanes take a finite ray toward the row's first vertex:
        # their values are dropped below (see the cone block)
        e = torch.tensor([0.0, 0.0, 1.0], device=o.device)
        tn, tuv, _ = isect.triangle_interpolate_rows(tri_rp, position, w3(is_tri, o, tri_rp.v0 - e),
                                                     w3(is_tri, d, e))
        n, uv = w3(is_tri, tn, n), w3(is_tri, tuv, uv)
        mat_id = torch.where(is_tri, tri_rp.mat_id, mat_id)
        fu, fv, fw = (w3(is_tri, tri_rp.fiber_u, fu), w3(is_tri, tri_rp.fiber_v, fv),
                      w3(is_tri, tri_rp.fiber_w, fw))
        orig = tri_perm[tri_row.long()] if tri_perm is not None else tri_row
        prim_id = torch.where(is_tri, orig, prim_id)
    if cone_rc is not None:
        is_cone = prim_type == bruteforce.PRIM_CONE
        # the other lanes (misses at o + INF d among them) take the cone
        # fields at a finite point off the row's axis: their values are
        # dropped below, and finite inputs keep NaN out of the backward
        pos_c = w3(is_cone, position, cone_rc["base"] + cone_rc["u"])
        cn = isect.cone_normal_rows(cone_rc["v"], cone_rc["base"], cone_rc["base_d"],
                                    cone_rc["slope"], pos_c)
        cuv = isect.cone_texcoord_rows(cone_rc["base"], cone_rc["u"], cone_rc["v"],
                                       cone_rc["w"], cone_rc["r_base"], cone_rc["slope"],
                                       cone_rc["height"], pos_c)
        n, uv = w3(is_cone, cn, n), w3(is_cone, cuv, uv)
        mat_id = torch.where(is_cone, cone_rc["mat_id"], mat_id)
        fu, fv, fw = (w3(is_cone, cone_rc["u"], fu), w3(is_cone, cone_rc["v"], fv),
                      w3(is_cone, cone_rc["w"], fw))
        enter = is_cone & _cone_enter_rows(cone_rc["base"], cone_rc["u"], cone_rc["v"],
                                           cone_rc["w"], cone_rc["slope"],
                                           cone_rc["r_base"], o, d, t)
        orig = cone_perm[cone_row.long()] if cone_perm is not None else cone_row
        prim_id = torch.where(is_cone, orig, prim_id)

    return bruteforce.Hit(
        t=torch.where(valid, t, INF), valid=valid, prim_type=prim_type, prim_id=prim_id,
        mat_id=mat_id, position=position, normal=n, uv=uv, enter=enter, fiber_u=fu,
        fiber_v=fv, fiber_w=fw)


def _t_max_of(t_max, r, like):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=like.device), (r,)).contiguous()


def closest_hit(o, d, scene: DeviceScene, t_min=1e-4, t_max=INF,
                n_alive=None) -> bruteforce.Hit:
    """Nearest hit per ray: a traversal kernel for packs with a BVH and K5
    for big BVH-less packs (then the winner's t recomputed from its row),
    both on the entry-morton sorted rays when the scene has a BVH (see
    SORT_RAYS), the dense grid for small BVH-less packs. t_max may be per
    ray [R]. With a compacted wavefront, `n_alive` (its live prefix) lets
    the dense grid skip the chunks past it; the kernels take the whole
    wavefront.

    The kernels get detached rays and only pick rows; the winner's t and
    the Hit are computed in torch from the live rays, so gradients reach
    o, d and the scene through them (as the JAX package's stop_gradient'ed
    traversal does)."""
    r = o.shape[0]
    t_max = _t_max_of(t_max, r, o)
    o_s, d_s, t_s = o.detach(), d.detach(), t_max.detach()
    sort = _sorted_rays(o_s, d_s, t_s, scene)
    rows = {}
    for kind, pack, bvh in (("tri", scene.tris, scene.tri_bvh),
                            ("cone", scene.cones, scene.cone_bvh)):
        if bvh is not None:
            rows[kind] = _traverse_rows(o_s, d_s, t_s, bvh, kind, t_min, sort)
        elif pack.count and _use_brute(o, pack):
            rows[kind] = _brute_rows(o_s, d_s, t_s, cisect.tables_of(pack, kind), kind, t_min,
                                     sort)
    return _hit_of_rows(o, d, scene, t_min, t_max, rows, n_alive)


def _hit_of_rows(o, d, scene: DeviceScene, t_min, t_max, rows: dict,
                 n_alive=None) -> bruteforce.Hit:
    """The closest Hit from the winner rows that the kernels picked:
    `rows[kind] = (row [R], 0 on a miss; found [R])` in the callers' ray
    order for each pack a kernel ran on (its BVH's traversal, or K5 on a
    BVH-less pack), the winner's t recomputed from the row; the dense grid
    for every other BVH-less pack. K6 (`ops/cuda/hit`) assembles the Hit on
    the card, the torch assembly (`_torch_hit`) on the CPU (all in the span
    `hit`)."""
    with profiling.span("hit"):
        profiling.count("hit_rays", o.shape[0])
        won = {}  # kind -> (row table, row [R], found [R] or None, t [R] or None, perm or None)
        for kind, pack, bvh, grid_fn in (
                ("tri", scene.tris, scene.tri_bvh, isect.triangle_hit_grid),
                ("cone", scene.cones, scene.cone_bvh, isect.cone_hit_grid)):
            if not pack.count:
                continue
            if bvh is not None:
                won[kind] = (bvh.aos_rows, *rows[kind], None, bvh.perm)
            elif kind in rows:
                won[kind] = (pack_aos(pack, kind), *rows[kind], None, None)
            else:
                t, row = _grid_closest(o, d, pack, grid_fn, t_min, t_max, n_alive)
                won[kind] = (pack_aos(pack, kind), row, None, t, None)
        return chit.hit_of_rows(o, d, t_max, t_min, won)


def _torch_hit(o, d, t_max, t_min, won: dict) -> bruteforce.Hit:
    """The torch assembly, K6's plain version (`ops/cuda/hit.hit_of_rows`'s
    `won`) and the graph K6's backward differentiates: each kind's rows
    gathered (`take_tri_rows`/`take_cone_rows`), its t recomputed where
    found (or the dense grid's), `_assemble_hit`."""
    r = o.shape[0]
    kinds = {}  # kind -> (t [R], row [R], the gathered rows or None, perm or None)
    for kind, take, recompute in (("tri", take_tri_rows, _recompute_t_tri),
                                  ("cone", take_cone_rows, _recompute_t_cone)):
        if kind not in won:
            kinds[kind] = (torch.full((r,), INF, device=o.device),
                           torch.zeros((r,), dtype=torch.int32, device=o.device), None, None)
            continue
        aos, row, found, t, perm = won[kind]
        rp = take(aos, row)
        if t is None:
            t = torch.where(found, recompute(rp, o, d, t_min, t_max), INF)
        kinds[kind] = (t, row, rp, perm)
    (t_tri, tri_row, tri_rp, tri_perm), (t_cone, cone_row, cone_rc, cone_perm) = (
        kinds["tri"], kinds["cone"])
    return _assemble_hit(o, d, t_tri, tri_row, t_cone, cone_row, t_max, tri_rp, cone_rc,
                         tri_perm, cone_perm)


# ---------------------------------------------------------------------------
# Far rays: answered before the cone traversal, by a proof
# ---------------------------------------------------------------------------
#
# A Whitted miss is shaded as a surface at o + 3.4e38 d (the JAX package's
# nodes trace with t_max = inf), and its hard shadow ray toward a quad light
# has d = target - origin = -origin, |d|inf of order 1e38. Its box tests
# enter most of the cone tree, and every row test it reaches overflows and
# accepts nothing. Where the cone pack meets `bvh.far_rays_inert` (the BVH's
# `far_inert`), `any_hit` hands every lane with |d|inf >= FAR_D to the cone
# traversal with t_max = 0, a dead lane, which finds nothing: the answer
# "not blocked by a cone" that the walk gives, bit for bit.
#
# The proof covers every form of the row test: `csrc/leaf_tests.cuh`'s
# cone_row (-fmad=false: each product and sum rounds on its own) and its
# torch twin `ops/bvh._cone_core`, and the tensor-core test's `cone_uw` +
# `cone_v` and their twin `ops/cuda/traverse._cone_core_mxu`, whose
# projections are sums of TF32 products or torch matmuls. Each form takes
# the projections dx, dy, dz = d.u, d.v, d.w and ov = o.v; a = dx*dx +
# dz*dz - slope*slope*dy*dy; disc = b*b - a*c; the roots (-b -+ sqrt(disc))
# / a_safe; and accepts a root t only if t >= 1e-4, t > t_min, t < cap and
# ax = ov + t*dy (rounded product, then rounded sum) lies in [min_d, max_d].
# Take a ray with |d|inf >= 2^127 and a row that meets the fact.
#
# 1. If a is not finite, no root is accepted. a*c is then +-inf or NaN, so
#    disc is NaN or +-inf whatever b is. NaN and -inf fail disc >= 0. For
#    disc = +inf, sqrt(disc) = +inf, both numerators -b -+ inf are +-inf or
#    NaN, and over a_safe = a = +-inf both roots are NaN (fminf and fmaxf
#    of two NaNs are NaN), which fail t >= 1e-4.
# 2. If a is finite, so are dx, dy and dz (a non-finite one makes its term
#    of a non-finite: slope*slope*dy is NaN or +-inf for a non-finite dy,
#    slope 0 included), and |dx|, |dz| < 2^64 (else its square rounds to
#    +inf). The frame is orthonormal within 2^-10, so by Gershgorin on its
#    Gram matrix its smallest singular value is at least sqrt(1 - 2^-8) >
#    0.99; the projections round by less than 2^-19 of |d| in every form
#    (a TF32 split's dropped lo*lo term is 2^-22), and an overflow on the
#    way makes the projection non-finite. So |(dx, dy, dz)| > 0.98 * 2^127,
#    and with |dx|, |dz| < 2^64, |dy| > 2^126.
# 3. An accepted root has t >= 1e-4 > 2^-14, so |t*dy| >= 2^112, or is
#    +inf (t NaN fails t >= 1e-4).
# 4. If t*dy or ov is not finite, ax is +-inf or NaN, in no finite slab.
#    If |ov| < 2^111, |ax| >= 2^112 - 2^111 = 2^111 after rounding. Else ov
#    and t*dy are floats of magnitude >= 2^111 and >= 2^112, so multiples
#    of 2^88 and 2^89, and their rounded sum is a multiple of 2^88: ax is 0
#    or |ax| >= 2^88.
# 5. The fact bounds |min_d| and |max_d| by 2^64 < 2^88, so the row accepts
#    only if 0 lies in [min_d, max_d], which the fact rules out; and a row
#    with an empty slab accepts nothing at all.
#
# No step reads t_min or cap: the slab alone rejects every root, so the
# walk answers "not found" for every t_min and cap, as the dead lane does.
# The triangle rows are not covered, so K5 and the triangle BVH keep every
# lane's t_max; `closest_hit` and `joint_closest_any` trace as before.

#: |d|inf from which a lane is far (see above)
FAR_D = 2.0 ** 127


def _far_dead(d, t_max):
    """t_max with 0 on the far lanes (|d|inf >= FAR_D), for the cone
    traversal of a pack that meets `bvh.far_rays_inert`: four kernels
    (`where` with a scalar would fill a one-element tensor first; the
    masked fill's copy is a memcpy). The counter `k3_far_skipped` gets the
    far lanes' mask, which it sums only when read, so a traced pass
    launches nothing more for it."""
    far = d.abs().amax(1) >= FAR_D
    profiling.count("k3_far_skipped", far)
    return t_max.masked_fill(far, 0.0)


def any_hit(o, d, scene: DeviceScene, t_max, t_min=1e-4, n_alive=None) -> torch.Tensor:
    """Shadow-ray occlusion: does any geometry lie in (t_min, t_max)? -> [R]
    bool. A traversal kernel's any-hit mode for packs with a BVH, K5's
    closest t below t_max for big BVH-less packs, the dense grid for small
    ones (its chunks past `n_alive` skipped, as in closest_hit: the sort
    puts dead rays last, so the live rays stay in the prefix). With a BVH
    (and SORT_RAYS) every pack runs on the entry-morton sorted rays and the
    flags are unsorted once. A cone BVH whose pack meets the far-ray fact
    (`far_inert`) gets the far lanes dead (`_far_dead`: proved to find
    nothing). The answer is a flag, so every test runs on detached rays."""
    r = o.shape[0]
    o, d, t_max = o.detach(), d.detach(), _t_max_of(t_max, r, o).detach()
    sort = _sorted_rays(o, d, t_max, scene)
    if sort is not None:
        o, d, t_max, inv = sort
    blocked = torch.zeros((r,), dtype=torch.bool, device=o.device)
    for kind, pack, bvh, grid_fn in (
            ("tri", scene.tris, scene.tri_bvh, isect.triangle_hit_grid),
            ("cone", scene.cones, scene.cone_bvh, isect.cone_hit_grid)):
        if bvh is not None:
            t_k = _far_dead(d, t_max) if kind == "cone" and bvh.far_inert else t_max
            blocked |= _traverse(o, d, t_k, bvh, kind, True, t_min)[2]
        elif pack.count and _use_brute(o, pack):
            blocked |= _brute_rows(o, d, t_max, cisect.tables_of(pack, kind), kind, t_min)[1]
        elif pack.count:
            blocked |= _grid_any(o, d, pack, grid_fn, t_min, t_max, n_alive)
    return blocked if sort is None else blocked[inv]


# ---------------------------------------------------------------------------
# Joint closest + shadow pass (K3's mixed mode)
# ---------------------------------------------------------------------------

def joint_eligible(scene: DeviceScene) -> bool:
    """Can a bounce's closest-hit rays and the previous bounce's shadow rays
    share one mixed K3 launch? Yes when one two-level BVH carries the scene
    and the other kind of primitive has no BVH (the hair ball: its cones on
    the streaming BVH, its 768 scalp triangles BVH-less, which K5 or the
    dense grid takes for both sets). The JAX package's `joint_eligible` with
    the port's test for the streaming kernel."""
    cone = scene.cone_bvh is not None and _two_level(scene.cone_bvh) and scene.tri_bvh is None
    tri = scene.tri_bvh is not None and _two_level(scene.tri_bvh) and scene.cone_bvh is None
    return cone or tri


def joint_wavefront(o_c, d_c, tcap_c, o_a, d_a, tmax_a, bvh):
    """The pairs of a joint pass as the mixed launch takes them -> (o [2R,
    3], d, t_max [2R], is_any [2R] bool, the inverse of the pair order [R]
    or None): closest rays in the even slots, shadow rays in the odd ones,
    the pairs in the entry-morton order of the closest ray over max(tcap,
    tmax) (a pair is dead only when both its rays are), with SORT_RAYS."""
    r = o_c.shape[0]
    inv = None
    if SORT_RAYS:
        with profiling.span("sort"):
            perm, inv = _entry_morton_perms(o_c, d_c, torch.maximum(tcap_c, tmax_a), bvh)
            o_c, d_c, tcap_c, o_a, d_a, tmax_a = (x[perm] for x in (o_c, d_c, tcap_c, o_a,
                                                                     d_a, tmax_a))
    o2 = torch.stack([o_c, o_a], 1).reshape(2 * r, 3)
    d2 = torch.stack([d_c, d_a], 1).reshape(2 * r, 3)
    t2 = torch.stack([tcap_c, tmax_a], 1).reshape(2 * r)
    is_any = torch.arange(2 * r, device=o_c.device) % 2 == 1
    return o2, d2, t2, is_any, inv


def joint_closest_any(o_c, d_c, tcap_c, o_a, d_a, tmax_a, scene: DeviceScene, t_min=1e-4,
                      n_alive=None):
    """The closest Hit of rays (o_c, d_c, tcap_c) and the occlusion of rays
    (o_a, d_a, tmax_a) -> (Hit, blocked [R] bool), from one mixed K3 launch
    over the pairs (`joint_wavefront`) of a joint-eligible scene: the JAX
    package's `joint_closest_any`. The BVH-less side pack is folded in for
    both sets (K5 at 2^24 pairs or more, else the dense grid); the Hit is
    assembled from the winner rows as `closest_hit` assembles it, so each
    ray's Hit and flag equal those of `closest_hit` and `any_hit`."""
    kind, bvh = ("cone", scene.cone_bvh) if scene.cone_bvh is not None else ("tri", scene.tri_bvh)
    side, pack = ("tri", scene.tris) if kind == "cone" else ("cone", scene.cones)
    r = o_c.shape[0]
    tcap_c, tmax_a = _t_max_of(tcap_c, r, o_c), _t_max_of(tmax_a, r, o_c)
    oc, dc, tc, oa, da, ta = (x.detach() for x in (o_c, d_c, tcap_c, o_a, d_a, tmax_a))
    o2, d2, t2, is_any, inv = joint_wavefront(oc, dc, tc, oa, da, ta, bvh)
    _, row2, found2 = cstream.traverse_stream(o2, d2, t2, bvh, kind, t_min=t_min,
                                              is_any=is_any)
    rows = {kind: (torch.clamp(row2[0::2], min=0), found2[0::2])}
    blocked = found2[1::2]
    use_brute = pack.count and _use_brute(oc, pack)
    if use_brute:  # K5 on both sets, on the pair-sorted rays as the launch had them
        tables = cisect.tables_of(pack, side)
        rows[side] = _brute_rows(o2[0::2], d2[0::2], t2[0::2], tables, side, t_min)
        blocked = blocked | _brute_rows(o2[1::2], d2[1::2], t2[1::2], tables, side, t_min)[1]
    if inv is not None:
        rows = {k: (row[inv], found[inv]) for k, (row, found) in rows.items()}
        blocked = blocked[inv]
    if pack.count and not use_brute:
        grid_fn = isect.triangle_hit_grid if side == "tri" else isect.cone_hit_grid
        blocked = blocked | _grid_any(oa, da, pack, grid_fn, t_min, ta, n_alive)
    return _hit_of_rows(o_c, d_c, scene, t_min, tcap_c, rows, n_alive), blocked
