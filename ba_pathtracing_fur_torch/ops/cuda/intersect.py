"""Brute-force nearest hit against a BVH-less pack: one CUDA kernel
(triangles or cones), with its plain torch twin.

Counterpart of `ba_pathtracing_fur_tpu/ops/pallas/intersect.py`
(`pack_tris_cm`/`pack_cones_cm`, `tri_closest`/`cone_closest`). For each ray
(o, d, t_max) it returns (t, idx): the nearest t in (t_min, t_max) over every
primitive of a component-major pack [W, P] (INF on a miss) and its index
(the lowest on equal t; -1 on a miss). A ray with t_max <= 0 (dead) misses.
The TPU kernel takes no t_max (its callers keep t < t_max); both callers here
keep only t < t_max too, so the port's kernel and twin take it into the test,
which lets the kernel's box tests prune by it.

The arithmetic is that of `_tri_kernel` / `_cone_kernel`: Möller-Trumbore,
and the KIRK cone quadratic with o.v summed x, y, z, `sqrt(max(disc,
1e-12))` and t >= 1e-4. The twin evaluates it chunk by chunk over rays with
the same float32 ops, and the kernel is built without FMA contraction, so
the two agree bit for bit. (`ops/intersect.py`'s grids are not the twin:
their cone test caps t at t_max and takes o.v in another order.)

The kernel (`csrc/bruteforce.cu`) culls before it tests: a block takes a
tile of TILE_RAYS consecutive rays, tests every primitive's padded box
against the tile's ray bundle (`bundle_hits` is that test in torch), and each
ray runs the exact test only on the survivors whose padded box its own slab
test enters (`slab_entries`). `brute_tables` makes the kernel's tables of a
pack; `tables_of` keeps them per pack, made at its first use, for as long
as the pack lives. `padded_boxes` states why the cull never drops a pair
the exact test accepts, and `cull_margin` measures how far from dropping
one a set of rays comes. `work_ref` counts the work these inputs need (the
kernel's bound) and the cull's own tests.

`closest` dispatches on the device of its tensors: CPU tensors go to
`closest_ref`, CUDA tensors launch the kernel or raise. `TRI_LAUNCHES` /
`CONE_LAUNCHES` and `REF_CALLS` count which ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch

from .. import bvh as bvh_mod
from ..intersect import INF, cone_aabbs, triangle_aabbs
from ...scene.types import ConePack, TrianglePack
from .traverse import require_detached

KINDS = {"cone": 16, "tri": 9}  # rows W of the component-major pack per kind
#: bound on the elements of one [rays, prims] chunk of the plain version
_REF_ELEMS = 1 << 24
#: flops of one pair test, counted on csrc/bruteforce.cu (compares and
#: selects included): Möller-Trumbore 55; the cone quadratic 93 as in
#: ops/cuda/traverse.py
PAIR_FLOPS = {"tri": 55, "cone": 93}
#: flops of one box test, bundle or slab (as ops/cuda/traverse.BOX_TEST_FLOPS)
BOX_FLOPS = 28
#: rays of a kernel tile (csrc/bruteforce.cu TILE)
TILE_RAYS = 128
#: the padded boxes' margin: BOX_PAD_REL of each coordinate's magnitude plus
#: BOX_PAD_EXT of the pack's extent (see padded_boxes)
BOX_PAD_REL, BOX_PAD_EXT = 1e-5, 1e-4
#: a box is pruned only where its entry lies beyond PRUNE_SLACK times the
#: ray's best t (or the tile's largest t_max): the exact test accepts a
#: grazing cone root before the ray reaches the cone's box, by the
#: O(sqrt(eps)) relative error of a near-double root, so a prune at the
#: best t itself could drop the winner; 1 + 2^-6 is exact in float32
PRUNE_SLACK = 1.015625
_EPS = 1e-20

TRI_LAUNCHES = 0
CONE_LAUNCHES = 0
REF_CALLS = 0


@dataclasses.dataclass(eq=False)
class BruteTables:
    """The kernel's tables of one pack: the component-major pack `cm`
    [W, P] and the padded boxes [6, P] (lo xyz, hi xyz)."""

    cm: torch.Tensor
    boxes: torch.Tensor


#: tables_of's cache: (id of a pack, kind) -> its BruteTables, an entry
#: dropped when its pack is freed
_TABLES: dict = {}


def pack_cm(pack, kind: str) -> torch.Tensor:
    """[W, P] component-major pack: triangles (v0, e1, e2) per component,
    cones (base, u, v, w per component, slope, r_base, min_d, max_d)."""
    if kind == "tri":
        t: TrianglePack = pack
        rows = [t.v0, t.v1 - t.v0, t.v2 - t.v0]
    else:
        c: ConePack = pack
        rows = [c.base, c.u, c.v, c.w,
                torch.stack([c.slope, c.r_base, c.min_d, c.max_d], dim=1)]
    return torch.cat(rows, dim=1).T.contiguous()


def padded_boxes(pack, kind: str) -> torch.Tensor:
    """[6, P] boxes (lo xyz, hi xyz) of the primitives (`triangle_aabbs` /
    `cone_aabbs`), each side moved out by BOX_PAD_REL * |coordinate| +
    BOX_PAD_EXT * the pack's extent. The margin is there for float32
    rounding: the exact test accepts points a few ulps outside its primitive
    (u + v rounded to 1), and the kernel's slab and bundle tests round
    (lo - o) and its product with 1/d. A grazing ray's t carries a larger
    error (a near-double cone root; a triangle met at a small angle to its
    plane), which moves its point along the ray, possibly out of the padded
    box: the ray then enters the box just after that t, and the prune slack
    PRUNE_SLACK keeps the pair (`cull_margin` measures both). With both,
    the cull drops no pair that the exact test accepts (held on adversarial
    rays by tests/test_torch_bruteforce.py) and the result stays exact. The
    margin also gives a flat triangle (a Cornell wall, no extent
    on one axis) a box with volume."""
    lo, hi = (cone_aabbs if kind == "cone" else triangle_aabbs)(pack)
    if lo.shape[0] == 0:
        return torch.zeros((6, 0), dtype=torch.float32, device=lo.device)
    ext = (hi.amax(0) - lo.amin(0)).amax() * BOX_PAD_EXT
    return torch.cat([lo - (BOX_PAD_REL * lo.abs() + ext),
                      hi + (BOX_PAD_REL * hi.abs() + ext)], dim=1).T.contiguous()


def brute_tables(pack, kind: str) -> BruteTables:
    """The kernel's tables of `pack`, made on its device."""
    return BruteTables(cm=pack_cm(pack, kind), boxes=padded_boxes(pack, kind))


def tables_of(pack, kind: str) -> BruteTables:
    """The tables of `pack`, made at its first call and kept while the pack
    lives, so K5 never rebuilds them per call. Made on first use rather
    than by the entry points: a pack that gets a BVH (the hair ball's 9M
    cones) never needs them. A copy of a pack (`to_device`, `attach_bvh`'s
    reordering) is another pack, with tables of its own."""
    key = (id(pack), kind)
    tables = _TABLES.get(key)
    if tables is None:
        tables = _TABLES[key] = brute_tables(pack, kind)
        weakref.finalize(pack, _TABLES.pop, key, None)
    return tables


def cone_test(o, d, comp, t_min):
    """`_cone_kernel`'s arithmetic on o, d [R,3] and comp, 16 [1,P] rows ->
    t [R,P], INF where not hit."""
    (bx, by, bz, ux, uy, uz, vx, vy, vz, wx, wy, wz,
     slope, r_base, min_d, max_d) = comp
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    ddx, ddy, ddz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    rx, ry, rz = ox - bx, oy - by, oz - bz
    px = rx * ux + ry * uy + rz * uz
    py = rx * vx + ry * vy + rz * vz
    pz = rx * wx + ry * wy + rz * wz
    dx = ddx * ux + ddy * uy + ddz * uz
    dy = ddx * vx + ddy * vy + ddz * vz
    dz = ddx * wx + ddy * wy + ddz * wz
    a = dx * dx + dz * dz - slope * slope * dy * dy
    b = px * dx + pz * dz + r_base * slope * dy - slope * slope * py * dy
    c_lin = r_base - slope * py
    c = px * px + pz * pz - c_lin * c_lin
    disc = b * b - a * c
    has_roots = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    a_safe = torch.where(a.abs() < 1e-12, 1e-12, a)
    t1 = (-b - sq) / a_safe
    t2 = (-b + sq) / a_safe
    t1, t2 = torch.minimum(t1, t2), torch.maximum(t1, t2)
    ov = ox * vx + oy * vy + oz * vz

    def ok(t):
        dax = ov + t * dy
        return (t >= 1e-4) & (t > t_min) & (dax >= min_d) & (dax <= max_d)

    t1_ok, t2_ok = ok(t1), ok(t2)
    return torch.where(has_roots & t1_ok, t1,
                       torch.where(has_roots & ~t1_ok & t2_ok, t2, INF))


def exact_test(o, d, packed, kind: str, t_min: float = 1e-4):
    """The kernel's exact test of rays o, d [R, 3] against every column of
    `packed` [W, P] -> t [R, P], INF where not hit (no t_max)."""
    comp = [packed[i][None] for i in range(packed.shape[0])]
    if kind == "tri":
        return bvh_mod._tri_core(o, d, comp, t_min, torch.full((o.shape[0],), INF,
                                                                device=o.device))
    return cone_test(o, d, comp, t_min)


def closest_ref(o, d, t_max, tables: BruteTables, kind: str, t_min: float = 1e-4):
    """The kernel's plain version, chunked over rays -> (t [R], idx [R]):
    the argmin (first index) of the exact test over the whole pack, kept
    where it lies below t_max (and below INF) on a live ray."""
    global REF_CALLS
    REF_CALLS += 1
    packed = tables.cm
    n_prims = packed.shape[1]
    r = o.shape[0]
    t_out = torch.full((r,), INF, device=o.device)
    idx_out = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    if n_prims == 0:
        return t_out, idx_out
    step = max(1, _REF_ELEMS // n_prims)
    for s in range(0, r, step):
        t = exact_test(o[s:s + step], d[s:s + step], packed, kind, t_min)
        idx = t.argmin(-1)  # the first index of the minimum
        best = t.gather(-1, idx[:, None])[:, 0]
        tm = t_max[s:s + step]
        found = (best < INF) & (best < tm) & (tm > 0.0)
        t_out[s:s + step] = torch.where(found, best, INF)
        idx_out[s:s + step] = torch.where(found, idx, -1).to(torch.int32)
    return t_out, idx_out


# ---------------------------------------------------------------------------
# The kernel's cull in torch: for the tests and the work count (nothing on
# the main path calls these)
# ---------------------------------------------------------------------------

def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| clamped to at least 1e-20 (leaf_tests.cuh::safe_inv)."""
    return 1.0 / torch.where(d.abs() < _EPS, torch.where(d < 0, -_EPS, _EPS), d)


def ray_bundles(o, d, t_max, tile: int = TILE_RAYS) -> dict:
    """Each tile's ray bundle over its live rays (t_max > 0): the origin box
    `olo`, `ohi` [T, 3], the range of 1/d per axis `ilo`, `ihi` [T, 3], the
    largest t_max `tmax` [T] and `live` [T] (a tile with a live ray)."""
    r = o.shape[0]
    n = -(-r // tile)
    pad = n * tile - r
    live = torch.nn.functional.pad(t_max > 0.0, (0, pad)).reshape(n, tile)
    inf = torch.tensor(float("inf"), device=o.device)

    def fold(x, fn, neutral):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(n, tile, -1)
        return fn(torch.where(live[:, :, None], x, neutral), 1)

    inv = safe_inv(d)
    amin = lambda x, dim: x.amin(dim)  # noqa: E731
    amax = lambda x, dim: x.amax(dim)  # noqa: E731
    tm = torch.nn.functional.pad(t_max, (0, pad)).reshape(n, tile)
    return dict(olo=fold(o, amin, inf), ohi=fold(o, amax, -inf), ilo=fold(inv, amin, inf),
                ihi=fold(inv, amax, -inf), tmax=torch.where(live, tm, -inf).amax(1),
                live=live.any(1))


def bundle_hits(b: dict, boxes: torch.Tensor) -> torch.Tensor:
    """Can any live ray of a tile enter a box? [T, P] bool for the bundles
    `b` (ray_bundles) and boxes [6, P]: the kernel's bundle test. Per axis
    whose 1/d has one sign over the tile, the least entry and the largest
    exit over the bundle, each one rounded product of the extreme corner
    (rounding is monotone, so they bound every ray's own slab values); an
    axis of mixed signs bounds nothing. A box passes when the largest of
    the least entries (and 0) lies at or below the least of the largest
    exits and PRUNE_SLACK times the tile's largest t_max."""
    near = torch.zeros((b["olo"].shape[0], boxes.shape[1]), device=boxes.device)
    far = torch.full_like(near, float("inf"))
    for a in range(3):
        lo, hi = boxes[a][None], boxes[a + 3][None]
        olo, ohi = b["olo"][:, a:a + 1], b["ohi"][:, a:a + 1]
        ilo, ihi = b["ilo"][:, a:a + 1], b["ihi"][:, a:a + 1]
        pos, neg = ilo > 0.0, ihi < 0.0
        xl, xh = lo - ohi, hi - olo  # inv > 0: entry from lo, exit from hi
        n_pos = xl * torch.where(xl >= 0.0, ilo, ihi)
        f_pos = xh * torch.where(xh >= 0.0, ihi, ilo)
        yh, yl = hi - olo, lo - ohi  # inv < 0: entry from hi, exit from lo
        n_neg = yh * torch.where(yh >= 0.0, ilo, ihi)
        f_neg = yl * torch.where(yl >= 0.0, ihi, ilo)
        near = torch.where(pos, torch.maximum(near, n_pos),
                           torch.where(neg, torch.maximum(near, n_neg), near))
        far = torch.where(pos, torch.minimum(far, f_pos),
                          torch.where(neg, torch.minimum(far, f_neg), far))
    return (near <= far) & (near <= b["tmax"][:, None] * PRUNE_SLACK) & b["live"][:, None]


def slab_span(o, d, boxes: torch.Tensor):
    """(tnear, tfar) of rays o, d [..., 3] through boxes [6, ...] (lo xyz,
    hi xyz): leaf_tests.cuh::slab's entry and exit. They broadcast
    together: ray j against box j for o [N, 3] and boxes [6, N]; every ray
    against every box for o[:, None] and boxes [6, P]."""
    inv = safe_inv(d)
    t0 = (boxes[0:3].movedim(0, -1) - o) * inv
    t1 = (boxes[3:6].movedim(0, -1) - o) * inv
    return torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1)


def slab_entries(o, d, boxes: torch.Tensor, t_best) -> torch.Tensor:
    """Does a ray enter a box at or before PRUNE_SLACK times its t_best?
    leaf_tests.cuh::slab as the kernel's per-ray test of a survivor calls
    it; o, d, boxes broadcast as in `slab_span`, t_best [...] with them."""
    tnear, tfar = slab_span(o, d, boxes)
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_best * PRUNE_SLACK)


def cull_margin(o, d, t_max, pack, kind: str, t_min: float = 1e-4) -> dict:
    """How near the cull comes to dropping a pair that the exact test
    accepts, over every pair it accepts below its ray's t_max on a live ray
    (`pairs` of them): `entry_ratio`, the largest entry into the pair's
    padded box over its t (the kernel prunes a box only where that ratio
    exceeds PRUNE_SLACK); `missed`, the pairs whose padded box the ray's
    line does not enter ahead of it (0 for an exact cull); `pad_needed`, how
    far the furthest accepted hit point o + t d lies outside its
    primitive's unpadded box, over the pack's extent (the padding is
    BOX_PAD_EXT of it, plus BOX_PAD_REL of each coordinate)."""
    tables = tables_of(pack, kind)
    lo, hi = (cone_aabbs if kind == "cone" else triangle_aabbs)(pack)
    out = dict(pairs=0, entry_ratio=-float("inf"), missed=0, pad_needed=0.0)
    n_prims = tables.cm.shape[1]
    if n_prims == 0:
        return out
    ext = float((hi.amax(0) - lo.amin(0)).amax())
    step = max(1, _REF_ELEMS // 4 // n_prims)
    for s in range(0, o.shape[0], step):
        oc, dc, tm = o[s:s + step], d[s:s + step], t_max[s:s + step]
        t = exact_test(oc, dc, tables.cm, kind, t_min)
        ri, pi = ((t < INF) & (t < tm[:, None]) & (tm[:, None] > 0.0)).nonzero(as_tuple=True)
        if ri.numel() == 0:
            continue
        tt, oc, dc = t[ri, pi], oc[ri], dc[ri]
        tnear, tfar = slab_span(oc, dc, tables.boxes[:, pi])
        p = oc + tt[:, None] * dc
        outside = torch.maximum(lo[pi] - p, p - hi[pi]).amax(-1).clamp(min=0.0)
        out["pairs"] += ri.numel()
        out["entry_ratio"] = max(out["entry_ratio"], float((tnear / tt).max()))
        out["missed"] += int(((tnear > tfar) | (tfar < 0.0)).sum())
        out["pad_needed"] = max(out["pad_needed"], float(outside.max()) / ext)
    return out


def work_ref(o, d, t_max, tables: BruteTables, kind: str, t_final,
             tile: int = TILE_RAYS, max_tiles: int = 0) -> dict:
    """The work these rays need, the kernel's bound: an exact test
    (PAIR_FLOPS) per pair whose padded box the ray enters at or before
    (PRUNE_SLACK times) its final t `t_final` [R] (the kernel's t on a hit,
    t_max on a miss), a pair that no box test rules out; bytes: each input
    read once (the rays, the [W, P] pack, the [6, P] boxes) and each output
    written once. Beside it the cull's own work, which these inputs do not
    need: per tile with a live ray one bundle test per box, per live ray
    one slab test per survivor of its tile (BOX_FLOPS each, `cull_flops`),
    and the tiles' re-reads of the boxes and of the survivors' rows from L2
    (`reread_bytes`). With `max_tiles`, that many tiles spread evenly over
    the wavefront are counted and the counts scaled to all. The TPU
    kernel's work, every live ray against every primitive, is `all_pairs`."""
    r, n_prims = o.shape[0], tables.cm.shape[1]
    n_tiles = -(-r // tile)
    picks = torch.arange(n_tiles, device=o.device)
    if max_tiles and n_tiles > max_tiles:
        picks = picks[::n_tiles // max_tiles][:max_tiles]
    live = t_max > 0.0
    t_fin = torch.where(live, torch.clamp(t_final, max=INF), -INF)
    lane = torch.arange(tile, device=o.device)
    live_tiles = surv = slabs = exact = 0
    for s in range(0, picks.shape[0], max(1, _REF_ELEMS // max(n_prims, 1))):
        tiles = picks[s:s + max(1, _REF_ELEMS // max(n_prims, 1))]
        rays = (tiles[:, None] * tile + lane).reshape(-1)
        rays = rays[rays < r]  # only the wavefront's last tile is short
        hit = bundle_hits(ray_bundles(o[rays], d[rays], t_max[rays], tile), tables.boxes)
        n_live = torch.nn.functional.pad(live[rays], (0, hit.shape[0] * tile - rays.shape[0]))
        n_live = n_live.reshape(-1, tile).sum(1)
        live_tiles += int((n_live > 0).sum())
        surv += int(hit.sum())
        slabs += int((n_live * hit.sum(1)).sum())
        ti, pi = hit.nonzero(as_tuple=True)
        chunk = max(1, _REF_ELEMS // tile)
        for c in range(0, ti.shape[0], chunk):
            q = (ti[c:c + chunk, None] * tile + lane).reshape(-1)
            p = pi[c:c + chunk, None].expand(-1, tile).reshape(-1)
            keep = q < rays.shape[0]
            q, p = rays[q[keep]], p[keep]
            exact += int((slab_entries(o[q], d[q], tables.boxes[:, p], t_fin[q])
                          & live[q]).sum())
    scale = n_tiles / picks.shape[0]
    w, n_live_rays = KINDS[kind], int(live.sum())
    ray_bytes = r * (4 * 7 + 8)  # o, d, t_max in; t, idx out
    out = dict(tiles=n_tiles, counted_tiles=int(picks.shape[0]), live_tiles=live_tiles * scale,
               bundle_tests=live_tiles * n_prims * scale, survivors=surv * scale,
               slab_tests=slabs * scale, exact_tests=exact * scale,
               all_pairs=n_live_rays * n_prims,
               all_pairs_flops=n_live_rays * n_prims * PAIR_FLOPS[kind],
               all_pairs_bytes=w * n_prims * 4 + ray_bytes)
    out["flops"] = out["exact_tests"] * PAIR_FLOPS[kind]
    out["bytes"] = (w + 6) * n_prims * 4 + ray_bytes
    out["cull_flops"] = (out["bundle_tests"] + out["slab_tests"]) * BOX_FLOPS
    out["reread_bytes"] = (out["live_tiles"] * 6 * n_prims + out["survivors"] * w) * 4
    out["survivors_per_tile"] = out["survivors"] / max(out["live_tiles"], 1)
    out["exact_per_ray"] = out["exact_tests"] / max(n_live_rays, 1)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _closest_cuda(o, d, t_max, tables: BruteTables, kind: str, t_min: float):
    from ...kernels import load_library
    from .traverse import _check

    global TRI_LAUNCHES, CONE_LAUNCHES
    dev = o.device
    r, n_prims = o.shape[0], tables.cm.shape[1]
    f32 = torch.float32
    for name, x, shape in (("o", o, (r, 3)), ("d", d, (r, 3)), ("t_max", t_max, (r,)),
                           ("packed", tables.cm, (KINDS[kind], n_prims)),
                           ("boxes", tables.boxes, (6, n_prims))):
        _check(name, x, shape, f32, dev)
    t_out = torch.empty((r,), dtype=f32, device=dev)
    idx_out = torch.empty((r,), dtype=torch.int32, device=dev)
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = load_library().bruteforce_launch(
        ctypes.c_int(r), p(o), p(d), p(t_max), p(tables.cm), p(tables.boxes),
        ctypes.c_int(n_prims), ctypes.c_int(int(kind == "cone")), ctypes.c_float(t_min),
        p(t_out), p(idx_out), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"bruteforce kernel launch failed: CUDA error {err}")
    if kind == "cone":
        CONE_LAUNCHES += 1
    else:
        TRI_LAUNCHES += 1
    return t_out, idx_out


def closest(o, d, t_max, tables: BruteTables, kind: str, t_min: float = 1e-4):
    """(t [R] INF on a miss, idx [R] int32 -1 on a miss) of rays against the
    tables of a pack (`tables_of`). CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if kind not in KINDS:
        raise ValueError(f"bruteforce: kind must be one of {sorted(KINDS)}, got {kind!r}")
    require_detached("bruteforce", o, d, t_max)
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    if o.device.type == "cpu":
        return closest_ref(o, d, t_max, tables, kind, t_min)
    if o.device.type == "cuda":
        return _closest_cuda(o, d, t_max, tables, kind, t_min)
    raise ValueError(f"bruteforce: no kernel for device {o.device}")
