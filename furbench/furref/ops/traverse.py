"""The reference's own scene search, and the Hit assembly frozen from the port.

`closest_hit` and `any_hit` answer what the port's `ops/traverse` answers,
without a BVH and without a kernel: the primitives of each pack are grouped
in runs of GROUP along a morton curve of their box centres (the groups and
their boxes are this module's own, made from the pack the reference grew
itself), every ray is tested against every group box it enters, and the
groups it enters are visited near to far in rounds, each round testing
every primitive of the groups still nearer than the ray's best hit. The
leaf tests (`_cone_core`, `_tri_core`), the winner-t recompute and the Hit
assembly are frozen copies of the port's (`ops/bvh.py`, `ops/traverse.py`
at commit 24f22d1), so that where the search finds the port's row, the Hit
is the port's bit for bit. A tie in t goes to the lowest primitive id.

`round_to` (a torch dtype or None) rounds every float the assembly hands on
to that dtype and back: the lower-precision control of the benchmark's
check.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import vecmath as vm
from ..scene.types import ConePack, DeviceScene, TrianglePack
from . import bruteforce, intersect as isect
from .bvh import _cone_core, _tri_core, morton_codes

INF = isect.INF
#: primitives a group
GROUP = 256
#: (ray, group) pairs tested at once
_PAIR_CHUNK = 4096
#: elements of one ray-by-group-box slab test
_BOX_ELEMS = 1 << 24

#: the search's key of a ray without a hit yet ((t bits << 32) | row otherwise)
_NO_KEY = torch.iinfo(torch.int64).max


@dataclasses.dataclass
class Groups:
    comp: torch.Tensor  # [N + 1, W] each row's leaf-test components; row N never hits
    idx: torch.Tensor  # [G, GROUP] int64 rows, N on padding
    lo: torch.Tensor  # [G, 3]
    hi: torch.Tensor  # [G, 3]


def _components(pack, kind: str) -> torch.Tensor:
    if kind == "cone":
        cols = [pack.base, pack.u, pack.v, pack.w,
                torch.stack([pack.slope, pack.r_base, pack.min_d, pack.max_d], 1)]
    else:
        cols = [pack.v0, pack.v1 - pack.v0, pack.v2 - pack.v0]
    return torch.cat(cols, 1).detach().float()


def groups_of(pack, kind: str) -> Groups:
    """The pack's groups, made once per pack (kept on the pack)."""
    g = getattr(pack, "_furref_groups", None)
    if g is not None:
        return g
    lo, hi = (isect.cone_aabbs if kind == "cone" else isect.triangle_aabbs)(pack)
    lo, hi = lo.detach(), hi.detach()
    n = lo.shape[0]
    cent = 0.5 * (lo + hi)
    order = torch.argsort(morton_codes(cent, cent.amin(0), cent.amax(0)), stable=True)
    n_groups = -(-n // GROUP)
    idx = torch.full((n_groups * GROUP,), n, dtype=torch.int64, device=lo.device)
    idx[:n] = order
    idx = idx.reshape(n_groups, GROUP)
    pad = idx == n
    safe = torch.clamp(idx, max=n - 1)
    glo = torch.where(pad[..., None], INF, lo[safe]).amin(1)
    ghi = torch.where(pad[..., None], -INF, hi[safe]).amax(1)
    # a margin so that rounding in the slab test never drops a group
    margin = 1e-5 * (ghi - glo).abs().amax(1, keepdim=True) + 1e-6
    comp = _components(pack, kind)
    never = torch.zeros((1, comp.shape[1]), dtype=comp.dtype, device=comp.device)
    if kind == "cone":
        never[0, 14], never[0, 15] = 1.0, -1.0  # an empty axis slab, as the port pads
    g = Groups(comp=torch.cat([comp, never]), idx=idx, lo=glo - margin, hi=ghi + margin)
    object.__setattr__(pack, "_furref_groups", g)
    return g


def _slab(o, d, lo, hi, t_best):
    """Entry t of rays [R] into boxes [G] -> [R, G], INF where missed or
    entered beyond t_best."""
    eps = 1e-20
    inv = 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(2)
    tf = torch.maximum(t0, t1).amin(2)
    ok = (tn <= tf) & (tf >= 0.0) & (tn <= t_best[:, None])
    return torch.where(ok, torch.clamp(tn, min=0.0), INF)


def _entries(o, d, t_max, g: Groups):
    """Every (ray, group) pair whose box the ray enters below t_max, sorted
    by ray and then by entry t -> (ray, group, entry t, rank within ray)."""
    step = max(1, _BOX_ELEMS // g.lo.shape[0])
    rays, grp, tns = [], [], []
    for s in range(0, o.shape[0], step):
        tn = _slab(o[s:s + step], d[s:s + step], g.lo, g.hi, t_max[s:s + step])
        r, c = (tn < INF).nonzero(as_tuple=True)
        rays.append(r + s)
        grp.append(c)
        tns.append(tn[r, c])
    ray, grp, tn = torch.cat(rays), torch.cat(grp), torch.cat(tns)
    order = torch.argsort(tn, stable=True)
    order = order[torch.argsort(ray[order], stable=True)]
    ray, grp, tn = ray[order], grp[order], tn[order]
    first = torch.searchsorted(ray, ray, right=False)
    rank = torch.arange(ray.shape[0], device=ray.device) - first
    return ray, grp, tn, rank


def _test_pairs(o, d, ray, grp, g: Groups, kind, t_min, t_best):
    """The leaf test of every primitive of each pair's group -> (t [P, GROUP],
    rows [P, GROUP])."""
    rows = g.idx[grp]
    comp = g.comp[rows]  # [P, GROUP, W]
    core = _cone_core if kind == "cone" else _tri_core
    t = core(o[ray], d[ray], [comp[:, :, i] for i in range(comp.shape[2])], t_min,
             t_best[ray])
    return t, rows


def search(o, d, t_max, pack, kind: str, t_min: float, any_hit: bool):
    """(row [R] int64, found [R] bool) of the nearest primitive in
    (t_min, t_max) of each ray, or with `any_hit` of any primitive there
    (row then unused)."""
    r = o.shape[0]
    g = groups_of(pack, kind)
    n = g.comp.shape[0] - 1
    best = t_max.clone()
    key = torch.full((r,), _NO_KEY, dtype=torch.int64, device=o.device)
    found = torch.zeros((r,), dtype=torch.bool, device=o.device)
    if r == 0:
        return key, found
    ray, grp, tn, rank = _entries(o, d, t_max, g)
    lo_rank, width = 0, 2
    while ray.numel():
        in_round = rank < lo_rank + width
        sel = in_round & (tn <= best[ray]) & ~(any_hit & found[ray])
        pr, pg = ray[sel], grp[sel]
        for s in range(0, pr.shape[0], _PAIR_CHUNK):
            cr, cg = pr[s:s + _PAIR_CHUNK], pg[s:s + _PAIR_CHUNK]
            t, rows = _test_pairs(o, d, cr, cg, g, kind, t_min, t_max if any_hit else best)
            hit = (t < INF) & (rows < n)
            if any_hit:
                found[cr[hit.any(1)]] = True
                continue
            bits = t.contiguous().view(torch.int32).to(torch.int64)
            k = torch.where(hit, (bits << 32) | rows, _NO_KEY)
            key.scatter_reduce_(0, cr, k.amin(1), reduce="amin")
            has = key < _NO_KEY
            best = torch.where(has, (key >> 32).to(torch.int32).view(torch.float32), best)
        keep = ~in_round
        ray, grp, tn, rank = ray[keep], grp[keep], tn[keep], rank[keep]
        lo_rank += width
        width *= 2
    if any_hit:
        return torch.zeros((r,), dtype=torch.int64, device=o.device), found
    found = key < _NO_KEY
    return torch.where(found, key & 0xFFFFFFFF, 0), found


# ---------------------------------------------------------------------------
# Frozen from the port's ops/traverse.py (commit 24f22d1)
# ---------------------------------------------------------------------------

def _i2f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.float32)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def cone_aos(cones: ConePack) -> torch.Tensor:
    return torch.cat([cones.base, cones.u, cones.v, cones.w,
                      torch.stack([cones.slope, cones.r_base, cones.min_d, cones.max_d,
                                   cones.base_d, cones.height, _i2f(cones.mat_id)], dim=1)],
                     dim=1)


def tri_aos(tris: TrianglePack) -> torch.Tensor:
    return torch.cat([tris.v0, tris.v1, tris.v2, tris.n0, tris.n1, tris.n2,
                      tris.uv0, tris.uv1, tris.uv2, tris.fiber_u, tris.fiber_v,
                      tris.fiber_w, _i2f(tris.mat_id)[:, None]], dim=1)


def take_cone_rows(aos: torch.Tensor, rows: torch.Tensor) -> dict:
    g = aos[rows.long()]
    return {"base": g[:, 0:3], "u": g[:, 3:6], "v": g[:, 6:9], "w": g[:, 9:12],
            "slope": g[:, 12], "r_base": g[:, 13], "min_d": g[:, 14], "max_d": g[:, 15],
            "base_d": g[:, 16], "height": g[:, 17], "mat_id": _f2i(g[:, 18]), "_g": g}


def take_tri_rows(aos: torch.Tensor, rows: torch.Tensor) -> TrianglePack:
    g = aos[rows.long()]
    return TrianglePack(
        v0=g[:, 0:3], v1=g[:, 3:6], v2=g[:, 6:9], n0=g[:, 9:12], n1=g[:, 12:15],
        n2=g[:, 15:18], uv0=g[:, 18:20], uv1=g[:, 20:22], uv2=g[:, 22:24],
        fiber_u=g[:, 24:27], fiber_v=g[:, 27:30], fiber_w=g[:, 30:33],
        mat_id=_f2i(g[:, 33]))


def _recompute_t_tri(rp: TrianglePack, o, d, t_min, t_best):
    v0, e1, e2 = rp.v0, rp.v1 - rp.v0, rp.v2 - rp.v0
    comp = [v0[:, 0:1], v0[:, 1:2], v0[:, 2:3], e1[:, 0:1], e1[:, 1:2], e1[:, 2:3],
            e2[:, 0:1], e2[:, 1:2], e2[:, 2:3]]
    return _tri_core(o, d, comp, t_min, t_best)[:, 0]


def _recompute_t_cone(rc: dict, o, d, t_min, t_best):
    g = rc["_g"]
    return _cone_core(o, d, [g[:, i:i + 1] for i in range(16)], t_min, t_best)[:, 0]


def _cone_enter_rows(base, u_ax, v_ax, w_ax, slope, r_base, o, d, t):
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


def _assemble_hit(o, d, scene: DeviceScene, t_tri, tri_row, t_cone, cone_row, t_max,
                  tri_rp=None, cone_rc=None) -> bruteforce.Hit:
    r = o.shape[0]
    tris, cones = scene.tris, scene.cones
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

    if tris.count:
        if tri_rp is None:
            tri_rp = take_tri_rows(tri_aos(tris), tri_row)
        is_tri = prim_type == bruteforce.PRIM_TRI
        e = torch.tensor([0.0, 0.0, 1.0], device=o.device)
        tn, tuv, _ = isect.triangle_interpolate_rows(tri_rp, position, w3(is_tri, o, tri_rp.v0 - e),
                                                     w3(is_tri, d, e))
        n, uv = w3(is_tri, tn, n), w3(is_tri, tuv, uv)
        mat_id = torch.where(is_tri, tri_rp.mat_id, mat_id)
        fu, fv, fw = (w3(is_tri, tri_rp.fiber_u, fu), w3(is_tri, tri_rp.fiber_v, fv),
                      w3(is_tri, tri_rp.fiber_w, fw))
        prim_id = torch.where(is_tri, tri_row.to(torch.int32), prim_id)
    if cones.count:
        if cone_rc is None:
            cone_rc = take_cone_rows(cone_aos(cones), cone_row)
        is_cone = prim_type == bruteforce.PRIM_CONE
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
        prim_id = torch.where(is_cone, cone_row.to(torch.int32), prim_id)

    return bruteforce.Hit(
        t=torch.where(valid, t, INF), valid=valid, prim_type=prim_type, prim_id=prim_id,
        mat_id=mat_id, position=position, normal=n, uv=uv, enter=enter, fiber_u=fu,
        fiber_v=fv, fiber_w=fw)


def _t_max_of(t_max, r, like):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=like.device), (r,)).contiguous()


def _round_hit(hit: bruteforce.Hit, round_to) -> bruteforce.Hit:
    if round_to is None:
        return hit
    return dataclasses.replace(hit, **{
        f.name: getattr(hit, f.name).to(round_to).float()
        for f in dataclasses.fields(hit) if getattr(hit, f.name).is_floating_point()})


def closest_hit(o, d, scene: DeviceScene, t_min=1e-4, t_max=INF, n_alive=None,
                round_to=None) -> bruteforce.Hit:
    """The nearest Hit of each ray, as the port's `ops/traverse.closest_hit`
    gives it: rows picked on detached rays, the winner's t and the Hit
    computed in torch from the live rays (gradients flow through them)."""
    r = o.shape[0]
    t_max = _t_max_of(t_max, r, o)
    o_s, d_s, t_s = o.detach(), d.detach(), t_max.detach()
    kinds = {}
    for kind, pack, aos_fn, take, recompute in (
            ("tri", scene.tris, tri_aos, take_tri_rows, _recompute_t_tri),
            ("cone", scene.cones, cone_aos, take_cone_rows, _recompute_t_cone)):
        if pack.count:
            row, found = search(o_s, d_s, t_s, pack, kind, t_min, False)
            rp = take(aos_fn(pack), row)
            kinds[kind] = (torch.where(found, recompute(rp, o, d, t_min, t_max), INF), row, rp)
        else:
            kinds[kind] = (torch.full((r,), INF, device=o.device),
                           torch.zeros((r,), dtype=torch.int64, device=o.device), None)
    (t_tri, tri_row, tri_rp), (t_cone, cone_row, cone_rc) = kinds["tri"], kinds["cone"]
    return _round_hit(_assemble_hit(o, d, scene, t_tri, tri_row, t_cone, cone_row, t_max,
                                    tri_rp=tri_rp, cone_rc=cone_rc), round_to)


def any_hit(o, d, scene: DeviceScene, t_max, t_min=1e-4, n_alive=None) -> torch.Tensor:
    """Does any primitive lie in (t_min, t_max) of each ray? -> [R] bool."""
    r = o.shape[0]
    o, d, t_max = o.detach(), d.detach(), _t_max_of(t_max, r, o).detach()
    blocked = torch.zeros((r,), dtype=torch.bool, device=o.device)
    for kind, pack in (("tri", scene.tris), ("cone", scene.cones)):
        if pack.count:
            blocked |= search(o, d, t_max, pack, kind, t_min, True)[1]
    return blocked
