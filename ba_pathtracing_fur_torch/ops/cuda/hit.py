"""Hit assembly (K6): the closest Hit of each ray from the winner rows the
traversal kernels picked, as one CUDA kernel.

No counterpart among the TPU kernels: the JAX package's `_assemble_hit`
(and the winner-t recompute before it) is plain JAX that XLA fuses. The
port's plain version is the torch assembly below (`_torch_hit`,
`_assemble_hit`): the winner rows' gathers from the row tables (`cone_aos`,
`tri_aos`, `pack_aos`), the t recompute by the leaf test and the merge into
`bruteforce.Hit`, about 370 small launches a bounce on the card.
`csrc/hit.cu` does all of it in one launch and gives the same Hit bit for
bit.

`hit_of_rows` dispatches on the device: CUDA tensors launch the kernel,
CPU tensors run the torch assembly. Where autograd records through the
rays, t_max, a row table or a dense-grid t (`diff/fit`, the unfused bounce
under autograd), the kernel still makes the Hit, inside `_KernelHit`, an
autograd Function whose backward runs the torch assembly again on the saved
inputs and differentiates it, as activation checkpointing does; the Hit is
the same bit for bit, so the gradients are those of the torch assembly.
`HIT_LAUNCHES` counts the kernel's launches, `HIT_REF_CALLS` the torch
assembly's forward calls and `HIT_GRAD_CALLS` its backward recomputes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch

from ...core import vecmath as vm
from ...scene.types import ConePack, TrianglePack
from .. import bruteforce, bvh as bvh_mod, intersect as isect
from ..bruteforce import Hit
from ..intersect import INF

#: columns of a kind's winner-row table (`tri_aos` / `cone_aos`)
KIND_COLS = {"tri": 34, "cone": 19}

HIT_LAUNCHES = 0
HIT_REF_CALLS = 0
HIT_GRAD_CALLS = 0

#: the fields of the Hit that carry a gradient (the others are flags and ids)
_FLOAT_FIELDS = tuple(f.name for f in dataclasses.fields(Hit)
                      if f.name not in ("valid", "prim_type", "prim_id", "mat_id", "enter"))


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


def _torch_hit(o, d, t_max, t_min, won: dict) -> bruteforce.Hit:
    """The torch assembly, K6's plain version (`won` is `hit_of_rows`'s
    `kinds`) and the graph K6's backward differentiates: each kind's rows
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


def hit_of_rows(o, d, t_max, t_min: float, kinds: dict) -> Hit:
    """The closest Hit of rays o, d [R, 3] below t_max [R] from each kind's
    winners, `kinds[kind] = (aos [N, KIND_COLS[kind]], row [R] int32 (0 on a
    miss), found [R] bool or None, t [R] or None, perm or None)` for "tri"
    and "cone" (a kind absent has no primitives): the winner's t is
    recomputed from its row where `found` is given, taken as it is where `t`
    is (the dense grid's), and `perm` maps a row to the primitive's id.
    K6 for CUDA tensors (through `_KernelHit` where autograd records), the
    torch assembly (`hit_of_rows_ref`) for CPU tensors."""
    if o.device.type != "cuda":
        return hit_of_rows_ref(o, d, t_max, t_min, kinds)
    if torch.is_grad_enabled():
        diff = _differentiable(o, d, t_max, kinds)
        if any(x.requires_grad for x in diff):
            out = _KernelHit.apply(t_min, kinds, *diff)
            return Hit(**dict(zip((f.name for f in dataclasses.fields(Hit)), out)))
    return _hit_cuda(o, d, t_max, t_min, kinds)


def hit_of_rows_ref(o, d, t_max, t_min: float, kinds: dict) -> Hit:
    """The kernel's plain version, on any device: the torch assembly
    (`_torch_hit`), which autograd records through."""
    global HIT_REF_CALLS
    HIT_REF_CALLS += 1
    return _torch_hit(o, d, t_max, t_min, kinds)


def work_ref(hit: Hit, kinds: dict) -> dict:
    """The bytes the kernel must move for these winners and the Hit it gave
    (its bound; the arithmetic, ~300 flops a ray, is far below it): each
    ray's o, d and t_max and each kind's row and found flag (or dense-grid
    t) read once, every Hit field written once, each kind's winner row read
    once where it is tested (found) or, for a dense-grid kind, where it won,
    and the perm entry of the winning kind -> dict(bytes, rows: the winner
    rows read)."""
    r = hit.t.shape[0]
    n = r * (3 * 4 * 2 + 4)
    n += sum(x.element_size() * x.numel() for x in (getattr(hit, f.name)
                                                   for f in dataclasses.fields(Hit)))
    rows = 0
    for kind, prim in (("tri", 0), ("cone", 1)):
        if kind not in kinds:
            continue
        aos, row, found, t, perm = kinds[kind]
        won = int((hit.valid & (hit.prim_type == prim)).sum())
        n += r * (4 + (1 if found is not None else 4))
        read = int(found.sum()) if found is not None else won
        rows += read
        n += read * KIND_COLS[kind] * 4 + (won * 4 if perm is not None else 0)
    return dict(bytes=n, rows=rows)


def _differentiable(o, d, t_max, kinds: dict) -> list:
    """The inputs a gradient can reach: the rays, t_max, and each kind's row
    table and dense-grid t, in `_with_inputs`'s order."""
    return [o, d, t_max, *(x for kind in ("tri", "cone") if kind in kinds
                           for x in (kinds[kind][0], kinds[kind][3]) if x is not None)]


def _with_inputs(kinds: dict, xs: list) -> dict:
    """`kinds` with its row tables and dense-grid ts replaced by `xs` (the
    tail of `_differentiable`'s list)."""
    it = iter(xs)
    out = {}
    for kind in ("tri", "cone"):
        if kind in kinds:
            _, row, found, t, perm = kinds[kind]
            out[kind] = (next(it), row, found, None if t is None else next(it), perm)
    return out


class _KernelHit(torch.autograd.Function):
    """K6's Hit with the torch assembly's gradient: the forward launches the
    kernel, the backward recomputes the torch assembly from the saved inputs
    under autograd and returns its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, t_min, kinds, o, d, t_max, *rest):
        hit = _hit_cuda(o, d, t_max, t_min, kinds)
        ctx.t_min, ctx.kinds = t_min, kinds
        ctx.save_for_backward(o, d, t_max, *rest)
        out = tuple(getattr(hit, f.name) for f in dataclasses.fields(Hit))
        ctx.mark_non_differentiable(*(x for x, f in zip(out, dataclasses.fields(Hit))
                                      if f.name not in _FLOAT_FIELDS))
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        global HIT_GRAD_CALLS
        HIT_GRAD_CALLS += 1
        need = ctx.needs_input_grad[2:]
        xs = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            hit = _torch_hit(xs[0], xs[1], xs[2], ctx.t_min, _with_inputs(ctx.kinds, xs[3:]))
        outs, gs = [], []
        for f, g in zip(dataclasses.fields(Hit), grads):
            y = getattr(hit, f.name)
            if f.name in _FLOAT_FIELDS and g is not None and y.requires_grad:
                outs.append(y)
                gs.append(g)
        wrt = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(outs, wrt, gs, allow_unused=True) if outs and wrt
                   else [None] * len(wrt))
        return (None, None, *(next(got) if x.requires_grad else None for x in xs))


def _hit_cuda(o, d, t_max, t_min: float, kinds: dict) -> Hit:
    from ...kernels import load_library
    from .traverse import _check

    global HIT_LAUNCHES
    dev = o.device
    r = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    for name, x, shape in (("o", o, (r, 3)), ("d", d, (r, 3)), ("t_max", t_max, (r,))):
        _check(name, x, shape, f32, dev)
    p = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())  # noqa: E731
    args = []
    for kind in ("tri", "cone"):
        if kind not in kinds:
            args += [p(None)] * 5
            continue
        aos, row, found, t, perm = (None if x is None else x.contiguous() for x in kinds[kind])
        _check(f"{kind} aos", aos, (aos.shape[0], KIND_COLS[kind]), f32, dev)
        _check(f"{kind} row", row, (r,), i32, dev)
        if (found is None) == (t is None):
            raise ValueError(f"hit: the {kind} winners need found or t, not both")
        if found is not None:
            _check(f"{kind} found", found, (r,), torch.bool, dev)
        else:
            _check(f"{kind} t", t, (r,), f32, dev)
        if perm is not None:
            _check(f"{kind} perm", perm, (perm.shape[0],), i32, dev)
        args += [p(aos), p(row), p(found), p(t), p(perm)]
    v3 = lambda: torch.empty((r, 3), dtype=f32, device=dev)  # noqa: E731
    hit = Hit(t=torch.empty((r,), dtype=f32, device=dev),
              valid=torch.empty((r,), dtype=torch.bool, device=dev),
              prim_type=torch.empty((r,), dtype=i32, device=dev),
              prim_id=torch.empty((r,), dtype=i32, device=dev),
              mat_id=torch.empty((r,), dtype=i32, device=dev), position=v3(), normal=v3(),
              uv=torch.empty((r, 2), dtype=f32, device=dev),
              enter=torch.empty((r,), dtype=torch.bool, device=dev), fiber_u=v3(),
              fiber_v=v3(), fiber_w=v3())
    outs = [getattr(hit, f.name) for f in dataclasses.fields(Hit)]
    err = load_library().hit_launch(
        ctypes.c_int(r), p(o), p(d), p(t_max), ctypes.c_float(t_min), *args, *map(p, outs),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"hit kernel launch failed: CUDA error {err}")
    HIT_LAUNCHES += 1
    return hit
