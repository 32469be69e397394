"""Hit assembly (K6): the closest Hit of each ray from the winner rows the
traversal kernels picked, as one CUDA kernel.

No counterpart among the TPU kernels: the JAX package's `_assemble_hit`
(and the winner-t recompute before it) is plain JAX that XLA fuses. The
port's plain version is the torch assembly in `ops/traverse` (`_torch_hit`,
`_assemble_hit`): the winner rows' gathers, the t recompute by the leaf
test and the merge into `bruteforce.Hit`, about 370 small launches a bounce
on the card. `csrc/hit.cu` does all of it in one launch and gives the same
Hit bit for bit.

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

import torch

from ..bruteforce import Hit

#: columns of a kind's winner-row table (`ops/traverse.tri_aos` / `cone_aos`)
KIND_COLS = {"tri": 34, "cone": 19}

HIT_LAUNCHES = 0
HIT_REF_CALLS = 0
HIT_GRAD_CALLS = 0

#: the fields of the Hit that carry a gradient (the others are flags and ids)
_FLOAT_FIELDS = tuple(f.name for f in dataclasses.fields(Hit)
                      if f.name not in ("valid", "prim_type", "prim_id", "mat_id", "enter"))


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
    (`ops/traverse._torch_hit`), which autograd records through."""
    from ..traverse import _torch_hit

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
        from ..traverse import _torch_hit

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
