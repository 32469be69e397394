"""Two-level BVH traversal for leaf geometry too big for any cache: one CUDA
kernel (closest or any hit, cone or triangle leaves), with its plain torch
twin.

Counterpart of `ba_pathtracing_fur_tpu/ops/pallas/stream.py::
traverse_stream`, with the `(t, row, found)` contract of
`ops/cuda/traverse.py`: t is t_max on a miss and 0 for an accepted any hit,
row = cluster * leaf_size + within (-1 on a miss). A BVH is two-level when
`0 < fanout < n_leaves`: its heap level of n_leaves / fanout nodes holds the
super-clusters, each the parent of `fanout` consecutive leaf clusters.

`traverse_stream` dispatches on the device of its tensors: CPU tensors go
to `traverse_stream_ref` (the brute force of `ops/cuda/traverse.py` over the
same reordered pack: the lowest row among the nearest hits), CUDA tensors
launch `csrc/traverse_stream.cu` or raise. `KERNEL_LAUNCHES` and
`REF_CALLS` count which of the two ran. The kernel (the leaf-tile core of
`csrc/leaf_tiles.cuh`: a tile of 128 consecutive rays reads each leaf it
enters once into shared memory) returns the twin's rows on every ray,
exact t ties across clusters included: it keeps the lowest row among equal
t and visits a node whose entry equals the best t. It is fastest on rays
sorted by `ops/traverse._entry_morton_perms`, as `closest_hit`/`any_hit`
feed it.

Mixed mode (`is_any`, the TPU kernel's per-lane any-hit flag): each ray is
a closest-hit ray or a shadow ray by its own flag, and gets what the
closest or the any-hit launch would give it, in one launch of the kernel's
third instance (`MIXED_LAUNCHES`); the plain version runs each set's brute
force. `ops/traverse.joint_closest_any` feeds it a bounce's closest-hit
rays interleaved with the previous bounce's shadow rays.
"""

from __future__ import annotations

import ctypes

import torch

from .. import bvh as bvh_mod
from . import traverse as ctraverse

#: the largest fanout the kernel is held to its twin at (it tests the
#: children of a super 64 at a time, so any power of two would run)
MAX_FANOUT = 256

KERNEL_LAUNCHES = 0  # closest-hit and any-hit launches
MIXED_LAUNCHES = 0  # mixed launches (is_any given)
REF_CALLS = 0


def pack_super_boxes(bvh: bvh_mod.BVH) -> torch.Tensor:
    """[6, S] component-major super-cluster boxes (lo xyz, hi xyz): heap
    nodes S-1 .. 2S-2 for S = n_leaves / fanout."""
    s = bvh.n_leaves // bvh.fanout
    return torch.cat([bvh.bmin[s - 1:2 * s - 1].T, bvh.bmax[s - 1:2 * s - 1].T]).contiguous()


def pack_child_boxes(bvh: bvh_mod.BVH) -> torch.Tensor:
    """[S, 6, F] leaf-cluster boxes grouped per super-cluster: the children
    of super s are the leaves [s*F, (s+1)*F), component-major."""
    c, f = bvh.n_leaves, bvh.fanout
    boxes = torch.cat([bvh.bmin[c - 1:], bvh.bmax[c - 1:]], dim=1)  # [C, 6]
    return boxes.reshape(c // f, f, 6).permute(0, 2, 1).contiguous()


def _flags(is_any, r: int) -> torch.Tensor:
    """[R] any-hit flags as bool: a float flag is set above 0.5 (the JAX
    package's 1.0 = shadow ray)."""
    if tuple(is_any.shape) != (r,):
        raise ValueError(f"traverse_stream: is_any must be [{r}], got {tuple(is_any.shape)}")
    return is_any > 0.5 if is_any.is_floating_point() else is_any.bool()


def traverse_stream_ref(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
                        t_min: float = 1e-4, is_any=None):
    """The kernel's plain version: brute force over the reordered pack; with
    `is_any`, the closest-hit brute force on the rays whose flag is clear and
    the any-hit one on the others."""
    global REF_CALLS
    REF_CALLS += 1
    if is_any is None:
        return ctraverse.brute_force(o, d, t_max, bvh, kind, any_hit, t_min)
    flags = _flags(is_any, o.shape[0])
    t = torch.empty_like(t_max)
    row = torch.empty(t_max.shape, dtype=torch.int32, device=o.device)
    found = torch.empty(t_max.shape, dtype=torch.bool, device=o.device)
    for flag in (False, True):
        idx = (flags == flag).nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        t[idx], row[idx], found[idx] = ctraverse.brute_force(o[idx], d[idx], t_max[idx], bvh,
                                                             kind, flag, t_min)
    return t, row, found


def _traverse_stream_cuda(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool,
                          t_min: float, is_any):
    from ...kernels import load_library

    global KERNEL_LAUNCHES, MIXED_LAUNCHES
    dev = o.device
    r = o.shape[0]
    c, k, f = bvh.n_leaves, bvh.leaf_size, bvh.fanout
    if not 0 < f < c or f > MAX_FANOUT or f & (f - 1):
        raise ValueError(f"traverse_stream: needs a power-of-two fanout with 0 < fanout < "
                         f"n_leaves and fanout <= {MAX_FANOUT}; got fanout {f} over {c} leaves")
    s = c // f
    sboxes = bvh.sboxes if bvh.sboxes is not None else pack_super_boxes(bvh)
    cboxes = bvh.cboxes if bvh.cboxes is not None else pack_child_boxes(bvh)
    f32 = torch.float32
    for name, x, shape, dt in (
            ("o", o, (r, 3), f32), ("d", d, (r, 3), f32), ("t_max", t_max, (r,), f32),
            ("bmin", bvh.bmin, (2 * c - 1, 3), f32), ("bmax", bvh.bmax, (2 * c - 1, 3), f32),
            ("sboxes", sboxes, (6, s), f32), ("cboxes", cboxes, (s, 6, f), f32),
            ("packed", bvh.packed, (c, ctraverse.KINDS[kind], k), f32),
            ("uboxes", bvh.uboxes, (c, 6, -(-k // bvh_mod.UNIT)), f32)):
        ctraverse._check(name, x, shape, dt, dev)
    t_out = torch.empty((r,), dtype=f32, device=dev)
    row_out = torch.empty((r,), dtype=torch.int32, device=dev)
    found_out = torch.empty((r,), dtype=torch.bool, device=dev)
    flags = None if is_any is None else _flags(is_any, r).to(torch.uint8).contiguous()
    if flags is not None and flags.device != dev:
        raise ValueError(f"traverse_stream: is_any must be on {dev}, got {flags.device}")
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = load_library().stream_launch(
        ctypes.c_int(r), p(o), p(d), p(t_max), p(bvh.bmin), p(bvh.bmax), p(sboxes), p(cboxes),
        p(bvh.packed), p(bvh.uboxes), ctypes.c_int(s), ctypes.c_int(f), ctypes.c_int(k),
        ctypes.c_int(int(kind == "cone")), ctypes.c_int(int(any_hit)),
        ctypes.c_void_p(None if flags is None else flags.data_ptr()), ctypes.c_float(t_min),
        p(t_out), p(row_out), p(found_out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"traverse_stream kernel launch failed: CUDA error {err}")
    if flags is None:
        KERNEL_LAUNCHES += 1
    else:
        MIXED_LAUNCHES += 1
    return t_out, row_out, found_out


def traverse_stream(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
                    t_min: float = 1e-4, is_any=None):
    """(t [R], row [R] int32, found [R] bool) of rays against a two-level
    BVH. `is_any` [R] (bool, or float with 1.0 = shadow ray) gives each ray
    its own mode, in place of `any_hit`. CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if kind not in ctraverse.KINDS:
        raise ValueError(f"traverse_stream: kind must be one of {sorted(ctraverse.KINDS)}, "
                         f"got {kind!r}")
    if any_hit and is_any is not None:
        raise ValueError("traverse_stream: any_hit and is_any exclude each other")
    ctraverse.require_detached("traverse_stream", o, d, t_max)
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    if o.device.type == "cpu":
        return traverse_stream_ref(o, d, t_max, bvh, kind, any_hit, t_min, is_any)
    if o.device.type == "cuda":
        return _traverse_stream_cuda(o, d, t_max, bvh, kind, any_hit, t_min, is_any)
    raise ValueError(f"traverse_stream: no kernel for device {o.device}")
