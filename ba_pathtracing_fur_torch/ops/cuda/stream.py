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
"""

from __future__ import annotations

import ctypes

import torch

from .. import bvh as bvh_mod
from . import traverse as ctraverse

#: the largest fanout the kernel is held to its twin at (it tests the
#: children of a super 64 at a time, so any power of two would run)
MAX_FANOUT = 256

KERNEL_LAUNCHES = 0
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


def traverse_stream_ref(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
                        t_min: float = 1e-4):
    """The kernel's plain version: brute force over the reordered pack."""
    global REF_CALLS
    REF_CALLS += 1
    return ctraverse.brute_force(o, d, t_max, bvh, kind, any_hit, t_min)


def _traverse_stream_cuda(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool,
                          t_min: float):
    from ...kernels import load_library

    global KERNEL_LAUNCHES
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
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = load_library().stream_launch(
        ctypes.c_int(r), p(o), p(d), p(t_max), p(bvh.bmin), p(bvh.bmax), p(sboxes), p(cboxes),
        p(bvh.packed), p(bvh.uboxes), ctypes.c_int(s), ctypes.c_int(f), ctypes.c_int(k),
        ctypes.c_int(int(kind == "cone")), ctypes.c_int(int(any_hit)), ctypes.c_float(t_min),
        p(t_out), p(row_out), p(found_out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"traverse_stream kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return t_out, row_out, found_out


def traverse_stream(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
                    t_min: float = 1e-4):
    """(t [R], row [R] int32, found [R] bool) of rays against a two-level
    BVH. CPU tensors run the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if kind not in ctraverse.KINDS:
        raise ValueError(f"traverse_stream: kind must be one of {sorted(ctraverse.KINDS)}, "
                         f"got {kind!r}")
    ctraverse.require_detached("traverse_stream", o, d, t_max)
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    if o.device.type == "cpu":
        return traverse_stream_ref(o, d, t_max, bvh, kind, any_hit, t_min)
    if o.device.type == "cuda":
        return _traverse_stream_cuda(o, d, t_max, bvh, kind, any_hit, t_min)
    raise ValueError(f"traverse_stream: no kernel for device {o.device}")
