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

Two variants of the TPU kernel's leaf test, each in the three modes, which
no render of either package passes (a user reaches them through this API,
or routes a render through them with `render_sample_ids`'s `closest_fn` /
`occlude_fn` hooks):

* `mxu=True` (cones; the TPU kernel's `_cone_block_mxu`): the six
  ray.frame projections of each (ray, row) as matrix products, on the
  tensor cores (TF32 halves of each operand, two passes a frame vector on
  an f32 pack, one on a bf16 pack), in tiles of the rays that enter each
  unit of a leaf. Its plain version is `brute_force(mxu=True)`; the two
  agree but on near ties, where their products round apart. Triangle
  leaves ignore the flag, as in JAX: they launch the f32 test.
* a bf16 pack (`pack_prim_hbm(bvh, kind, torch.bfloat16)`): the leaf
  geometry at half the bytes, each row held in registers across a run of
  the rays that enter its unit and widened to f32 (exactly) at each use.
  Its plain version is the brute force over the upcast pack, bit for bit.

Launches are counted by instance family: `KERNEL_LAUNCHES` and
`MIXED_LAUNCHES` the f32 test on an f32 pack, `MXU_LAUNCHES` every launch
of the tensor-core test, `BF16_LAUNCHES` every launch on a bf16 pack (an
mxu launch on a bf16 pack counts in both).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import bvh as bvh_mod
from ..intersect import INF
from ...utils import profiling
from . import traverse as ctraverse

#: the largest fanout the kernel is held to its twin at (it tests the
#: children of a super 64 at a time, so any power of two would run)
MAX_FANOUT = 256

KERNEL_LAUNCHES = 0  # closest-hit and any-hit launches
MIXED_LAUNCHES = 0  # mixed launches (is_any given)
MXU_LAUNCHES = 0  # launches of the tensor-core cone test (any mode or pack)
BF16_LAUNCHES = 0  # launches on a bf16 pack (any mode or test)
REF_CALLS = 0
#: leaf element types the kernel takes
PACK_DTYPES = (torch.float32, torch.bfloat16)
#: outward padding of a bf16 row's box, absolute and relative (its box is
#: computed in f64 and the row is tested in f32; cone_aabbs pads 1e-6)
ROW_BOX_PAD = 1e-6


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


def _row_boxes(rows: torch.Tensor, kind: str):
    """World AABBs ([N, 3] lo, hi in f32) of every point the leaf test can
    accept on the rows [N, W] (f32, a bf16 pack's upcast), in f64 and
    rounded outward. A triangle's are its three corners v0, v0 + e1,
    v0 + e2. A cone row is tested in its own frame M = (u, v, w), which the
    rounding leaves a little off orthonormal: a hit x has (x - b) . v in
    [min_d - b.v, max_d - b.v] and its distance in (u, w) at most R, the
    larger |r_base - slope y| at the two ends, so x = b + M^-1 q over that
    box of q."""
    r = rows.double()
    if kind == "tri":
        v0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
        pts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)
        lo, hi = pts.amin(1), pts.amax(1)
    else:
        b, m = r[:, 0:3], r[:, 3:12].reshape(-1, 3, 3)  # rows of m: u, v, w
        slope, r_base, min_d, max_d = r[:, 12], r[:, 13], r[:, 14], r[:, 15]
        ok = torch.linalg.det(m).abs() > 1e-6  # padding rows are all 0
        m = torch.where(ok[:, None, None], m, torch.eye(3, dtype=m.dtype, device=m.device))
        inv = torch.linalg.inv(m)  # columns: the world steps of q's axes
        bv = (b * m[:, 1]).sum(-1)
        y0, y1 = min_d - bv - ROW_BOX_PAD, max_d - bv + ROW_BOX_PAD
        rad = torch.maximum((r_base - slope * y0).abs(), (r_base - slope * y1).abs()) \
            + ROW_BOX_PAD
        ys = torch.stack([inv[:, :, 1] * y0[:, None], inv[:, :, 1] * y1[:, None]])
        spread = rad[:, None] * (inv[:, :, 0].abs() + inv[:, :, 2].abs())
        lo, hi = b + ys.amin(0) - spread, b + ys.amax(0) + spread
    pad = ROW_BOX_PAD * (1.0 + torch.maximum(lo.abs(), hi.abs()))
    lo, hi = lo - pad, hi + pad
    lo32, hi32 = lo.float(), hi.float()
    # rounded outward: an f32 bound that rounded inward moves one step out
    lo32 = torch.where(lo32.double() > lo, torch.nextafter(lo32, lo32.new_tensor(-INF)), lo32)
    hi32 = torch.where(hi32.double() < hi, torch.nextafter(hi32, hi32.new_tensor(INF)), hi32)
    return lo32, hi32


def _round_aos(aos: torch.Tensor, packed: torch.Tensor, kind: str) -> torch.Tensor:
    """`ops/traverse.cone_aos` / `tri_aos` rows [N, *] with their geometry
    taken from the rounded pack [C, W, K] (upcast; row = cluster * K +
    within): a cone's 16 test fields and its base_d = base . v of the
    rounded base and axis (what the normal subtracts), a triangle's v0 and
    v1 = v0 + e1, v2 = v0 + e2. Shading fields (normals, uvs, height,
    material) stay."""
    c, w, k = packed.shape
    g = packed.float().permute(0, 2, 1).reshape(c * k, w)[:aos.shape[0]]
    out = aos.clone()
    if kind == "cone":
        out[:, :16] = g
        out[:, 16] = (g[:, 0:3] * g[:, 6:9]).sum(-1)
    else:
        out[:, 0:3], out[:, 3:6], out[:, 6:9] = g[:, 0:3], g[:, 0:3] + g[:, 3:6], \
            g[:, 0:3] + g[:, 6:9]
    return out


def pack_prim_hbm(bvh: bvh_mod.BVH, kind: str, dtype=torch.float32) -> bvh_mod.BVH:
    """The BVH with its [C, W, K] leaf pack in `dtype` (the counterpart of
    the JAX package's `pack_prim_hbm`, without its 128-lane K padding: the
    kernel takes any K). float32 leaves the BVH as it is. bfloat16 halves
    the leaves' bytes (round to nearest even, as `astype`), and the rounding
    moves a coordinate by up to half a bf16 step (7.8e-3 at |x| in [2, 4),
    about two hair-fiber radii), so the f32 boxes would cull hits of the
    rounded rows: the pack comes with unit boxes (`uboxes`) recomputed from
    the rounded rows' boxes (`_row_boxes`), the heap's boxes refitted from
    them bottom-up and the super and child tables from those, each the
    union with the f32 box it replaces. Its winner-row table (`aos_rows`,
    from which a Hit is built) holds the rounded geometry too (`_round_aos`),
    so a hit's point, normal and frame lie on the cone or triangle that the
    kernel tested, and a cone pack's `far_inert` is taken again on the
    rounded rows (`bvh_mod.far_rays_inert`)."""
    if kind not in ctraverse.KINDS:
        raise ValueError(f"pack_prim_hbm: kind must be one of {sorted(ctraverse.KINDS)}, "
                         f"got {kind!r}")
    if dtype not in PACK_DTYPES:
        raise ValueError(f"pack_prim_hbm: dtype must be one of {PACK_DTYPES}, got {dtype}")
    if dtype == torch.float32:
        return dataclasses.replace(bvh, packed=bvh.packed.float().contiguous())
    if bvh.uboxes is None:
        raise ValueError("pack_prim_hbm: the BVH has no uboxes table (attach_bvh makes it)")
    packed = bvh.packed.to(dtype).contiguous()
    c, w, k = packed.shape
    lo, hi = _row_boxes(packed.float().permute(0, 2, 1).reshape(c * k, w), kind)
    new = bvh_mod.unit_boxes(lo, hi, bvh)
    uboxes = torch.cat([torch.minimum(new[:, :3], bvh.uboxes[:, :3]),
                        torch.maximum(new[:, 3:], bvh.uboxes[:, 3:])], dim=1).contiguous()
    bmin, bmax = bvh.bmin.clone(), bvh.bmax.clone()
    bmin[c - 1:] = torch.minimum(bmin[c - 1:], uboxes[:, :3].amin(2))
    bmax[c - 1:] = torch.maximum(bmax[c - 1:], uboxes[:, 3:].amax(2))
    for level in reversed(range(bvh.depth)):  # inner nodes, bottom-up
        nodes = torch.arange(2 ** level - 1, 2 ** (level + 1) - 1, device=bmin.device)
        bmin[nodes] = torch.minimum(bmin[nodes], torch.minimum(bmin[2 * nodes + 1],
                                                               bmin[2 * nodes + 2]))
        bmax[nodes] = torch.maximum(bmax[nodes], torch.maximum(bmax[2 * nodes + 1],
                                                               bmax[2 * nodes + 2]))
    aos = None if bvh.aos_rows is None else _round_aos(bvh.aos_rows, packed, kind)
    out = dataclasses.replace(bvh, packed=packed, bmin=bmin, bmax=bmax, uboxes=uboxes,
                              aos_rows=aos,
                              far_inert=kind == "cone" and bvh_mod.far_rays_inert(packed))
    if 0 < bvh.fanout < bvh.n_leaves:
        out = dataclasses.replace(out, sboxes=pack_super_boxes(out),
                                  cboxes=pack_child_boxes(out))
    return out


def _flags(is_any, r: int) -> torch.Tensor:
    """[R] any-hit flags as bool: a float flag is set above 0.5 (the JAX
    package's 1.0 = shadow ray)."""
    if tuple(is_any.shape) != (r,):
        raise ValueError(f"traverse_stream: is_any must be [{r}], got {tuple(is_any.shape)}")
    return is_any > 0.5 if is_any.is_floating_point() else is_any.bool()


def traverse_stream_ref(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
                        t_min: float = 1e-4, is_any=None, mxu: bool = False):
    """The kernel's plain version: brute force over the reordered pack (a
    bf16 pack upcast; with `mxu`, cone rows by `_cone_core_mxu`); with
    `is_any`, the closest-hit brute force on the rays whose flag is clear and
    the any-hit one on the others."""
    global REF_CALLS
    REF_CALLS += 1
    if is_any is None:
        return ctraverse.brute_force(o, d, t_max, bvh, kind, any_hit, t_min, mxu)
    flags = _flags(is_any, o.shape[0])
    t = torch.empty_like(t_max)
    row = torch.empty(t_max.shape, dtype=torch.int32, device=o.device)
    found = torch.empty(t_max.shape, dtype=torch.bool, device=o.device)
    for flag in (False, True):
        idx = (flags == flag).nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        t[idx], row[idx], found[idx] = ctraverse.brute_force(o[idx], d[idx], t_max[idx], bvh,
                                                             kind, flag, t_min, mxu)
    return t, row, found


def _traverse_stream_cuda(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool,
                          t_min: float, is_any, mxu: bool):
    from ...kernels import load_library

    global KERNEL_LAUNCHES, MIXED_LAUNCHES, MXU_LAUNCHES, BF16_LAUNCHES
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
            ("uboxes", bvh.uboxes, (c, 6, -(-k // bvh_mod.UNIT)), f32)):
        ctraverse._check(name, x, shape, dt, dev)
    bf16 = bvh.packed is not None and bvh.packed.dtype == torch.bfloat16
    ctraverse._check("packed", bvh.packed, (c, ctraverse.KINDS[kind], k),
                     torch.bfloat16 if bf16 else f32, dev)
    mxu = mxu and kind == "cone"  # triangle rows take the f32 test (the JAX rule)
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
        ctypes.c_int(int(kind == "cone")), ctypes.c_int(int(any_hit)), ctypes.c_int(int(bf16)),
        ctypes.c_int(int(mxu)), ctypes.c_void_p(None if flags is None else flags.data_ptr()),
        ctypes.c_float(t_min),
        p(t_out), p(row_out), p(found_out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"traverse_stream kernel launch failed: CUDA error {err}")
    if mxu or bf16:
        MXU_LAUNCHES += int(mxu)
        BF16_LAUNCHES += int(bf16)
    elif flags is None:
        KERNEL_LAUNCHES += 1
    else:
        MIXED_LAUNCHES += 1
    return t_out, row_out, found_out


def occupancy(bvh: bvh_mod.BVH, kind: str, mode: str = "closest", mxu: bool = False) -> dict:
    """The kernel instance a launch on `bvh` in `mode` ("closest", "any" or
    "mixed") takes, on the current CUDA device: its dynamic shared memory a
    block (`bytes`) and the blocks of it an SM holds (`blocks_per_sm`,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; the kernel is built for
    2 a SM, 64 registers a thread)."""
    from ...kernels import load_library

    if mode not in ("closest", "any", "mixed"):
        raise ValueError(f"occupancy: mode must be closest, any or mixed, got {mode!r}")
    n_bytes, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = load_library().stream_occupancy(
        ctypes.c_int(bvh.n_leaves // bvh.fanout), ctypes.c_int(bvh.leaf_size),
        ctypes.c_int(int(kind == "cone")), ctypes.c_int(int(mode == "any")),
        ctypes.c_int(int(mode == "mixed")), ctypes.c_int(int(bvh.packed.dtype == torch.bfloat16)),
        ctypes.c_int(int(mxu and kind == "cone")), ctypes.byref(n_bytes), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"traverse_stream occupancy query failed: CUDA error {err}")
    return dict(bytes=n_bytes.value, blocks_per_sm=blocks.value)


def traverse_stream(o, d, t_max, bvh: bvh_mod.BVH, kind: str, any_hit: bool = False,
                    t_min: float = 1e-4, is_any=None, mxu: bool = False):
    """(t [R], row [R] int32, found [R] bool) of rays against a two-level
    BVH. `is_any` [R] (bool, or float with 1.0 = shadow ray) gives each ray
    its own mode, in place of `any_hit`. `mxu` tests cone rows on the tensor
    cores (the JAX package ignores it for triangle rows, and so does this
    function: they launch the f32 test). A bf16 `bvh.packed`
    (`pack_prim_hbm`) launches the bf16 instances. CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise)."""
    if kind not in ctraverse.KINDS:
        raise ValueError(f"traverse_stream: kind must be one of {sorted(ctraverse.KINDS)}, "
                         f"got {kind!r}")
    if any_hit and is_any is not None:
        raise ValueError("traverse_stream: any_hit and is_any exclude each other")
    ctraverse.require_detached("traverse_stream", o, d, t_max)
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    with profiling.span("k3"):
        if o.device.type == "cpu":
            return traverse_stream_ref(o, d, t_max, bvh, kind, any_hit, t_min, is_any, mxu)
        if o.device.type == "cuda":
            return _traverse_stream_cuda(o, d, t_max, bvh, kind, any_hit, t_min, is_any, mxu)
        raise ValueError(f"traverse_stream: no kernel for device {o.device}")
