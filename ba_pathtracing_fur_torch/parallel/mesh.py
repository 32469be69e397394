"""Device meshes for the sharded render.

Counterpart of `ba_pathtracing_fur_tpu/parallel/mesh.py`. A mesh is a
`[dp, geo]` grid of `torch.device`s with two axes:

  * "dp"  - data parallelism over pixels: each row renders its share of the
            image's global pixel ids;
  * "geo" - geometry parallelism: the primitive packs are split over a
            row's devices, each shard intersected on its own device and the
            nearest hits merged on the row's first device.

The JAX package's mesh is driven by one controller (`shard_map`); so is this
one: one process drives every device of the mesh, and a device may appear
more than once (the CPU eight times in the tests, one card several times in
the smoke). `multihost_initialize` brings up `torch.distributed` for callers
that run one such process a host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

DP_AXIS = "dp"
GEO_AXIS = "geo"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A [dp, geo] grid of devices; `shape` maps each axis name to its size,
    as the JAX package's `Mesh.shape` does."""

    devices: tuple  # dp rows, each a tuple of geo torch.devices

    @property
    def shape(self) -> dict:
        return {DP_AXIS: len(self.devices), GEO_AXIS: len(self.devices[0])}


def make_mesh(n_devices: Optional[int] = None, geo: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, geo) mesh over the first `n_devices` of `devices` (default: all
    of them); dp = n_devices // geo. The default `devices` is every visible
    CUDA device; with none visible it raises (no fallback to the CPU)."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass `devices` "
                               "(e.g. [torch.device('cpu')] * 8) to build a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"n_devices={n_devices} but only {len(devices)} devices given")
    if geo < 1 or n_devices % geo != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by geo={geo}")
    devices = devices[:n_devices]
    return Mesh(tuple(tuple(devices[r * geo:(r + 1) * geo]) for r in range(n_devices // geo)))


def multihost_initialize(**kwargs) -> None:
    """`torch.distributed.init_process_group(**kwargs)` (the address, world
    size and rank come from the caller, e.g. init_method="tcp://host:port");
    a no-op when the group is already initialized. The backend defaults to
    NCCL with a CUDA device visible, else gloo."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)
