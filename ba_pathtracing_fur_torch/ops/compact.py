"""Stream compaction of live rays and the permutation helpers of the
wavefront (counterpart of `ba_pathtracing_fur_tpu/ops/compact.py`).

A prefix sum over the alive mask and one scatter make a stable permutation
with the live rays first; gathering every `[R, ...]` field of the ray state
by it compacts the wavefront, and `n_alive` says how much of it is live.
"""

from __future__ import annotations

import dataclasses

import torch


def compaction_permutation(alive: torch.Tensor):
    """[R] bool -> (perm [R] int32, n_alive 0-d int32 tensor): the indices
    of the alive rays first, in their order, then the dead ones in theirs."""
    r = alive.shape[0]
    alive_i = alive.to(torch.int32)
    n_alive = alive_i.sum(dtype=torch.int32)
    front = torch.cumsum(alive_i, 0, dtype=torch.int32) - 1  # slot among alive
    back = n_alive + torch.cumsum(1 - alive_i, 0, dtype=torch.int32) - 1  # among dead
    slot = torch.where(alive, front, back)
    perm = torch.empty((r,), dtype=torch.int32, device=alive.device)
    perm[slot.long()] = torch.arange(r, dtype=torch.int32, device=alive.device)
    return perm, n_alive


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i (int32)."""
    r = perm.shape[0]
    inv = torch.empty((r,), dtype=torch.int32, device=perm.device)
    inv[perm.long()] = torch.arange(r, dtype=torch.int32, device=perm.device)
    return inv


def gather_fields(obj, perm: torch.Tensor):
    """A copy of the dataclass `obj` with every tensor field gathered by the
    ray permutation `perm` (the JAX package's `gather_pytree`)."""
    idx = perm.long()
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name)[idx] for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})
