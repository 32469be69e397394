"""Permutation helpers of the wavefront (counterpart of
`ba_pathtracing_fur_tpu/ops/compact.py`; only what the traversal's ray sort
needs)."""

from __future__ import annotations

import torch


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i (int32)."""
    r = perm.shape[0]
    inv = torch.empty((r,), dtype=torch.int32, device=perm.device)
    inv[perm] = torch.arange(r, dtype=torch.int32, device=perm.device)
    return inv
