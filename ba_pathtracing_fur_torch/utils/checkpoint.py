"""Checkpoint and resume of progressive renders and fitted parameters.

Counterpart of `ba_pathtracing_fur_tpu/utils/checkpoint.py`. The
reference's resumable state is the in-memory progressive accumulator and
its sample counter (the running mean, CPU_PathTracer.cpp:68-79); here it is
an explicit `RenderState` (the mean image, the sample count, the base key
and optional fitted parameters) saved atomically to one .npz in the JAX
package's format: `accum` f32 [H,W,3], `sample_count` int32, `key_data` the
key's two uint32 words, `param.<name>` arrays. A checkpoint written by
either package resumes in the other.
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch


class RenderState(NamedTuple):
    accum: torch.Tensor  # [H,W,3] running mean
    sample_count: int
    key_data: torch.Tensor  # [2] int64: the key's two 32-bit words (core/rng)
    params: Optional[dict] = None  # fitted parameters, if fitting


def fresh_state(resolution, key: torch.Tensor) -> RenderState:
    """A state before the first sample, on the key's device."""
    w, h = resolution
    return RenderState(accum=torch.zeros((h, w, 3), dtype=torch.float32, device=key.device),
                       sample_count=0, key_data=key)


def state_key(state: RenderState) -> torch.Tensor:
    return state.key_data


def save_checkpoint(path: str, state: RenderState) -> None:
    """Atomic single-file save (a temporary file, then a rename)."""
    flat = {
        "accum": state.accum.detach().cpu().numpy().astype(np.float32),
        "sample_count": np.asarray(state.sample_count, np.int32),
        "key_data": state.key_data.cpu().numpy().astype(np.uint32),
    }
    if state.params:
        for k, v in state.params.items():
            flat[f"param.{k}"] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, device="cuda") -> RenderState:
    """A saved state, its tensors on `device` (the card unless the caller
    asks for another)."""
    with np.load(path) as z:
        params = {k[len("param."):]: torch.from_numpy(z[k]).to(device)
                  for k in z.files if k.startswith("param.")}
        return RenderState(
            accum=torch.from_numpy(z["accum"].astype(np.float32)).to(device),
            sample_count=int(z["sample_count"]),
            key_data=torch.from_numpy(z["key_data"].astype(np.int64)).to(device),
            params=params or None)


def render_resumable(scene, camera, cfg, state: RenderState,
                     checkpoint_path: Optional[str] = None, checkpoint_every: int = 16):
    """The progressive render continued from `state`, saving a checkpoint
    every `checkpoint_every` samples; yields the RenderState after each
    sample."""
    from ..models.pathtracer import render_progressive

    w, h = camera.resolution
    key = state_key(state).to(scene.device)
    for i, acc in render_progressive(scene, camera, key, cfg, accum=state.accum,
                                     start_sample=state.sample_count):
        state = RenderState(accum=acc, sample_count=i + 1, key_data=state.key_data,
                            params=state.params)
        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state)
        yield state
