"""Profiling hooks: torch.profiler traces and phase wall timers.

Counterpart of `ba_pathtracing_fur_tpu/utils/profiling.py`:

  * `trace(logdir)`: a context manager around `torch.profiler.profile` (the
    CPU and, where a card is present, CUDA activities) that writes a Chrome
    trace (`trace_<ms>.json`, viewable in Perfetto or chrome://tracing)
    under `logdir` when it exits;
  * `annotate(name)`: `torch.profiler.record_function`, a named span in the
    trace;
  * `profile_call(fn, *args, logdir=...)`: one traced call (after a warm-up
    call unless warm=False), the device synchronized where the JAX package
    calls `block_until_ready` -> {wall_s, logdir, files};
  * `phase_timer(stats, name)`: the wall seconds of a block into
    `stats[name]`.
"""

from __future__ import annotations

import contextlib
import os
import time


def _sync() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; its Chrome trace goes to `logdir/trace_<ms>.json`."""
    from torch.profiler import ProfilerActivity, profile
    import torch

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{int(time.time() * 1e3)}.json"))


def annotate(name: str):
    """A named span inside a profiler trace (a no-op cost outside one)."""
    from torch.profiler import record_function

    return record_function(name)


def profile_call(fn, *args, logdir: str = "out/profile", warm: bool = True) -> dict:
    """Run `fn(*args)` once under `trace(logdir)` (after one untraced call
    when `warm`, so first-use builds stay out of the trace), synchronizing
    the device before the clock stops -> {wall_s, logdir, files}: the files
    under `logdir` with their sizes."""
    if warm:
        fn(*args)
        _sync()
    t0 = time.perf_counter()
    with trace(logdir):
        fn(*args)
        _sync()
    wall = time.perf_counter() - t0
    files = []
    for root, _, names in os.walk(logdir):
        for n in names:
            p = os.path.join(root, n)
            files.append({"file": os.path.relpath(p, logdir), "bytes": os.path.getsize(p)})
    return {"wall_s": round(wall, 4), "logdir": logdir, "files": files}


@contextlib.contextmanager
def phase_timer(stats: dict, name: str):
    """Wall-clock a block into `stats[name]` (the Clock.h analog)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats[name] = round(time.perf_counter() - t0, 4)
