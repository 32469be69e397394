"""Timing and render progress: the Clock / GPU_Clock / ETA counterparts.

Counterpart of `ba_pathtracing_fur_tpu/utils/clock.py` (KIRK::Clock,
Clock.h:48-60, and the per-sample %/ETA logging of CPU_PathTracer.cpp:
28-41). Work on the card is asynchronous, so `DeviceClock` and
`RenderProgress` wait for the card (`torch.cuda.synchronize`) before they
read the stopwatch whenever they are handed a tensor that lies on it.
"""

from __future__ import annotations

import time

import torch

from . import log


def sync(value) -> None:
    """Wait until the card has finished the work behind `value`, when it is
    a tensor on a CUDA device; nothing otherwise."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


class Clock:
    """Clock<chrono>: construct to start, `.elapsed()` / `.restart()`."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def restart(self) -> float:
        dt = self.elapsed()
        self._t0 = time.perf_counter()
        return dt


class DeviceClock(Clock):
    """GPU_Clock: waits for `value` before reading the stopwatch."""

    def stop(self, value=None) -> float:
        if value is not None:
            sync(value)
        return self.elapsed()


class RenderProgress:
    """Per-sample progress %/ETA logging (CPU_PathTracer.cpp:28-41) with a
    rays/s counter."""

    def __init__(self, total_samples: int, rays_per_sample: int, log_every: int = 1):
        self.total = total_samples
        self.rays = rays_per_sample
        self.log_every = log_every
        self.clock = Clock()
        self.done = 0

    def update(self, n: int = 1, value=None) -> None:
        if value is not None:
            sync(value)
        self.done += n
        if self.done % self.log_every:
            return
        el = self.clock.elapsed()
        frac = self.done / self.total
        eta = el / frac - el if frac > 0 else float("inf")
        rps = self.done * self.rays / max(el, 1e-9)
        log.log_info("render %/% samples (% pct)  % s elapsed, ETA % s, % Mrays/s",
                     self.done, self.total, round(100 * frac, 1), round(el, 1),
                     round(eta, 1), round(rps / 1e6, 2))
