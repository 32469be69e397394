"""Tracing: spans and counters at the stage boundaries of a render, and the
profiler's Chrome trace.

Counterpart of `ba_pathtracing_fur_tpu/utils/profiling.py` (its `trace`).
Tracing is on while a `torch.profiler` session records (`trace(logdir)`
opens one, as does any `torch.profiler.profile` a caller opens) and off
otherwise.

  * `trace(logdir)`: a context manager around `torch.profiler.profile` (the
    CPU and, where a card is present, CUDA activities) that writes a Chrome
    trace (`trace_<ms>.json`, viewable in Perfetto or chrome://tracing)
    under `logdir` when it exits;
  * `span(name, pass_index=None, bounce=None)`: a context manager around one
    stage. Off, it costs one boolean read and returns a shared no-op
    context. On, it is a `record_function` named `bapt.<name>`, so the
    stage sits in the Chrome trace on the clock of the device's kernels,
    and it appends one `Span` to the in-memory log: its name, its parent's
    index in the log, the pass index and the bounce (inherited from the
    parent where not given), host start and end (`time.perf_counter_ns`),
    and, once CUDA is initialized, a start and an end
    `torch.cuda.Event(enable_timing=True)` recorded on the current stream,
    from which `Span.device_ms` reads the stage's interval on the device's
    own timeline once the device has passed it;
  * `count(name, value)`: adds `value` (a number or a tensor, summed only
    when `Span.count` reads it, so a count adds no host sync) to the
    innermost open span's counter `name`; `count_nonzero(name, x)` adds the
    number of x's nonzero entries by one reduction on x's device (x may be
    a function that makes the tensor, called only while on). Both do
    nothing while off;
  * `spans()` / `clear()`: the log (at most `MAX_SPANS` records: later
    spans still reach the trace, and `dropped()` counts them) and its reset.

The render's spans (`models/pathtracer`, `ops/traverse`, `ops/cuda`): `pass`
(a progressive pass, with its index), `camera`, `bounce` (with the bounce
and the counters `rays`, `live`: the lanes the closest hit traces with
t_max > 0, and `shadow_live`: the shadow rays with t_max > 0), `sort`,
`hit` (the winner rows' gathers, the t recompute and the Hit assembly),
`nee` (the masked add of the NEE term), `mean`, and around each kernel's
dispatch `k2`, `k3`, `k5`, `shade` (K1) and `k4`. The log and the stack of
open spans are the process's: one render at a time traces into them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: the prefix of every span's name in the profiler's trace
PREFIX = "bapt."
#: the most records the log keeps
MAX_SPANS = 1 << 16

_OFF = contextlib.nullcontext()
_LOG: list = []
_OPEN: list = []  # the open spans, innermost last
_dropped = 0


class Span:
    """One span's record: `parent` is the index of the enclosing span in the
    log (None at the top), `t0`/`t1` the host's perf_counter_ns at entry and
    exit, `events` the (start, end) CUDA events or None, `counts` each
    counter's values."""

    __slots__ = ("name", "parent", "index", "pass_index", "bounce", "t0", "t1", "events",
                 "counts")

    def __init__(self, name: str, parent: Optional[int] = None, pass_index=None, bounce=None,
                 t0: int = 0, t1: int = 0, events=None):
        self.name, self.parent, self.index = name, parent, None
        self.pass_index, self.bounce = pass_index, bounce
        self.t0, self.t1, self.events, self.counts = t0, t1, events, {}

    def host_ms(self) -> float:
        """The host's milliseconds from entry to exit (the stage's enqueue)."""
        return (self.t1 - self.t0) * 1e-6

    def device_ms(self) -> Optional[float]:
        """The device's milliseconds from the start event to the end event
        (None without events): the stage's busy time plus the time the
        device waited on the host inside it. The device must have passed
        the end event (after a sync)."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])

    def count(self, name: str):
        """The sum of counter `name` (None if never counted); a tensor value
        is read here."""
        vals = self.counts.get(name)
        if vals is None:
            return None
        return sum(v.sum().item() if isinstance(v, torch.Tensor) else v for v in vals)


class _Open:
    """The context of a span while tracing is on."""

    __slots__ = ("rec", "rf")

    def __init__(self, name: str, pass_index, bounce):
        parent = _OPEN[-1] if _OPEN else None
        if parent is not None:
            pass_index = parent.pass_index if pass_index is None else pass_index
            bounce = parent.bounce if bounce is None else bounce
        self.rec = Span(name, None if parent is None else parent.index, pass_index, bounce)
        self.rf = _autograd_profiler.record_function(PREFIX + name)

    def __enter__(self):
        global _dropped
        rec = self.rec
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        if len(_LOG) < MAX_SPANS:
            rec.index = len(_LOG)
            _LOG.append(rec)
        else:
            _dropped += 1
        _OPEN.append(rec)
        rec.t0 = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        _OPEN.pop()
        if rec.events is not None:
            rec.events[1].record()
        self.rf.__exit__(*exc)
        return False


def span(name: str, pass_index=None, bounce=None):
    """A span around one stage: a no-op while tracing is off."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, pass_index, bounce)


def count(name: str, value) -> None:
    """Add `value` to the innermost open span's counter `name` (while on)."""
    if _autograd_profiler._is_profiler_enabled and _OPEN:
        _OPEN[-1].counts.setdefault(name, []).append(value)


def count_nonzero(name: str, x) -> None:
    """Add the number of x's nonzero entries to the innermost open span's
    counter `name` (while on): x's L0 norm, one reduction on its device and
    no sync (accumulated in x's float type, so exact below 2^24 entries for
    float32). `x` a tensor, or a function of no arguments that makes it,
    called only while on: a tensor made for the count alone costs nothing
    while off."""
    if _autograd_profiler._is_profiler_enabled and _OPEN:
        x = x() if callable(x) else x
        count(name, torch.linalg.vector_norm(x.detach(), ord=0))


def spans() -> list:
    """The log's records, in the order their spans opened."""
    return list(_LOG)


def dropped() -> int:
    """Spans left out of the log since the last `clear` (it was full)."""
    return _dropped


def clear() -> None:
    """Empty the log."""
    global _dropped
    _LOG.clear()
    _dropped = 0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; its Chrome trace goes to `logdir/trace_<ms>.json`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{int(time.time() * 1e3)}.json"))
