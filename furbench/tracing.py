"""Spans and the device trace of a traced run.

The spans are the benchmark's own: `span(name)` around a unit of the window
(a pass or a step), and `program_spans()`, which wraps the calls into the
port's layers that a pass or a step makes (the camera wavefront, a bounce,
the closest and any hits, the ray sort, the streaming traversal, the shade
stage, NEE, compaction, the loss's backward) in `torch.profiler.
record_function`, only while a traced stretch runs. `profiled(fn, n)` runs
`fn` n times under `torch.profiler` and reads back, from its chrome trace,
every device operation and every benchmark span on one clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

#: the prefix of every benchmark span's name in the trace
PREFIX = "furbench."
#: the device operations of a trace (its event categories)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: (module of the port, attribute, span name): the calls `program_spans` wraps
PROGRAM_CALLS = (
    ("models.pathtracer", "camera_wavefront", "camera"),
    ("models.pathtracer", "trace_bounce", "bounce"),
    ("models.pathtracer", "trace_bounce_fused", "bounce"),
    ("ops.traverse", "closest_hit", "closest_hit"),
    ("ops.traverse", "any_hit", "any_hit"),
    ("ops.traverse", "_sorted_rays", "ray_sort"),
    ("ops.cuda.stream", "traverse_stream", "k3"),
    ("ops.cuda.intersect", "closest", "k5"),
    ("ops.cuda.traverse", "traverse", "k2"),
    ("ops.cuda.shade", "shade_bounce", "shade"),
    ("models.shading", "calc_direct_light", "nee"),
    ("models.bsdf", "gather_materials", "materials"),
    ("ops.compact", "compaction_permutation", "compact"),
    ("ops.compact", "gather_fields", "compact"),
)

PACKAGE = "ba_pathtracing_fur_torch"


@contextlib.contextmanager
def span(name: str):
    """A benchmark span named PREFIX + name in the profiler's trace."""
    from torch.profiler import record_function

    with record_function(PREFIX + name):
        yield


def _wrapped(fn, name):
    def call(*a, **k):
        with span(name):
            return fn(*a, **k)
    return call


@contextlib.contextmanager
def program_spans():
    """Wrap PROGRAM_CALLS in spans for the duration."""
    import importlib

    saved = []
    try:
        for mod, attr, name in PROGRAM_CALLS:
            m = importlib.import_module(f"{PACKAGE}.{mod}")
            saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, _wrapped(getattr(m, attr), name))
        yield
    finally:
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)


def read_trace(path: str) -> dict:
    """Device operations and benchmark spans of a chrome trace, in seconds
    on the trace's clock -> {"ops": [(name, start, end)], "spans": [(name,
    start, end)], "kernels": the count of kernel launches}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, spans, kernels = [], [], 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, s = e.get("cat", ""), e["ts"] * 1e-6
        end = s + e.get("dur", 0.0) * 1e-6
        if cat in DEVICE_CATS:
            ops.append((e["name"], s, end))
            kernels += cat == "kernel"
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((e["name"][len(PREFIX):], s, end))
    return dict(ops=ops, spans=spans, kernels=kernels)


def profiled(fn, n: int, unit: str) -> dict:
    """Run `fn` (a unit of the window: it ends in a sync) n times under
    torch.profiler, each in a span named `unit`, with the program's spans on
    -> the trace's ops, spans and kernel count, the window from the first
    unit's start to the last one's end on the trace's clock, the host
    seconds of that stretch, and the units run."""
    from torch.profiler import ProfilerActivity, profile

    with program_spans(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with span(unit):
                fn()
        host_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="furbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = read_trace(path)
    finally:
        os.remove(path)
    units = [(s, e) for name, s, e in tr["spans"] if name == unit]
    if len(units) != n:
        raise RuntimeError(f"the trace holds {len(units)} {unit} spans of {n}")
    tr.update(window=(units[0][0], units[-1][1]), host_s=host_s, units=n)
    return tr
