"""The benchmark's arithmetic on what a run recorded: rates, percentiles,
spreads, and the device's busy time and idle gaps from a profiler trace.

Pure Python: nothing here touches the device, so the tests check it on
synthetic pass times and synthetic traces.
"""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """Work over the window's seconds (`chip_smoke.phase_timing`'s
    W*H*spp*depth / wall, over a whole window)."""
    if seconds <= 0.0:
        raise ValueError("a window of no time")
    return work / seconds


def p90(values) -> float:
    """The 90th percentile of all values (`statistics.quantiles`, inclusive
    method: no extrapolation past the largest value; one value is its own)."""
    values = list(values)
    if not values:
        raise ValueError("a percentile of no values")
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (`statistics.quantiles(values, n=4)`, its default method)."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2


def merge_intervals(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_time(intervals, window) -> float:
    """The time within `window` (start, end) that the union of the device's
    operation intervals covers."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for s, e in intervals if e > w0 and s < w1]
    return sum(e - s for s, e in merge_intervals(clipped))


def idle_share(intervals, window) -> float:
    """100% x (1 - busy / window)."""
    return 100.0 * (1.0 - busy_time(intervals, window) / (window[1] - window[0]))


def idle_gaps(intervals, window):
    """The gaps of the window that no device operation covers -> [(start,
    end)]."""
    w0, w1 = window
    gaps, t = [], w0
    for s, e in merge_intervals((max(s, w0), min(e, w1)) for s, e in intervals
                                if e > w0 and s < w1):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def innermost_span(spans, t: float):
    """The name of the innermost span (name, start, end) that holds time t:
    the latest started of those that hold it; "outside spans" when none."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s, e)
    return best[0] if best else "outside spans"


def gaps_by_span(intervals, window, spans, top: int = 10):
    """The idle gaps' seconds summed by the innermost span the host was in at
    each gap's start, largest first -> [[name, seconds]] (at most `top`)."""
    total: dict = {}
    for s, e in idle_gaps(intervals, window):
        name = innermost_span(spans, s)
        total[name] = total.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without its leading "void " and its
    argument list, cut to `width` characters."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:width]


def ops_by_name(ops, top: int = 10):
    """Device seconds summed by operation (`short_name`), largest first ->
    [[name, seconds]] (at most `top`)."""
    total: dict = {}
    for name, s, e in ops:
        name = short_name(name)
        total[name] = total.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
