"""pass_enqueue_ms: the host's milliseconds to enqueue one pass, the median
over the traced passes of the port's `pass` span's host duration
(`models/pathtracer.render_progressive`: the sample and the running mean,
with no sync inside; the span closes before the pass is yielded).

`traced_passes` and `median_device_ms` are the readings the port's span
readers share: the port's span log (`ba_pathtracing_fur_torch.utils.
profiling.spans()`, read in the process right after the traced stretch)
cut to the traced stretch's passes, and a stage's device ms a pass.
"""

import statistics


def traced_passes(rec: dict) -> list:
    """The traced stretch's passes -> [(its `pass` span, the spans inside
    it)]: the log's last `units` pass spans, each with the spans after it
    that carry its pass index, up to the next; [] where the port keeps no
    span log (no such module or function), the log holds fewer passes, or
    the run was not traced by passes."""
    n = rec.get("trace", {}).get("units", 0)
    if rec.get("unit") != "pass" or not n:
        return []
    try:
        from ba_pathtracing_fur_torch.utils import profiling
    except ImportError:
        return []
    log = getattr(profiling, "spans", list)()
    heads = [i for i, s in enumerate(log) if s.name == "pass"][-n:]
    if len(heads) < n:
        return []
    ends = heads[1:] + [len(log)]
    return [(log[i], [s for s in log[i + 1:j] if s.pass_index == log[i].pass_index])
            for i, j in zip(heads, ends)]


def median_device_ms(rec: dict, name: str):
    """Per traced pass, the device intervals (start event to end event) of
    its spans `name` summed; the median over the passes. None where a pass
    has no such span, a span has no events (a CPU run), or there are no
    traced passes."""
    per_pass = []
    for _, inner in traced_passes(rec):
        ms = [s.device_ms() for s in inner if s.name == name]
        if not ms or None in ms:
            return None
        per_pass.append(sum(ms))
    return statistics.median(per_pass) if per_pass else None


def read(rec: dict):
    passes = traced_passes(rec)
    if not passes:
        return None
    return statistics.median(head.host_ms() for head, _ in passes)
