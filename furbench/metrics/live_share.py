"""live_share: the share of the wavefront's lanes that a bounce still
traces, 100% x the sum of the port's `live` counters (the lanes whose
closest-hit t_max > 0, `models/pathtracer._trace_cap`) over the sum of its
`rays` counters (the wavefront's lanes), over every `bounce` span of the
traced passes. None where no bounce span carries both counters or the port
keeps no span log."""

from furbench.metrics.pass_enqueue_ms import traced_passes


def read(rec: dict):
    live = rays = 0
    for _, inner in traced_passes(rec):
        for s in inner:
            if s.name == "bounce" and s.count("live") is not None and s.count("rays"):
                live += s.count("live")
                rays += s.count("rays")
    return 100.0 * live / rays if rays else None
