"""idle_share.render: the share of the traced passes' wall time in which no
operation ran on the device, 100% x (1 - the union of the device's operation
intervals / the window), from the profiler's trace."""

from furbench import stats


def read(rec: dict):
    tr = rec.get("trace")
    if tr is None or rec.get("unit") != "pass" or not tr["ops"]:
        return None
    return stats.idle_share([(s, e) for _, s, e in tr["ops"]], tr["window"])
