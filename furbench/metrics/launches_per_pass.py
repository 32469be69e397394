"""launches_per_pass: the device's kernel launches in the traced passes
over the passes (the profiler's trace)."""


def read(rec: dict):
    tr = rec.get("trace")
    if tr is None or rec.get("unit") != "pass" or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["units"]
