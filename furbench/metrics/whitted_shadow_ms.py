"""whitted_shadow_ms: the Whitted render's hard shadows on the device: the
device intervals (start event to end event) of the port's `light` spans
(`models/whitted.light_shading`: the lights' terms and their shadow rays'
any-hit traversals, the misses' junk rays among them) summed over the first
traced render. None where the port keeps no span log or no `light` span
(a port without the Whitted spans), or the spans carry no events (a CPU
run).

`traced_renders` and `first_render_device_ms` are the readings the Whitted
span readers share: the port's span log (`ba_pathtracing_fur_torch.utils.
profiling.spans()`, read in the process right after the traced stretch)
cut to the traced stretch's renders, and a stage's device ms in the first.
"""


def traced_renders(rec: dict) -> list:
    """The traced stretch's renders -> [(its `whitted` span, the spans after
    it up to the next)]: the log's last `units` whitted spans; [] where the
    port keeps no span log (no such module or function), the log holds
    fewer renders, or the run was not traced by renders."""
    n = rec.get("trace", {}).get("units", 0)
    if rec.get("unit") != "render" or not n:
        return []
    try:
        from ba_pathtracing_fur_torch.utils import profiling
    except ImportError:
        return []
    log = getattr(profiling, "spans", list)()
    heads = [i for i, s in enumerate(log) if s.name == "whitted"][-n:]
    if len(heads) < n:
        return []
    ends = heads[1:] + [len(log)]
    return [(log[i], log[i + 1:j]) for i, j in zip(heads, ends)]


def first_render_device_ms(rec: dict, name: str):
    """The device intervals of the first traced render's spans `name`,
    summed. None where there are no traced renders, no such span, or a span
    has no events."""
    renders = traced_renders(rec)
    if not renders:
        return None
    ms = [s.device_ms() for s in renders[0][1] if s.name == name]
    if not ms or None in ms:
        return None
    return sum(ms)


def read(rec: dict):
    return first_render_device_ms(rec, "light")
