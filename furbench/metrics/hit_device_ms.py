"""hit_device_ms: the Hit assembly's milliseconds on the device a pass: per
traced pass, the device intervals (start event to end event) of the port's
`hit` spans (`ops/traverse._hit_of_rows`: the winner rows' gathers, the t
recompute and `_assemble_hit`) summed over its bounces; the median over the
passes. An interval is the stage's busy time plus the time the device
waited on the host inside it. None where the spans carry no device events
(a CPU run) or the port keeps no span log."""

from furbench.metrics.pass_enqueue_ms import median_device_ms


def read(rec: dict):
    return median_device_ms(rec, "hit")
