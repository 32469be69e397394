"""whitted_lobe_ms: the Whitted fur shader's TT and TRT traces on the
device: the device intervals (start event to end event) of the port's
`lobes` spans (`models/whitted._hair_color`: the second wall and the re-hit
traced from inside the fibers) summed over the first traced render. None
where the port keeps no span log or no `lobes` span, or the spans carry no
events (a CPU run)."""

from furbench.metrics.whitted_shadow_ms import first_render_device_ms


def read(rec: dict):
    return first_render_device_ms(rec, "lobes")
