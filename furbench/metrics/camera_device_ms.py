"""camera_device_ms: the camera wavefront's milliseconds on the device a
pass: the device interval (start event to end event) of the port's `camera`
span (`models/pathtracer.camera_wavefront`: the pixels' threefry keys and
jitter, `core/rng`, and the rays, `core/camera`) in each traced pass; the
median over the passes. None where the spans carry no device events (a CPU
run) or the port keeps no span log."""

from furbench.metrics.pass_enqueue_ms import median_device_ms


def read(rec: dict):
    return median_device_ms(rec, "camera")
