"""Device time of PM's trunk a batch (the program's ``pm.trunk`` span
around ``models/pm.apply``'s convolution trunk: its convolutions, layout
copies, norms and LeakyReLU and the idle between them).  Mean over the last
session of the port's tracer, which is the traced run's profiled pass;
each span's time is a pair of CUDA events on the step's stream.  None
where the program has no such span."""

from importlib import import_module

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"


def read(t):
    try:
        trace = import_module(f"{PORT}.utils.trace")
    except ImportError:
        return None
    return trace.mean_device_ms("pm.trunk")
