"""Device time of the train step's backward a step (the program's
``train.backward`` span around ``loss.backward()``).  Mean over the last
session of the port's tracer, which is the traced run's profiled pass;
each span's time is a pair of CUDA events on the step's stream.  None
where the program has no tracer."""

from importlib import import_module

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"


def read(t):
    try:
        trace = import_module(f"{PORT}.utils.trace")
    except ImportError:
        return None
    return trace.mean_device_ms("train.backward")
