"""Device time of the forward a step, from the program's own spans: the
train step's ``train.forward`` in a train cell, the Engine's
``engine.forward`` (one micro-batch's model step, its kernels and the idle
between them) in an inference cell.  Mean over the last session of the
port's tracer, which is the traced run's profiled pass; each span's time
is a pair of CUDA events on the step's stream.  None where the program has
no tracer."""

from importlib import import_module

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"


def read(t):
    try:
        trace = import_module(f"{PORT}.utils.trace")
    except ImportError:
        return None
    ms = trace.mean_device_ms("train.forward")
    return ms if ms is not None else trace.mean_device_ms("engine.forward")
