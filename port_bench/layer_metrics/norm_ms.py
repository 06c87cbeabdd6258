"""Device time of the conv trunk's norms and LeakyReLU a batch: the sum of
the program's ``trunk.norm`` spans (one a trunk block, around its norm and
its LeakyReLU) over the number of ``engine.forward`` spans, in the last
session of the port's tracer, which is the traced run's profiled pass;
each span's time is a pair of CUDA events on the step's stream.  None
where the program has either span missing."""

from importlib import import_module

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"


def read(t):
    try:
        trace = import_module(f"{PORT}.utils.trace")
    except ImportError:
        return None
    recs = trace.records()
    norms = [r.device_ms for r in recs if r.name == "trunk.norm" and r.device_ms is not None]
    steps = sum(r.name == "engine.forward" for r in recs)
    return sum(norms) / steps if norms and steps else None
