"""The whole step's share of the chip's peak: the model FLOPs of the
traced work (counted from shapes in ``port_bench/families``) over the
traced window, against the published H100 peak of the run's precision."""


def read(t):
    if t.busy_s <= 0 or t.window_s <= 0 or not t.flops or not t.peak_flop_per_s:
        return None
    return t.flops / t.window_s / t.peak_flop_per_s * 100.0
