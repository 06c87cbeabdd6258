"""Share of the traced window in which no kernel, copy or set ran on the
device."""


def read(t):
    return (1.0 - t.busy_s / t.window_s) * 100.0 if t.busy_s > 0 and t.window_s > 0 else None
