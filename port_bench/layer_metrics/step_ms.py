"""Kernel time a step, from the device trace: the work of one batch on the
card (a forward, or a forward, backward and optimizer update) without the
copies."""


def read(t):
    n, ds = t.items.get("steps"), t.kernel_s()
    return sum(ds) / n * 1e3 if n and ds else None
