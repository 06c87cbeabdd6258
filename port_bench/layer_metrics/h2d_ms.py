"""Host-to-device copy time a step, from the device trace (the upload of
each batch's uint8 frames)."""


def read(t):
    n, ds = t.items.get("steps"), t.copies.get("h2d")
    return sum(ds) / n * 1e3 if n and ds else None
