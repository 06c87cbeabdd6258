"""K1 (``patch_gram``, the forward's per-patch Gram) against its roofline:
its least time at the cell's shapes over its mean traced time a launch."""


def read(t):
    ds, bound = t.kernel_s("patch_gram_kernel"), t.extra.get("patch_gram_bound_s")
    return bound / (sum(ds) / len(ds)) * 100.0 if ds and bound else None
