"""Training augmentation on the device, inside the train step.

Counterpart of the JAX package's ``ops/augment.py``: random flip,
edge-padded translation, contrast about the image mean and brightness, on
the normalized float NHWC batch the train step receives (amplitudes are in
normalized units).  The random draws come from a ``torch.Generator`` on the
batch's device, which the train step reseeds from ``(seed, step)``, so a
resumed run replays the straight run's augmentations.  The generator's
numbers are not ``jax.random``'s: the two packages draw different
augmentations from the same seed.
"""

from __future__ import annotations

import torch

# fit()/CLI recipe for ``--augment``/``augment=True``: flip, up to 8 px of
# translation and mild photometric jitter.  The ``augment_batch`` defaults
# are all off, so a partial kwargs dict turns on exactly the knobs it names.
DEFAULT_AUGMENT = {
    "flip": True,
    "translate": 8,
    "brightness": 0.1,
    "contrast": 0.1,
}


def augment_batch(
    generator: torch.Generator,
    images: torch.Tensor,
    *,
    flip: bool = False,
    translate: int = 0,
    brightness: float = 0.0,
    contrast: float = 0.0,
    shard=None,
) -> torch.Tensor:
    """Randomly augment a normalized NHWC float batch, keeping its shape and
    dtype.

    - ``flip``: horizontal flip with p = 0.5 per image.
    - ``translate``: a uniform shift in [-translate, translate] pixels on
      both axes, the image edge-padded (a crop of the edge-padded image is
      a gather with clamped indices).
    - ``contrast``: a per-image scale in [1-c, 1+c] about the image mean.
    - ``brightness``: a per-image offset in [-b, b].

    Every knob defaults to off.  The four draws are made in a fixed order
    whatever knobs are on, so each knob's draws do not depend on the others.
    Deterministic per generator state.  With a ``shard``
    (``parallel.mesh.RowShard``: the images are rows of a global batch)
    every draw is made for the global batch and the images take their own
    rows of it, so a sharded step augments as the unsharded step does.
    """
    b, h, w, _ = images.shape
    dev = images.device
    n = b if shard is None else shard.total

    def mine(draws):
        return draws if shard is None else shard.rows(draws, b)

    do_flip = mine(torch.rand(n, generator=generator, device=dev)) < 0.5
    pad = int(translate)
    off = mine(torch.randint(0, 2 * pad + 1, (n, 2), generator=generator, device=dev))
    u_contrast = mine(torch.rand((n, 1, 1, 1), generator=generator, device=dev))
    u_bright = mine(torch.rand((n, 1, 1, 1), generator=generator, device=dev))
    if flip:
        images = torch.where(do_flip[:, None, None, None], images.flip(2), images)
    if pad:
        rows = (torch.arange(h, device=dev) + off[:, :1] - pad).clamp(0, h - 1)
        cols = (torch.arange(w, device=dev) + off[:, 1:] - pad).clamp(0, w - 1)
        images = images[torch.arange(b, device=dev)[:, None, None], rows[:, :, None],
                        cols[:, None, :]]
    if contrast:
        scale = (1.0 - contrast + 2.0 * contrast * u_contrast).to(images.dtype)
        mean = images.mean(dim=(1, 2, 3), keepdim=True)
        images = (images - mean) * scale + mean
    if brightness:
        images = images + (-brightness + 2.0 * brightness * u_bright).to(images.dtype)
    return images
