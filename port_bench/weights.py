"""The weights a run hands to both sides, in the reference toolkit's state
dict schema: loaded from the checkpoint the configuration names, or drawn
from ``--seed`` on the device in one call."""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch

from .yardstick import stream_seed


def _init(key: str, shape: Tuple[int, ...], z: torch.Tensor) -> torch.Tensor:
    """One tensor from standard normal draws ``z``: He-normal convolutions
    (the last convolution of a residual branch at a fifth of it, so that
    the residual stream stays near unit scale), Linear weights at
    1/sqrt(fan_in), norm scales near 1, biases and running means near 0,
    running variances just above 1, queries standard normal."""
    if key.endswith("running_var"):
        return 1.0 + 0.1 * z.abs()
    if key.endswith(("running_mean", "bias")):
        return 0.1 * z
    if key.endswith(".q") or ".query." in key:
        return z
    if len(shape) == 4:
        std = math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
        return z * std * (0.2 if key.endswith("conv3.weight") else 1.0)
    if len(shape) == 2:
        return z / math.sqrt(shape[1])
    return 1.0 + 0.1 * z


def seeded(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict with ``shapes``, drawn on ``device`` from one
    generator seeded by the run's seed, in one normal draw."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "weights"))
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        out[key] = _init(key, shape, z[at:at + n].view(shape))
        at += n
    return out


def state(cfg: dict, root: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's float32 state dict on ``device``:
    ``cfg["weights"]["file"]`` (relative to the checkout) or ``seeded``."""
    from importlib import import_module

    w = cfg["weights"]
    if "file" in w:
        sd = torch.load(os.path.join(root, w["file"]), map_location="cpu", weights_only=True)
        return {k: v.to(device, torch.float32) for k, v in sd.items() if v.is_floating_point()}
    ref = import_module(f"{__package__}.reference.{cfg['family']}")
    return seeded(ref.state_shapes(cfg), seed, device)
