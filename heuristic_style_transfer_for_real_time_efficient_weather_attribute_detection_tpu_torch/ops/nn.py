"""Basic functional NN ops: conv, linear, leaky ReLU, SE channel attention.

Layout at the boundary is the JAX package's: NHWC activations, HWIO conv
kernels, ``[in, out]`` linear weights.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .preprocess import s2d_pack


def conv2d(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC, symmetric integer padding.

    A non-overlapping convolution (kernel == stride, pad 0; a 1x1 conv is
    the k = 1 case) is a space-to-depth reshape and one matmul over the
    packed channels, in NHWC as it stands; others go to ``F.conv2d``.
    """
    kh, kw, cin, cout = p["w"].shape
    if kh == kw == stride and padding == 0:
        y = torch.matmul(s2d_pack(x, kh), p["w"].reshape(kh * kw * cin, cout))
        return y if p.get("b") is None else y + p["b"]
    y = F.conv2d(
        x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), p.get("b"),
        stride=stride, padding=padding,
    )
    return y.permute(0, 2, 3, 1)


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: [..., in] @ w[in, out] + b[out]."""
    y = torch.matmul(x, p["w"])
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def se_block(x: torch.Tensor, p: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Squeeze-and-Excitation channel attention, NHWC:
    ``x * sigmoid(fc2(relu(fc1(mean_hw(x)))))``."""
    s = x.mean(dim=(1, 2))
    s = torch.relu(linear(s, p["fc1"]))
    s = torch.sigmoid(linear(s, p["fc2"]))
    return x * s[:, None, None, :]
