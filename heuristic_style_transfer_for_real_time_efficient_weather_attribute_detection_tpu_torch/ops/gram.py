"""Patch-Gram ops, the signature computation of the PMG model family.

Reference semantics:
  1. replicate-pad the feature map on the bottom/right so H, W divide
     ``patch_div``,
  2. split into ``patch_div**2`` disjoint patches, row-major over the patch
     grid, pixels row-major within a patch,
  3. per-patch Gram ``G = P^T P / N`` with N the patch area,
  4. flatten each Gram row-major into a token of size C*C.

Layout is NHWC.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_to_divisible(x: torch.Tensor, div: int) -> torch.Tensor:
    """Replicate-pad bottom/right of NHWC ``x`` so H and W divide ``div``."""
    _, h, w, _ = x.shape
    pad_h = (-h) % div
    pad_w = (-w) % div
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="replicate")
        x = x.permute(0, 2, 3, 1)
    return x


def split_patches(x: torch.Tensor, div: int) -> Tuple[torch.Tensor, int]:
    """Split NHWC ``x`` into disjoint patches -> ([B, Np, N, C], patch_area)."""
    x = pad_to_divisible(x, div)
    b, h, w, c = x.shape
    ph, pw = h // div, w // div
    x = x.reshape(b, div, ph, div, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, div * div, ph * pw, c), ph * pw


def patch_gram_tokens(x: torch.Tensor, div: int) -> torch.Tensor:
    """NHWC feature map -> flattened per-patch Gram tokens [B, Np, C*C].

    A CUDA tensor goes to the ``patch_gram`` kernel, a CPU tensor to its
    plain version (f32 accumulation, f64 when given f64).
    """
    from .cuda_kernels import patch_gram

    return patch_gram(x, div)
