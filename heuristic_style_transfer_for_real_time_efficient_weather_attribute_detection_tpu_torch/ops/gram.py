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


def _accum_dtype(x: torch.Tensor) -> torch.dtype:
    """Gram sums in float32 for float32 and bf16 inputs, float64 for float64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def style_patch_grams(x: torch.Tensor, div: int) -> torch.Tensor:
    """Per-patch Grams with the style-transfer split -> [B, Np, C, C] in the
    accumulation type (float32, float64 for float64 input).

    The reference's style path splits differently from ``split_patches``:
    (1) no padding, the patch is floor(H/div) x floor(W/div) and trailing
    rows and columns are dropped; (2) it regroups the NCHW crop in flat
    row-major order, which scrambles which pixels go to which patch when
    there is more than one patch row.  Both are kept.  K1 computes the
    padded split, so this is a plain product with float32 sums.
    """
    b, h, w, c = x.shape
    ph, pw = h // div, w // div
    if ph == 0 or pw == 0:
        raise ValueError(
            f"style-transfer patch split needs feature map >= patch_div "
            f"(got {h}x{w} features, patch_div={div}); the model's padded "
            f"split handles this, but the reference's unpadded style path "
            f"cannot (utils/PMG/PMG_style_transfer.py:29-32)"
        )
    nh, nw = h // ph, w // pw
    v = x.permute(0, 3, 1, 2)[:, :, : nh * ph, : nw * pw].to(_accum_dtype(x))
    v = v.reshape(b, c, nh * nw, ph * pw)  # the reference's exact regroup
    return torch.einsum("bcpn,bdpn->bpcd", v, v) * (1.0 / float(ph * pw))


def patch_grams(x: torch.Tensor, div: int) -> torch.Tensor:
    """Unflattened per-patch Grams [B, Np, C, C] of the model's padded split,
    in the accumulation type."""
    patches, area = split_patches(x.to(_accum_dtype(x)), div)
    return torch.einsum("bpnc,bpnd->bpcd", patches, patches) * (1.0 / float(area))
