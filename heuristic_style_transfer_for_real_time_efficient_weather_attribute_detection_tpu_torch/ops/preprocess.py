"""Image preprocessing: host decode/resize, device normalize.

The host side reproduces the reference transform (Resize(256, bilinear) ->
CenterCrop(224)) with PIL.  Images cross to the device as uint8 and are
normalized there, either by ``normalize_uint8`` or folded into the stem
kernel's weights (``packed_affine``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from PIL import Image

from ..config import DEFAULT_IMG_SIZE, DEFAULT_RESIZE, IMAGENET_MEAN, IMAGENET_STD

VALID_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}
_IMAGE_SUFFIXES = tuple(sorted(VALID_EXTS))

_SCALE = (1.0 / (255.0 * np.asarray(IMAGENET_STD, np.float32))).astype(np.float32)
_SHIFT = (
    np.asarray(IMAGENET_MEAN, np.float32) / np.asarray(IMAGENET_STD, np.float32)
).astype(np.float32)


def is_image_name(fn: str) -> bool:
    """Name-suffix image filter (``fn.lower().endswith(...)``): a dotfile
    named exactly ".jpg" counts as an image, unlike the splitext test of
    ``data.collect_image_paths``."""
    return fn.lower().endswith(_IMAGE_SUFFIXES)


def resize_shorter(img: Image.Image, size: int = DEFAULT_RESIZE) -> Image.Image:
    """Resize so the shorter side equals ``size`` (aspect kept, bilinear),
    with torchvision ``Resize(int)`` rounding."""
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        new_w = size
        new_h = int(round(size * h / w))
    else:
        new_h = size
        new_w = int(round(size * w / h))
    return img.resize((new_w, new_h), Image.BILINEAR)


def center_crop(img: Image.Image, size: int = DEFAULT_IMG_SIZE) -> Image.Image:
    """Center crop (torchvision ``CenterCrop`` rounding)."""
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def load_image_uint8(
    path_or_img, img_size: int = DEFAULT_IMG_SIZE, resize: int = DEFAULT_RESIZE
) -> np.ndarray:
    """Decode + resize + crop -> HWC uint8 (normalization happens on device)."""
    img = (
        path_or_img
        if isinstance(path_or_img, Image.Image)
        else Image.open(path_or_img)
    )
    img = img.convert("RGB")
    img = center_crop(resize_shorter(img, resize), img_size)
    return np.asarray(img, dtype=np.uint8)


def load_image_normalized(path_or_img, img_size: int = DEFAULT_IMG_SIZE) -> np.ndarray:
    """The whole reference transform on the host -> HWC float32 (parity path)."""
    arr = load_image_uint8(path_or_img, img_size).astype(np.float32) / 255.0
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (arr - mean) / std


def normalize_uint8_host(x: np.ndarray) -> np.ndarray:
    """numpy twin of ``normalize_uint8``: the same folded affine, float32."""
    return x.astype(np.float32) * _SCALE - _SHIFT


def normalize_uint8(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC [0,255] -> ImageNet-normalized NHWC of ``dtype``, on x's
    device, as one multiply-add ``x * (1/(255*std)) - mean/std`` whose
    constants are rounded to ``dtype`` too (bf16 runs it in bf16, as the
    JAX package does)."""
    scale, shift = _device_affine(x.device, 1, dtype)
    return x.to(dtype) * scale - shift


def packed_affine(k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(scale, shift) of the uint8 normalize ``x*scale - shift``, tiled
    ``k*k`` times to match the ``s2d_pack`` channel order (dy, dx, c)."""
    return np.tile(_SCALE, k * k), np.tile(_SHIFT, k * k)


@functools.lru_cache(maxsize=None)
def _device_affine(
    device: torch.device, k: int, dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``packed_affine(k)`` as ``dtype`` on ``device``, uploaded once: a
    pageable upload per call would synchronize the stream on every frame."""
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a).to(device, dtype) for a in packed_affine(k))


def normalize_uint8_packed(
    z8: torch.Tensor, k: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Normalize for ``s2d_pack`` output [B, H/k, W/k, k*k*3] uint8: the
    per-RGB affine tiled k*k times over the packed channels, on z8's device,
    in ``dtype`` with its constants rounded to ``dtype`` (as
    :func:`normalize_uint8`)."""
    scale, shift = _device_affine(z8.device, k, dtype)
    return z8.to(dtype) * scale - shift


def s2d_pack(x: torch.Tensor, k: int) -> torch.Tensor:
    """Space-to-depth: NHWC -> [B, H/k, W/k, k*k*C], channel order (dy, dx, c).

    Trailing rows/columns beyond a multiple of ``k`` are cropped, as a
    stride-k pad-0 convolution ignores them.
    """
    b, h, w, c = x.shape
    hp, wp = h // k, w // k
    x = x[:, : hp * k, : wp * k]
    return (
        x.reshape(b, hp, k, wp, k, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, hp, wp, k * k * c)
    )


def s2d_unpack(z: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of ``s2d_pack``: [B, Hp, Wp, k*k*C] -> contiguous NHWC."""
    b, hp, wp, cc = z.shape
    c = cc // (k * k)
    return (
        z.reshape(b, hp, wp, k, k, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, hp * k, wp * k, c)
        .contiguous()
    )


def s2d_pack_uint8(u8: np.ndarray, k: int) -> np.ndarray:
    """Host space-to-depth pack, uint8 NHWC -> [B, H/k, W/k, k*k*C] (the
    JAX package's PMG wire format; trailing rows and columns beyond a
    multiple of ``k`` are cropped)."""
    b, h, w, c = u8.shape
    hp, wp = h // k, w // k
    u8 = u8[:, : hp * k, : wp * k]
    return np.ascontiguousarray(
        u8.reshape(b, hp, k, wp, k, c).transpose(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, k * k * c)
    )


def s2d_unpack_uint8(z8: np.ndarray, k: int) -> np.ndarray:
    """Inverse of ``s2d_pack_uint8``: [B, Hp, Wp, k*k*C] -> uint8 NHWC."""
    b, hp, wp, cc = z8.shape
    c = cc // (k * k)
    return np.ascontiguousarray(
        z8.reshape(b, hp, wp, k, k, c).transpose(0, 1, 3, 2, 4, 5).reshape(b, hp * k, wp * k, c)
    )


def _mean_std(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device),
            torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device))


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """Normalized float NHWC -> [0,1] float NHWC (for overlays and exports)."""
    mean, std = _mean_std(x)
    return torch.clamp(x * std + mean, 0.0, 1.0)


def normalize01(x: torch.Tensor) -> torch.Tensor:
    """[0,1] float NHWC -> ImageNet-normalized (the style-transfer pixel path)."""
    mean, std = _mean_std(x)
    return (x - mean) / std
