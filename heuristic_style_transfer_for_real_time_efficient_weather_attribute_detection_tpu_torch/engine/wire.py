"""The host side of a batch step, shared by ``Engine`` and the exported
program's ``ExportedPredictor``: the uint8 wire contract, tail padding, and
the asynchronous copy of results back to the host.  Free of model code, so
that a serving process that loads an artifact imports no model.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import IGNORE_INDEX


def validate_and_pack(images: np.ndarray, pack_k: Optional[int]) -> np.ndarray:
    """The uint8 wire contract: uint8 NHWC, raw [N,H,W,3] or (when the step
    takes the packed format, ``pack_k`` set) already space-to-depth packed
    [N,H/k,W/k,k*k*3].  Nothing is packed on the host: raw frames go to the
    device as they are, and the stem kernel reads them unpacked."""
    if images.ndim != 4:
        raise ValueError(f"expected uint8 NHWC images, got {getattr(images, 'shape', None)}")
    if images.dtype != np.uint8:
        raise ValueError(
            f"expected uint8 images (device-side normalize); got {images.dtype} "
            f"- use ops.preprocess.load_image_uint8"
        )
    if images.shape[-1] == 3:
        return images
    if pack_k is not None and images.shape[-1] == pack_k * pack_k * 3:
        return images
    if pack_k is not None:
        raise ValueError(
            f"packed step expects [N,H/{pack_k},W/{pack_k},{pack_k * pack_k * 3}] "
            f"or raw [N,H,W,3]; got {images.shape}"
        )
    raise ValueError(f"expected uint8 NHWC images [N,H,W,3], got {images.shape}")


def pad_batch(
    images: np.ndarray, batch_size: int, labels: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Zero-pad a tail micro-batch (IGNORE-pad its labels) to ``batch_size`` rows."""
    n = images.shape[0]
    if n < batch_size:
        pad = batch_size - n
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        if labels is not None:
            labels = np.concatenate(
                [labels, np.full((pad, labels.shape[1]), IGNORE_INDEX, labels.dtype)]
            )
    return images, labels


def to_host_async(res: Dict[str, torch.Tensor], keys: Sequence[str]) -> Tuple[Dict, object]:
    """Start copying ``keys`` of ``res`` to pinned host memory on the current
    stream; returns the host tensors and an event that marks the copies done
    (None for results on the CPU, which are returned as they are)."""
    if not any(res[k].is_cuda for k in keys):
        return {k: res[k] for k in keys}, None
    host = {}
    for k in keys:
        host[k] = torch.empty(res[k].shape, dtype=res[k].dtype, pin_memory=True)
        host[k].copy_(res[k], non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def wait_host(host: Dict[str, torch.Tensor], event) -> Dict[str, np.ndarray]:
    """Wait for a :func:`to_host_async` copy -> numpy arrays."""
    if event is not None:
        event.synchronize()
    return {k: v.numpy() for k, v in host.items()}
