"""The host side of a batch step, shared by ``Engine`` and the exported
program's ``ExportedPredictor``: the uint8 wire contract, tail padding, the
``Engine``'s pinned staging ring for uploads, and the asynchronous copy of
results back to the host.  Free of model code, so that a serving process
that loads an artifact imports no model.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import IGNORE_INDEX
from ..utils import trace


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
    """Zero-pad a tail micro-batch (IGNORE-pad its labels) to ``batch_size``
    rows; counts the rows sent (``engine.rows``) and the padding
    (``engine.pad_rows``) for the tracer."""
    n = images.shape[0]
    trace.count("engine.rows", n)
    if n < batch_size:
        trace.count("engine.pad_rows", batch_size - n)
        pad = batch_size - n
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        if labels is not None:
            labels = np.concatenate(
                [labels, np.full((pad, labels.shape[1]), IGNORE_INDEX, labels.dtype)]
            )
    return images, labels


class _Slot:
    """One slot of a :class:`StagingRing`: a pinned host buffer, the device
    buffer it is copied to, and the two events that guard them."""

    __slots__ = ("host", "dev", "copied", "consumed", "held")

    def __init__(self):
        self.host = self.dev = None
        self.copied = torch.cuda.Event()  # on the copy stream: the slot's copy is done
        self.consumed = torch.cuda.Event()  # on the compute stream: its forward is enqueued before
        self.held = False  # staged, and no forward released it yet


class StagingRing:
    """Host arrays to one CUDA device through a ring of two pinned slots, copied
    on a stream of the ring's own, so that one batch's copy runs under the
    forward of the batch before it.

    :meth:`stage` copies the arrays into the next slot's pinned buffer (one
    host memcpy, in place of the one CUDA makes itself from pageable
    memory into pinned staging), enqueues the slot's host-to-device copy on the
    copy stream and makes the current (compute) stream wait for it; it
    returns without waiting for the compute stream.  The caller may
    overwrite its arrays once it returns.  :meth:`release`, called once the
    forward that reads the staged tensors is enqueued, records that on the
    compute stream; the slot's next copy waits for it on the device, and its
    next host memcpy waits for the slot's last copy on the host
    (``engine.stage_wait`` counts the times it had to).  A slot grows to
    the largest staging it has held and never shrinks.  Nothing is cached:
    every call copies every array.  One thread stages and releases at a
    time, as one thread drives an ``Engine``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.slots = [_Slot(), _Slot()]
        self._next = 0

    def stage(self, arrays: Sequence) -> Tuple[torch.Tensor, ...]:
        """Host arrays (numpy or CPU tensors) -> contiguous device tensors
        of the same dtypes, shapes and values, ordered on the current
        stream after their copy."""
        srcs = [torch.as_tensor(a) for a in arrays]
        offs, total = layout(srcs)
        slot = self.slots[self._next]
        self._next = (self._next + 1) % len(self.slots)
        compute = torch.cuda.current_stream(self.device)
        if not slot.copied.query():
            trace.count("engine.stage_wait")
        slot.copied.synchronize()
        if slot.held:  # never released: everything enqueued so far may read it
            slot.consumed.record(compute)
        if slot.host is None or slot.host.numel() < total:
            with torch.inference_mode(False):
                slot.host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
                slot.dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            slot.dev.record_stream(self.stream)
            # the new device block may be memory that compute-stream work
            # enqueued before now still uses
            self.stream.wait_stream(compute)
        with trace.span("engine.stage"):
            for s, o in zip(srcs, offs):
                byte_view(slot.host, o, s).copy_(s)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(slot.consumed)
            slot.dev[:total].copy_(slot.host[:total], non_blocking=True)
            slot.copied.record(self.stream)
        compute.wait_event(slot.copied)
        slot.held = True
        trace.count("engine.staged")
        return tuple(byte_view(slot.dev, o, s) for s, o in zip(srcs, offs))

    def release(self) -> None:
        """The forwards that read every staged, unreleased slot are
        enqueued on the current stream: each slot's next copy waits for
        them."""
        compute = torch.cuda.current_stream(self.device)
        for slot in self.slots:
            if slot.held:
                slot.consumed.record(compute)
                slot.held = False


def layout(arrays: Sequence[torch.Tensor]) -> Tuple[List[int], int]:
    """Each array's byte offset inside one staging buffer, every one
    64-byte aligned (so that a view of any dtype may start there), and the
    buffer's bytes."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.numel() * a.element_size() // 64) * 64
    return offs, total


def byte_view(buf: torch.Tensor, off: int, like: torch.Tensor) -> torch.Tensor:
    """``like``'s dtype and shape over the bytes of ``buf`` from ``off``."""
    n = like.numel() * like.element_size()
    return buf[off:off + n].view(like.dtype).view(like.shape)


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
