"""Batch execution engine of the port.

One engine serves every batch workload: ``run(images_uint8)`` takes uint8
NHWC frames (any N), pads the tail batch to the engine's batch size, runs
the forward on the device, and returns host numpy probs / preds / logits.
Images cross to the device as uint8 and are normalized there (folded into
the stem kernel on the PMG path).  ``dtype=torch.bfloat16`` runs the
forward in bf16 on a cast copy of the params, as the JAX package's
``Engine(dtype=jnp.bfloat16)`` does.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import IGNORE_INDEX, UNKNOWN_PRED, TaskSpec
from ..models import get_family
from ..ops.nn import cast_tree
from ..ops.preprocess import normalize_uint8
from .checkpoint import to_device

_UNBATCHED = ("loss_per_task", "count_per_task")


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


def class_mask(tasks: TaskSpec) -> np.ndarray:
    """[T, Kmax] bool: True where a class slot is real for the task."""
    m = np.zeros((len(tasks), tasks.max_classes), bool)
    for i, k in enumerate(tasks.num_classes):
        m[i, :k] = True
    return m


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over each task's real classes; padded slots get probability 0.
    logits: [..., T, Kmax]; mask: [T, Kmax] bool."""
    neg = torch.finfo(logits.dtype).min
    p = torch.softmax(torch.where(mask, logits, neg), dim=-1)
    return torch.where(mask, p, 0.0)


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-task mean CE over samples whose label != IGNORE_INDEX.

    logits: [B, T, Kmax]; labels: [B, T] int.  Returns (per-task loss [T],
    per-task count [T]).
    """
    neg = torch.finfo(torch.float32).min
    logp = torch.log_softmax(torch.where(mask, logits.float(), neg), dim=-1)
    valid = labels != IGNORE_INDEX
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    count = valid.sum(dim=0)
    return nll.sum(dim=0) / count.clamp(min=1), count


class Engine:
    """Multi-task vision engine for one (family, spec, params) on one device.

    ``run(images_uint8)`` returns probs / preds / logits for N images as
    host numpy, padding N up to ``batch_size`` internally.  ``device``
    defaults to the CUDA card and raises when there is none; pass
    ``device="cpu"`` to run the plain versions of the kernels.

    ``dtype`` is float32 or bfloat16.  ``params`` stays float32 as given;
    the forward runs on a copy cast to ``dtype`` (every floating leaf),
    which assigning ``params`` derives anew, with the stem fold.  Logits
    are cast to float32 before the masked softmax; captured taps come back
    as float32 (host numpy has no bf16).
    """

    def __init__(
        self,
        family: str,
        spec,
        params,
        *,
        batch_size: int = 32,
        prob_threshold: float = 0.5,
        dtype: torch.dtype = torch.float32,
        capture: Sequence[str] = (),
        mesh=None,
        packed: str = "auto",
        device="cuda",
    ):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"Engine dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        if mesh is not None:
            raise NotImplementedError("mesh execution is not ported yet (ROADMAP.md A22)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine: no CUDA device is available; pass device='cpu' to run "
                "the plain versions on the CPU"
            )
        self.family = family
        self.spec = spec
        self.tasks: TaskSpec = spec.tasks
        self.batch_size = batch_size
        self.prob_threshold = float(prob_threshold)
        self.dtype = dtype
        self.capture = tuple(capture)
        self._mod = get_family(family)
        self._mask = torch.as_tensor(class_mask(self.tasks), device=self.device)
        self.pack_k = None
        if packed != "off" and family == "pmg" and self._mod.supports_packed_input(spec):
            self.pack_k = spec.plan[0].kernel
        self.params = params  # the setter derives the run copy and the stem fold

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, p) -> None:
        self._params = to_device(p, self.device)
        self._run_params = (self._params if self.dtype == torch.float32
                            else cast_tree(self._params, self.dtype))
        # the stem fold is constant per params: folded once, not per batch
        self._stem = (self._mod.fold_stem(self._run_params, self.spec, self.dtype)
                      if self.pack_k else None)

    # -- low-level -------------------------------------------------------

    @torch.inference_mode()
    def _step(self, images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.pack_k is not None:
            logits, aux = self._mod.apply_packed(
                self._run_params, images, self.spec, self.capture, self._stem, self.dtype
            )
        else:
            logits, aux = self._mod.apply(
                self._run_params, normalize_uint8(images, self.dtype), self.spec, self.capture
            )
        logits = logits.float()
        probs = masked_softmax(logits, self._mask)
        maxp = probs.amax(dim=-1)
        preds = probs.argmax(dim=-1).int()
        preds = torch.where(maxp < self.prob_threshold, UNKNOWN_PRED, preds)
        loss_t, count_t = masked_cross_entropy(logits, labels, self._mask)
        out = {
            "logits": logits,
            "probs": probs,
            "max_probs": maxp,
            "preds": preds,
            "loss_per_task": loss_t,
            "count_per_task": count_t,
        }
        out.update({k: v.float() for k, v in aux.items()})
        return out

    def step(self, images, labels: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """One forward on exactly one batch of uint8 images (numpy or a
        tensor); results stay on the device."""
        x = torch.as_tensor(images).to(self.device, non_blocking=True)
        if labels is None:
            y = torch.full((x.shape[0], len(self.tasks)), IGNORE_INDEX, dtype=torch.int32,
                           device=self.device)
        else:
            y = torch.as_tensor(labels).to(self.device, non_blocking=True)
        return self._step(x, y)

    def warmup(self, img_size: int = 224) -> None:
        z = np.zeros((self.batch_size, img_size, img_size, 3), np.uint8)
        self.step(z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- pipelined micro-batch API (serving) -----------------------------

    def _to_host_async(self, res: Dict[str, torch.Tensor], keys) -> Tuple[Dict, object]:
        """Start copying ``keys`` of ``res`` to the host; returns the host
        tensors and an event that marks the copies done (None on the CPU)."""
        if self.device.type != "cuda":
            return {k: res[k] for k in keys}, None
        host = {}
        for k in keys:
            host[k] = torch.empty(res[k].shape, dtype=res[k].dtype, pin_memory=True)
            host[k].copy_(res[k], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _wait_host(host: Dict[str, torch.Tensor], event) -> Dict[str, np.ndarray]:
        if event is not None:
            event.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def dispatch(
        self,
        images: np.ndarray,
        labels: Optional[np.ndarray] = None,
        collect: Sequence[str] = ("probs", "preds"),
    ):
        """Enqueue one micro-batch (<= batch_size uint8 frames, raw or
        packed) and start copying its results to the host; returns a handle
        for :meth:`fetch`."""
        images = validate_and_pack(images, self.pack_k)
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(f"micro-batch {n} > engine batch {self.batch_size}")
        has_labels = labels is not None
        images, labels = pad_batch(images, self.batch_size, labels)
        res = self.step(images, labels)
        keys = set(collect) | (set(_UNBATCHED) if has_labels else set())
        return (n,) + self._to_host_async(res, keys)

    def fetch(self, handle) -> Dict[str, np.ndarray]:
        """Wait for a :meth:`dispatch` handle -> host arrays [n, ...]
        (per-task aggregates stay unsliced)."""
        take, host, event = handle
        out = self._wait_host(host, event)
        return {k: (v if k in _UNBATCHED else v[:take]) for k, v in out.items()}

    # -- high-level ------------------------------------------------------

    def run(
        self,
        images: np.ndarray,
        labels: Optional[np.ndarray] = None,
        collect: Sequence[str] = ("probs", "preds"),
        measure_time: bool = False,
        scan_chunk: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Forward N images (any N) -> host dict of stacked arrays [N, ...].

        Up to 4 batches stay in flight: each batch's results start copying
        to the host as soon as its forward is enqueued, and the oldest is
        drained only then.  ``measure_time`` returns per-batch wall times
        under "times" (it synchronizes every batch).  ``scan_chunk`` is
        accepted for interface parity and ignored: results are the same.
        """
        del scan_chunk
        images = validate_and_pack(images, self.pack_k)
        n = images.shape[0]
        bs = self.batch_size
        outs: Dict[str, List[np.ndarray]] = {k: [] for k in collect}
        loss_sums = np.zeros(len(self.tasks), np.float64)
        counts = np.zeros(len(self.tasks), np.int64)
        times: List[float] = []
        keys = set(collect) | (set(_UNBATCHED) if labels is not None else set())
        inflight: List[Tuple[int, Dict, object]] = []

        def _drain_one() -> None:
            take, host, event = inflight.pop(0)
            out = self._wait_host(host, event)
            for k in collect:
                outs[k].append(out[k][:take])
            if labels is not None:
                cnt = out["count_per_task"].astype(np.int64)
                np.add(loss_sums, out["loss_per_task"] * cnt, out=loss_sums)
                np.add(counts, cnt, out=counts)

        for s in range(0, n, bs):
            e = min(s + bs, n)
            chunk, lab = pad_batch(images[s:e], bs, labels[s:e] if labels is not None else None)
            t0 = time.perf_counter()
            res = self.step(chunk, lab)
            host, event = self._to_host_async(res, keys)
            if measure_time:
                if event is not None:
                    event.synchronize()
                times.append(time.perf_counter() - t0)
            inflight.append((e - s, host, event))
            if len(inflight) >= 4:
                _drain_one()
        while inflight:
            _drain_one()
        result = {k: np.concatenate(v, axis=0) for k, v in outs.items() if v}
        if labels is not None:
            result["loss_per_task"] = loss_sums / np.maximum(counts, 1)
            result["count_per_task"] = counts
        if measure_time:
            result["times"] = np.asarray(times)
        return result

    def predict_dict(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """{task: probs [N, K_t]}, the reference's per-task dict contract."""
        probs = self.run(images, collect=("probs",))["probs"]
        return {
            t: probs[:, i, : self.tasks.num_classes[i]]
            for i, t in enumerate(self.tasks.names)
        }
