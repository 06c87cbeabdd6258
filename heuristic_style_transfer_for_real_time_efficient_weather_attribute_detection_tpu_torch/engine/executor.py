"""Batch execution engine of the port.

One engine serves every batch workload: ``run(images_uint8)`` takes uint8
NHWC frames (any N), pads the tail batch to the engine's batch size, runs
the forward on the device, and returns host numpy probs / preds / logits.
Images cross to the device as uint8 and are normalized there (folded into
the stem kernel on the PMG path); from host memory to a CUDA engine they go
through the engine's pinned staging ring on a copy stream of its own
(``wire.StagingRing``), so that one batch's copy runs under the forward of
the batch before it.  ``dtype=torch.bfloat16`` runs the
forward in bf16 on a cast copy of the params, as the JAX package's
``Engine(dtype=jnp.bfloat16)`` does.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import IGNORE_INDEX, UNKNOWN_PRED, TaskSpec
from ..models import get_family
from ..ops.nn import cast_tree
from ..ops.preprocess import normalize_uint8
from ..parallel.mesh import Mesh
from ..utils import trace
from .checkpoint import to_device
from .wire import StagingRing, pad_batch, to_host_async, validate_and_pack, wait_host

_UNBATCHED = ("loss_per_task", "count_per_task")


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

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank builds the engine alike
    and calls it in step, with the same host batches, as the JAX API takes
    them): each rank holds a full copy of the params, runs its rows of each
    (padded) batch over the mesh's 'data' axis and gathers the results, so
    :meth:`run`, :meth:`step`, :meth:`step_scan` and :meth:`run_stream`
    return on every rank what the engine without a mesh returns.
    ``batch_size`` must divide by the 'data' size.
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
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got {type(mesh).__name__}")
        self.mesh = mesh
        # this rank's rows of every batch (ValueError where they do not split evenly)
        self._rows = slice(*mesh.row_range(batch_size)) if mesh is not None else None
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
        self._ring = StagingRing(self.device) if self.device.type == "cuda" else None
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

    def _outputs(self, images: torch.Tensor, run_params: Any, stem: Any,
                 mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The label-free part of a step on the given run params, stem fold
        and class mask: logits, probs, max_probs, preds and the capture taps.
        ``engine.export`` traces this same function into the artifact."""
        if self.pack_k is not None:
            logits, aux = self._mod.apply_packed(
                run_params, images, self.spec, self.capture, stem, self.dtype
            )
        else:
            logits, aux = self._mod.apply(
                run_params, normalize_uint8(images, self.dtype), self.spec, self.capture
            )
        logits = logits.float()
        probs = masked_softmax(logits, mask)
        maxp = probs.amax(dim=-1)
        preds = probs.argmax(dim=-1).int()
        preds = torch.where(maxp < self.prob_threshold, UNKNOWN_PRED, preds)
        out = {"logits": logits, "probs": probs, "max_probs": maxp, "preds": preds}
        out.update({k: v.float() for k, v in aux.items()})
        return out

    @torch.inference_mode()
    def _step(self, images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        with trace.span("engine.forward", device=self.device):
            out = self._outputs(images, self._run_params, self._stem, self._mask)
            loss_t, count_t = masked_cross_entropy(out["logits"], labels, self._mask)
            out.update(loss_per_task=loss_t, count_per_task=count_t)
        return out

    def _upload(self, images, labels: Optional[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 images [..., H, W, C] and their labels [..., T] (IGNORE
        when None) on the device: host images on a CUDA engine through the
        staging ring (call :meth:`_release` once their forward is
        enqueued), anything else as it is."""
        with trace.span("engine.upload"):
            if self._ring is None or (torch.is_tensor(images) and images.is_cuda):
                x = torch.as_tensor(images).to(self.device, non_blocking=True)
                y = None if labels is None else torch.as_tensor(labels).to(self.device,
                                                                           non_blocking=True)
            elif labels is None:
                (x,), y = self._ring.stage([images]), None
            else:
                x, y = self._ring.stage([images, labels])
            if y is None:
                y = torch.full(x.shape[:-3] + (len(self.tasks),), IGNORE_INDEX,
                               dtype=torch.int32, device=self.device)
        return x, y

    def _release(self) -> None:
        """The forward of what :meth:`_upload` staged is enqueued: the
        ring's slots may be copied over behind it."""
        if self._ring is not None:
            self._ring.release()

    def _local(self, images, labels, dim: int):
        """This rank's rows (along ``dim``) of host images and labels."""
        if self.mesh is None:
            return images, labels
        rows = (slice(None),) * dim + (self._rows,)
        return images[rows], (None if labels is None else labels[rows])

    def _gather(self, out: Dict[str, torch.Tensor], dim: int) -> Dict[str, torch.Tensor]:
        """Every rank's rows of a step's results, concatenated along ``dim``
        over the mesh's 'data' axis; the per-task loss from the global
        sums (the ranks' count-weighted losses over their summed counts)."""
        if self.mesh is None:
            return out
        m = self.mesh
        res = {k: m.gather(v, "data", dim) for k, v in out.items() if k not in _UNBATCHED}
        count = m.all_reduce(out["count_per_task"], "data")
        loss = m.all_reduce(out["loss_per_task"] * out["count_per_task"], "data")
        res.update(loss_per_task=loss / count.clamp(min=1), count_per_task=count)
        return res

    def step(self, images, labels: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """One forward on exactly one batch of uint8 images (numpy or a
        tensor); results stay on the device."""
        out = self._step(*self._upload(*self._local(images, labels, 0)))
        self._release()
        return self._gather(out, 0)

    @torch.inference_mode()
    def step_scan(self, images, labels: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """k micro-batches stacked ``[k, batch_size, ...]`` in one call: one
        upload, then the k steps back to back.  Results stay on the device,
        each leaf stacked ``[k, batch_size, ...]`` (per-task aggregates
        ``[k, T]``), and equal k calls of :meth:`step` bit for bit."""
        x, y = self._upload(*self._local(images, labels, 1))
        outs = [self._step(x[i], y[i]) for i in range(x.shape[0])]
        self._release()
        return self._gather({key: torch.stack([o[key] for o in outs]) for key in outs[0]}, 1)

    def warmup(self, img_size: int = 224) -> None:
        z = np.zeros((self.batch_size, img_size, img_size, 3), np.uint8)
        self.step(z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- pipelined micro-batch API (serving) -----------------------------

    def _validate_and_pack(self, images: np.ndarray) -> np.ndarray:
        return validate_and_pack(images, self.pack_k)

    def dispatch(
        self,
        images: np.ndarray,
        labels: Optional[np.ndarray] = None,
        collect: Sequence[str] = ("probs", "preds"),
    ):
        """Enqueue one micro-batch (<= batch_size uint8 frames, raw or
        packed) and start copying its results to the host; returns a handle
        for :meth:`fetch`."""
        images = self._validate_and_pack(images)
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(f"micro-batch {n} > engine batch {self.batch_size}")
        keys = set(collect) | (set(_UNBATCHED) if labels is not None else set())
        with trace.span("engine.batch") as batch:
            images, labels = pad_batch(images, self.batch_size, labels)
            host, event = self._to_host(self.step(images, labels), keys)
        return n, host, event, batch

    def dispatch_scan(
        self,
        stack: np.ndarray,
        labels: Optional[np.ndarray] = None,
        collect: Sequence[str] = ("probs", "preds"),
    ):
        """Enqueue k full micro-batches stacked ``[k, batch_size, ...]``
        through :meth:`step_scan` and start copying their results to the
        host; returns a handle for :meth:`fetch`, whose leaves come back
        stacked ``[k, batch_size, ...]`` (per-task aggregates ``[k, T]``)."""
        keys = set(collect) | (set(_UNBATCHED) if labels is not None else set())
        with trace.span("engine.batch") as batch:
            trace.count("engine.rows", stack.shape[0] * stack.shape[1])
            host, event = self._to_host(self.step_scan(stack, labels), keys)
        return stack.shape[0], host, event, batch

    @staticmethod
    def _to_host(res: Dict[str, torch.Tensor], keys):
        with trace.span("engine.d2h"):
            return to_host_async(res, keys)

    def fetch(self, handle) -> Dict[str, np.ndarray]:
        """Wait for a :meth:`dispatch` or :meth:`dispatch_scan` handle ->
        host arrays [n, ...] (per-task aggregates stay unsliced)."""
        take, host, event, batch = handle
        with trace.span("engine.wait", link=batch):
            out = wait_host(host, event)
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

        Up to 4 dispatches stay in flight: each one's results start copying
        to the host as soon as its forward is enqueued, and the oldest is
        drained only then.  ``scan_chunk=k`` runs k full micro-batches per
        dispatch through :meth:`step_scan` (one upload, one copy back); the
        tail goes batch by batch.  Results are the same either way.

        ``measure_time`` is the ``--measure_time`` latency report: it
        returns per-batch wall times under "times", synchronizes on every
        batch (so nothing overlaps) and turns ``scan_chunk`` off.  The
        tracer (``utils.trace``) is separate and changes no result.
        """
        images = self._validate_and_pack(images)
        n = images.shape[0]
        bs = self.batch_size
        outs: Dict[str, List[np.ndarray]] = {k: [] for k in collect}
        loss_sums = np.zeros(len(self.tasks), np.float64)
        counts = np.zeros(len(self.tasks), np.int64)
        times: List[float] = []
        inflight: List[Tuple[Any, bool]] = []

        def _drain_one() -> None:
            handle, scanned = inflight.pop(0)
            out = self.fetch(handle)
            for k in collect:
                v = out[k]
                outs[k].append(v.reshape((-1,) + v.shape[2:]) if scanned else v)
            if labels is not None:
                cnt = out["count_per_task"].astype(np.int64)
                contrib = out["loss_per_task"] * cnt
                if scanned:  # per-task aggregates come back [k, T]
                    cnt, contrib = cnt.sum(axis=0), contrib.sum(axis=0)
                np.add(loss_sums, contrib, out=loss_sums)
                np.add(counts, cnt, out=counts)

        def _submit(handle, scanned: bool) -> None:
            inflight.append((handle, scanned))
            if len(inflight) >= 4:
                _drain_one()

        start = 0
        k = self.resolve_scan_chunk(scan_chunk)
        if k > 1 and not measure_time:
            start = (n // (k * bs)) * k * bs
            for s in range(0, start, k * bs):
                stack = images[s : s + k * bs].reshape((k, bs) + images.shape[1:])
                lab = labels[s : s + k * bs].reshape(k, bs, -1) if labels is not None else None
                _submit(self.dispatch_scan(stack, lab, collect), True)
        for s in range(start, n, bs):
            e = min(s + bs, n)
            t0 = time.perf_counter()
            handle = self.dispatch(images[s:e], labels[s:e] if labels is not None else None,
                                   collect)
            if measure_time:
                if handle[2] is not None:
                    handle[2].synchronize()
                times.append(time.perf_counter() - t0)
            _submit(handle, False)
        while inflight:
            _drain_one()
        result = {k: np.concatenate(v, axis=0) for k, v in outs.items() if v}
        if labels is not None:
            result["loss_per_task"] = loss_sums / np.maximum(counts, 1)
            result["count_per_task"] = counts
        if measure_time:
            result["times"] = np.asarray(times)
        return result

    def resolve_scan_chunk(self, scan_chunk) -> int:
        """Micro-batches per dispatch: an int passes through; ``None`` and
        ``"off"`` are 1; ``"auto"`` is the winner measured on this engine's
        card for its family and dtype (``ops.kernel_select``, op
        ``eval_scan_chunk_<family>_<f32|bf16>``: ``scan_k<k>`` is k,
        ``standalone`` 1), and 1 where nothing is recorded (the CPU)."""
        if scan_chunk == "auto":
            from ..ops.kernel_select import winner

            dt = "bf16" if self.dtype == torch.bfloat16 else "f32"
            w = winner(f"eval_scan_chunk_{self.family}_{dt}", "standalone", self.device)
            return int(w[len("scan_k"):]) if w.startswith("scan_k") else 1
        if scan_chunk in (None, "off"):
            return 1
        return int(scan_chunk)

    def run_stream(
        self,
        batches,
        collect: Sequence[str] = ("probs",),
        scan_chunk="auto",
        depth: int = 3,
    ) -> Tuple[Dict[str, np.ndarray], List]:
        """Drive a loader's ``(imgs, labels, extra)`` batches through the
        engine: consecutive full micro-batches go k at a time through
        :meth:`step_scan`, with up to ``depth`` dispatches in flight; short
        or tail batches flush the buffered full ones first and then go
        alone, so row order is kept.  Returns ``(stacked result dict,
        flattened extras)``, the extras (e.g. the kept paths of a
        ``skip_errors`` loader) aligned with the result rows.

        On an empty stream the standard keys come back with their real
        trailing shapes (``probs``/``logits`` [0, T, Kmax],
        ``preds``/``max_probs`` [0, T]); capture-tap keys, whose shapes are
        model-internal, as a bare ``[0]`` float32 array.
        """
        k = self.resolve_scan_chunk(scan_chunk)
        outs: Dict[str, List[np.ndarray]] = {c: [] for c in collect}
        extras: List = []
        inflight: List[Tuple[object, bool]] = []
        buf: List[np.ndarray] = []

        def _drain_one() -> None:
            handle, scanned = inflight.pop(0)
            out = self.fetch(handle)
            for c in collect:
                v = out[c]
                outs[c].append(v.reshape((-1,) + v.shape[2:]) if scanned else v)

        def _submit(handle, scanned: bool) -> None:
            inflight.append((handle, scanned))
            if len(inflight) >= depth:
                _drain_one()

        def _flush_buf() -> None:
            while buf:
                _submit(self.dispatch(buf.pop(0), collect=collect), False)

        for item in batches:
            if len(item) > 2 and item[2] is not None:
                extras.extend(item[2])
            imgs = self._validate_and_pack(item[0])
            if k > 1 and imgs.shape[0] == self.batch_size:
                buf.append(imgs)
                if len(buf) == k:
                    stack = np.stack(buf)
                    buf.clear()
                    _submit(self.dispatch_scan(stack, collect=collect), True)
            else:
                _flush_buf()
                _submit(self.dispatch(imgs, collect=collect), False)
        _flush_buf()
        while inflight:
            _drain_one()
        result = {
            c: (np.concatenate(v, axis=0) if v else self._empty_result(c))
            for c, v in outs.items()
        }
        return result, extras

    def _empty_result(self, key: str) -> np.ndarray:
        """[0, ...] empty in the step's output layout for the standard keys,
        so that e.g. ``probs[:, t]`` on an empty stream is an empty slice;
        capture-tap keys, whose shapes are model-internal, get a bare [0]
        float32 array."""
        t, kmax = self._mask.shape
        if key in ("probs", "logits"):
            return np.zeros((0, t, kmax), np.float32)
        if key == "preds":
            return np.zeros((0, t), np.int32)
        if key == "max_probs":
            return np.zeros((0, t), np.float32)
        if key in _UNBATCHED:
            return np.zeros((t,), np.float32)
        return np.zeros((0,), np.float32)

    def predict_dict(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """{task: probs [N, K_t]}, the reference's per-task dict contract."""
        probs = self.run(images, collect=("probs",))["probs"]
        return {
            t: probs[:, i, : self.tasks.num_classes[i]]
            for i, t in enumerate(self.tasks.names)
        }
