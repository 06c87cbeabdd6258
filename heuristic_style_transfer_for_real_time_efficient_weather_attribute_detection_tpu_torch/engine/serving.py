"""Asynchronous micro-batching executor, the continuous-batching serving
layer: camera, watch and folder streams never block on dispatch.

Clients submit single frames (or small requests) and get futures; a
background dispatcher coalesces whatever is queued, up to ``max_batch``,
into one padded forward of an ``Engine`` or an ``ExportedPredictor``, so
concurrent streams share the card and one 30 FPS camera never waits behind
another stream's dispatch.

Design notes:
- one batch shape (``max_batch``): padding beats a shape zoo,
- the dispatcher thread enqueues the card's work on its own current CUDA
  stream and blocks on device results; callers only block on their own
  future,
- per-request latency telemetry (queue wait + device time) is recorded for
  the p50/p99 serving report.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np



class Overloaded(RuntimeError):
    """Raised by ``submit`` when the bounded request queue is full — the
    backpressure signal for sustained overload (the HTTP front-end maps it
    to 503 + Retry-After)."""


class _Request:
    __slots__ = ("image", "future", "t_submit")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class AsyncBatcher:
    """Micro-batching front-end over an ``Engine`` (or anything with its
    ``batch_size`` and ``dispatch``/``fetch``, such as ``ExportedPredictor``).

    ``submit(image_u8) -> Future`` resolving to
    ``{"probs": [T, Kmax], "preds": [T], "latency_s": float}``.
    """

    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 2.0,
        max_queue: Optional[int] = None,
    ):
        self.engine = engine
        self.max_batch = max_batch or engine.batch_size
        self.max_wait = max_wait_ms / 1e3
        # pipeline depth: batches in flight before the oldest must resolve
        self._DEPTH = 3
        # Bounded admission queue: beyond ~2 full pipelines of backlog the
        # request would time out waiting anyway, so reject at submit (503)
        # instead of growing host memory and queue latency without bound.
        if max_queue is not None and max_queue <= 0:
            # queue.Queue(maxsize=0) means UNBOUNDED — the opposite of the
            # most restrictive setting; reject rather than silently disable
            # backpressure
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        self.max_queue = (
            max_queue if max_queue is not None
            else 2 * self.max_batch * self._DEPTH
        )
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=self.max_queue
        )
        self._stop = threading.Event()
        # bounded: long-running servers must not grow host memory per request
        self.latencies: "deque[float]" = deque(maxlen=100_000)
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    # -- client API --------------------------------------------------------

    def submit(self, image_u8: np.ndarray) -> Future:
        if self._stop.is_set():
            raise RuntimeError("AsyncBatcher is closed")
        req = _Request(image_u8)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise Overloaded(
                f"request queue full ({self.max_queue} pending); retry later"
            ) from None
        return req.future

    def predict(self, image_u8: np.ndarray, timeout: Optional[float] = None) -> Dict:
        return self.submit(image_u8).result(timeout)

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        try:
            self._queue.put(None, timeout=timeout)
        except queue.Full:
            # sentinel dropped against a full queue — the dispatcher's timed
            # get re-checks _stop, so it still terminates once the backlog
            # drains (join may outlast ``timeout`` if a dispatch is wedged)
            pass
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def latency_percentiles(self) -> Dict[str, float]:
        if not self.latencies:
            return {}
        arr = np.asarray(list(self.latencies))
        return {
            "p50": float(np.percentile(arr, 50)),
            "p90": float(np.percentile(arr, 90)),
            "p99": float(np.percentile(arr, 99)),
            "mean": float(arr.mean()),
            "n": len(arr),
        }

    # -- dispatcher --------------------------------------------------------

    def _collect(self, block: bool = True) -> Optional[List[_Request]]:
        """Gather one micro-batch: take a first request (blocking only when
        ``block``), then drain (bounded) whatever arrived while we were
        dispatching, waiting at most max_wait for stragglers.

        Returns None on the shutdown sentinel, [] when non-blocking and
        idle.  Once the deadline passes we only take what is immediately
        available (get_nowait) — a blocking get(timeout=None) here would
        hold the partial batch's futures hostage until an unrelated request
        arrived.
        """
        try:
            if block:
                # timed get re-checking _stop: close()'s sentinel put can be
                # dropped against a full bounded queue, and this thread must
                # still terminate once the backlog drains
                while True:
                    try:
                        first = self._queue.get(timeout=0.5)
                        break
                    except queue.Empty:
                        if self._stop.is_set():
                            return None
            else:
                first = self._queue.get_nowait()
        except queue.Empty:
            return []
        if first is None:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                if remaining > 0:
                    nxt = self._queue.get(timeout=remaining)
                else:
                    nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                # flag shutdown for the outer loop (a re-put could block
                # against the bounded queue from this very thread)
                self._drain_seen = True
                break
            batch.append(nxt)
        return batch

    def _dispatch_loop(self) -> None:
        """Pipelined dispatcher: keep up to ``_DEPTH`` micro-batches in
        flight (``dispatch`` starts each one's device->host result copy
        immediately), resolving the oldest while newer ones execute and
        transfer.  The fixed per-fetch result latency then overlaps across
        batches, while per-request latency stays one pipeline depth."""
        eng = self.engine
        inflight: "deque[tuple]" = deque()
        stopping = False
        self._drain_seen = False
        while not (stopping and not inflight):
            batch: Optional[List[_Request]] = []
            if not stopping:
                batch = self._collect(block=not inflight)
                if batch is None or self._drain_seen:
                    stopping = True
                    batch = batch or []
            if batch:
                try:
                    images = np.stack([r.image for r in batch])
                    inflight.append((batch, eng.dispatch(images)))
                except Exception as e:
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
            if inflight and (len(inflight) >= self._DEPTH or not batch):
                reqs, handle = inflight.popleft()
                try:
                    out = eng.fetch(handle)
                    now = time.perf_counter()
                    for i, r in enumerate(reqs):
                        lat = now - r.t_submit
                        self.latencies.append(lat)
                        r.future.set_result(
                            {
                                "probs": out["probs"][i],
                                "preds": out["preds"][i],
                                "latency_s": lat,
                            }
                        )
                except Exception as e:  # propagate to waiters, keep serving
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)
        # drain any remaining requests with a shutdown error
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None and not r.future.done():
                r.future.set_exception(RuntimeError("AsyncBatcher closed"))
