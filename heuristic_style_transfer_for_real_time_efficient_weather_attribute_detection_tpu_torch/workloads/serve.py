"""HTTP inference service, the production serving front-end.

Stdlib-only (http.server + ThreadingHTTPServer) over the AsyncBatcher, so
concurrent clients coalesce into micro-batches on the card.  It serves a
live ``Engine`` or an ``ExportedPredictor`` (an AOT artifact).

Endpoints:
  GET  /healthz           -> {"status": "ok", "model": ..., "tasks": N}
  GET  /stats             -> latency percentiles + request count
  POST /predict           -> body: image bytes (any PIL-decodable format);
                             response: {task: {predicted_class, probability,
                             probs: {class: p, ...}}} with threshold->"Unknown"
                             semantics matching the reference eval modes.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
from PIL import Image

from ..config import DEFAULT_IMG_SIZE
from ..engine.serving import AsyncBatcher, Overloaded
from ..ops.preprocess import load_image_uint8


def make_handler(
    engine,
    batcher: AsyncBatcher,
    prob_threshold: float,
    max_body_bytes: int = 32 * 1024 * 1024,
    result_timeout_s: float = 60.0,
):
    tasks = engine.tasks

    class Handler(BaseHTTPRequestHandler):
        server_version = "wadt-serve/0.1"

        def _json(self, code: int, payload, extra_headers=()) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra_headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model": engine.family,
                    "tasks": len(tasks),
                    "batch_size": engine.batch_size,
                })
            elif self.path == "/stats":
                self._json(200, batcher.latency_percentiles() or {"n": 0})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body (expect image bytes)"})
                return
            if length > max_body_bytes:
                # reject BEFORE buffering: an oversize POST must not be
                # read into host memory; announce the close (the body is
                # unread so the keep-alive socket can't be reused — clients
                # still streaming may see a reset, which is inherent to
                # refusing the upload)
                self.close_connection = True
                self._json(413, {
                    "error": f"body {length} bytes exceeds limit "
                             f"{max_body_bytes}",
                }, extra_headers=(("Connection", "close"),))
                return
            try:
                raw = self.rfile.read(length)
                img = Image.open(io.BytesIO(raw))
                frame = load_image_uint8(img)
            except Exception as e:
                self._json(400, {"error": f"undecodable image: {e}"})
                return
            try:
                res = batcher.predict(frame, timeout=result_timeout_s)
            except Overloaded as e:
                self._json(503, {"error": str(e)},
                           extra_headers=(("Retry-After", "1"),))
                return
            except concurrent.futures.TimeoutError:
                self._json(504, {
                    "error": f"inference timed out after {result_timeout_s}s",
                })
                return
            except Exception as e:
                self._json(503, {"error": f"inference failed: {e}"})
                return
            out = {}
            for ti, t in enumerate(tasks.names):
                k = tasks.num_classes[ti]
                p = res["probs"][ti, :k]
                idx = int(p.argmax())
                label = (
                    "Unknown" if p[idx] < prob_threshold
                    else tasks.class_names[ti][idx]
                )
                out[t] = {
                    "predicted_class": label,
                    "probability": float(p[idx]),
                    "probs": {
                        c: float(p[i]) for i, c in enumerate(tasks.class_names[ti])
                    },
                }
            self._json(200, {
                "prediction": out,
                "latency_ms": round(res["latency_s"] * 1e3, 2),
            })

    return Handler


class InferenceServer:
    """Threaded HTTP server; ``serve_forever`` blocks, ``start``/``stop``
    run it on a daemon thread (tests)."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8000,
                 prob_threshold: float = 0.5, max_wait_ms: float = 2.0,
                 max_body_bytes: int = 32 * 1024 * 1024,
                 result_timeout_s: float = 60.0,
                 max_queue: Optional[int] = None):
        self.batcher = AsyncBatcher(
            engine, max_wait_ms=max_wait_ms, max_queue=max_queue
        )
        handler = make_handler(
            engine, self.batcher, prob_threshold,
            max_body_bytes=max_body_bytes, result_timeout_s=result_timeout_s,
        )

        class _Server(ThreadingHTTPServer):
            # stdlib default backlog of 5 drops bursts (connection reset
            # when >5 clients connect while the accept loop is busy)
            request_queue_size = 128

        self.httpd = _Server((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def warmup(self) -> None:
        """One zero frame through the full batcher->card path before traffic
        arrives.  On the card the first call builds the kernel library (nvcc,
        tens of seconds when it is not cached), which could exceed
        ``result_timeout_s`` and 504 the first client."""
        dummy = np.zeros((DEFAULT_IMG_SIZE, DEFAULT_IMG_SIZE, 3), np.uint8)
        self.batcher.predict(dummy, timeout=None)
        # the warmup's build time is not serving latency: keep it out of
        # the percentile telemetry
        self.batcher.latencies.clear()

    def start(self, warmup: bool = True):
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self, warmup: bool = True):
        print(f"serving on :{self.port} (POST /predict, GET /healthz, /stats)")
        if warmup:
            self.warmup()
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
