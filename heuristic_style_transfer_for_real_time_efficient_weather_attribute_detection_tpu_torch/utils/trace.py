"""The port's tracer: named spans and counters inside the program, kept in
memory and read after a session.

    from ..utils import trace

    with trace.span("engine.forward", device=self.device):
        ...
    trace.count("engine.rows", n)

    with trace.recording():           # or inside a torch.profiler session
        engine.run(frames)
    trace.records()                   # the last session's spans
    trace.summary()                   # per span: count, mean host and device ms

Off by default.  A span records only while a :func:`recording` block is
open or a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``, which the profiler sets
on start and clears on stop).  Off, :func:`span` returns one shared null
context after that single check: it reads no clock, allocates nothing and
opens no ``record_function``.  While a profiler session records, every span
also opens ``torch.profiler.record_function(name)``, so it stands in the
profiler's own timeline, on the device trace's clock.

A span keeps its name, an id, its parent's id (the span open around it on
the same thread), the id it is linked to (``link``: the batch an
``engine.wait`` waits for) and its start and end on
``time.perf_counter_ns()``.  A span given the ``device`` its work runs on
keeps a device time too: on a CUDA device, from a pair of timing events on
that device's current stream, whose elapsed time is read in
:func:`records`, never while the span runs; on the CPU, its host time.

Records are grouped by session: one profiler session or one
:func:`recording` block (a profiler session that starts inside a
:func:`recording` block records into the block's).  A session keeps at most
``cap`` spans and counts the spans past it in ``dropped``; the tracer keeps
its last ``keep`` sessions.  The readers take the last session by default.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _prof

_NULL = contextlib.nullcontext()
# profiler sessions started since the hook went in (see _watch_profiler_starts)
_profiler_starts = 0


def _watch_profiler_starts() -> None:
    """Count profiler starts, so that two profiler sessions with no span
    between them still make two sessions.  ``torch.autograd.profiler``
    calls its module-level ``_run_on_profiler_start`` on every start; the
    hook wraps it once, the first time the tracer records."""
    orig = getattr(_prof, "_run_on_profiler_start", None)
    if orig is None or getattr(orig, "_counts_starts", False):
        return

    def start():
        global _profiler_starts
        _profiler_starts += 1
        orig()

    start._counts_starts = True
    _prof._run_on_profiler_start = start


class Record(NamedTuple):
    """One closed span as :func:`records` returns it; times in ms, the
    device time None for a span without ``device``."""

    name: str
    id: int
    parent: Optional[int]
    link: Optional[int]
    start_ns: int
    end_ns: int
    host_ms: float
    device_ms: Optional[float]


class _Session:
    def __init__(self, kind: str, cap: int):
        self.kind, self.cap, self.epoch = kind, cap, _profiler_starts
        self.spans: List["_Span"] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0


class _Span:
    __slots__ = ("name", "id", "parent", "link", "t0", "t1", "device", "events", "rf",
                 "device_ms", "_stack")

    def __init__(self, name: str, sid: int, link: Optional[int], device, stack: list):
        self.name, self.id, self.link, self.device = name, sid, link, device
        self.parent = self.t1 = self.events = self.rf = self.device_ms = None
        self._stack = stack

    def __enter__(self) -> int:
        self.parent = self._stack[-1] if self._stack else None
        self._stack.append(self.id)
        if _prof._is_profiler_enabled:
            self.rf = _prof.record_function(self.name)
            self.rf.__enter__()
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        self.t0 = time.perf_counter_ns()
        return self.id

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.events[2])
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self._stack.pop()
        return False

    def record(self) -> Record:
        host = (self.t1 - self.t0) / 1e6
        if self.device_ms is None and self.device is not None:
            if self.events is None:
                self.device_ms = host
            else:
                self.events[1].synchronize()
                self.device_ms = self.events[0].elapsed_time(self.events[1])
        return Record(self.name, self.id, self.parent, self.link, self.t0, self.t1, host,
                      self.device_ms)


class Tracer:
    """Spans and counters by session; the module's functions use one
    process-wide tracer."""

    def __init__(self, cap: int = 65536, keep: int = 8):
        self.cap = cap
        self.sessions: deque = deque(maxlen=keep)
        self._recording = 0  # open recording() blocks
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, *, device=None, link: Optional[int] = None):
        """A context manager around one piece of work, on ``device`` (a
        ``torch.device`` or its name) when its device time is wanted;
        entered, it gives the span's id (None when off)."""
        if not (self._recording or _prof._is_profiler_enabled):
            return _NULL
        s = self._session()
        if len(s.spans) >= s.cap:
            s.dropped += 1
            return _NULL
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        sp = _Span(name, next(self._ids), link, device, stack)
        s.spans.append(sp)
        return sp

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` of the session recording."""
        if not (self._recording or _prof._is_profiler_enabled):
            return
        s = self._session()
        with self._lock:
            s.counters[name] = s.counters.get(name, 0) + n

    @contextlib.contextmanager
    def recording(self):
        """Record into a new session while the block runs."""
        self._open("recording")
        self._recording += 1
        try:
            yield
        finally:
            self._recording -= 1

    def _open(self, kind: str) -> _Session:
        _watch_profiler_starts()
        with self._lock:
            s = _Session(kind, self.cap)
            self.sessions.append(s)
            return s

    def _session(self) -> _Session:
        s = self.sessions[-1] if self.sessions else None
        if self._recording:
            return s
        if s is None or s.kind != "profiler" or s.epoch != _profiler_starts:
            s = self._open("profiler")
        return s

    def _pick(self, session: int) -> Optional[_Session]:
        return self.sessions[session] if self.sessions else None

    def records(self, session: int = -1) -> List[Record]:
        """The closed spans of a session (the last by default), in the order
        they opened."""
        s = self._pick(session)
        return [sp.record() for sp in list(s.spans) if sp.t1 is not None] if s else []

    def counters(self, session: int = -1) -> Dict[str, int]:
        s = self._pick(session)
        return dict(s.counters) if s else {}

    def dropped(self, session: int = -1) -> int:
        """Spans a session left out past its cap."""
        s = self._pick(session)
        return s.dropped if s else 0

    def mean_device_ms(self, name: str, session: int = -1) -> Optional[float]:
        """Mean device time of a session's spans named ``name``, or None."""
        ds = [r.device_ms for r in self.records(session)
              if r.name == name and r.device_ms is not None]
        return sum(ds) / len(ds) if ds else None

    def summary(self, session: int = -1) -> dict:
        """Per span name: count, mean host ms and mean device ms (None for
        spans without ``device``); the counters and the dropped count."""
        by: Dict[str, List[Record]] = {}
        for r in self.records(session):
            by.setdefault(r.name, []).append(r)
        spans = {}
        for name, rs in by.items():
            dev = [r.device_ms for r in rs if r.device_ms is not None]
            spans[name] = {"count": len(rs), "host_ms": sum(r.host_ms for r in rs) / len(rs),
                           "device_ms": sum(dev) / len(dev) if dev else None}
        return {"spans": spans, "counters": self.counters(session),
                "dropped": self.dropped(session)}


def format_summary(summ: dict) -> str:
    """A :meth:`Tracer.summary` as a text table."""
    lines = [f"{'span':<20} {'count':>7} {'host ms':>10} {'device ms':>10}"]
    for name, s in summ["spans"].items():
        dev = "-" if s["device_ms"] is None else f"{s['device_ms']:.3f}"
        lines.append(f"{name:<20} {s['count']:>7} {s['host_ms']:>10.3f} {dev:>10}")
    for name, n in summ["counters"].items():
        lines.append(f"{name:<20} {n:>7}")
    if summ["dropped"]:
        lines.append(f"dropped past the cap: {summ['dropped']}")
    return "\n".join(lines)


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
recording = TRACER.recording
records = TRACER.records
counters = TRACER.counters
dropped = TRACER.dropped
mean_device_ms = TRACER.mean_device_ms
summary = TRACER.summary
