"""The traced run: spans around the benchmark's own calls into the program,
a fixed amount of work twice (untraced, the spans on the host clock; then
in one ``torch.profiler`` session), and the reduction of the two to what
the per-layer readers and the breakdown read."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench_window"


class Spans:
    """Named host spans around the benchmark's calls into the program.  Off
    (``mode`` None) they cost nothing; in ``"clock"`` mode each span's
    host-clock duration is kept; in ``"profile"`` mode each is a profiler
    range, which labels the device's idle gaps.  Host times are never read
    under the profiler, which stretches every launch."""

    def __init__(self):
        self.mode: Optional[str] = None
        self.host: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.mode is None:
            yield
        elif self.mode == "profile":
            from torch.profiler import record_function

            with record_function(name):
                yield
        else:
            t0 = time.perf_counter()
            yield
            self.host[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class Trace:
    """One traced window, reduced.  Times in seconds."""

    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]]  # kernel name -> each launch's duration
    copies: Dict[str, List[float]]  # "h2d" / "d2h" / "other" -> each copy's duration
    idle_by_span: Dict[str, float]  # host span open during each idle gap -> seconds
    host: Dict[str, List[float]]  # span name -> host-clock durations
    items: Dict[str, int]  # work in the window: {"steps": n, ...}; a step is one batch
    flops: float = 0.0  # model FLOPs of all the window's items
    peak_flop_per_s: float = 0.0  # of the run's precision
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    def kernel_s(self, part: str = "") -> List[float]:
        """Durations of the launches whose kernel name holds ``part``."""
        return [d for name, ds in self.kernels.items() if part in name for d in ds]

    def breakdown(self) -> dict:
        """The ten device operations with the most time, and idle time by
        the benchmark span the host was in."""
        ops = {n: sum(d) for n, d in self.kernels.items()}
        for kind, ds in self.copies.items():
            ops[f"memcpy_{kind}"] = sum(ds)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in idle]}


def _copy_kind(name: str) -> Optional[str]:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith(("Memcpy", "Memset")):
        return "other"
    return None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events, spans: Spans, items: Dict[str, int]) -> Trace:
    """Reduce profiler events (``prof.events()``: each with ``name``,
    ``device_type`` and ``time_range`` in µs) to a :class:`Trace`.  The
    window is the host range named ``WINDOW``; device work is every CUDA
    kernel, copy and set inside it (the profiler's annotation ranges on the
    device left out); an idle gap is labelled with the host span that
    overlaps it most, or "none"."""
    from torch.autograd import DeviceType

    names = set(spans.host) | {WINDOW}
    win = next(e.time_range for e in events if e.name == WINDOW
               and e.device_type == DeviceType.CPU)
    w0, w1 = win.start, win.end
    host: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    busy: List[Tuple[float, float]] = []
    kernels: Dict[str, List[float]] = defaultdict(list)
    copies: Dict[str, List[float]] = defaultdict(list)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if e.name in names and e.name != WINDOW:
                host[e.name].append((s, t))
            continue
        if e.device_type != DeviceType.CUDA or e.name in names or getattr(
                e, "is_user_annotation", False):
            continue
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        busy.append((s, t))
        kind = _copy_kind(e.name)
        (copies[kind] if kind else kernels[e.name]).append((t - s) * 1e-6)
    merged = _union(busy)
    idle: Dict[str, float] = defaultdict(float)
    at = w0
    for s, t in merged + [(w1, w1)]:
        if s > at:
            best, label = 0.0, "none"
            for name, rs in host.items():
                cover = sum(max(0.0, min(t0, s) - max(s0, at)) for s0, t0 in rs)
                if cover > best:
                    best, label = cover, name
            idle[label] += (s - at) * 1e-6
        at = max(at, t)
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=sum(t - s for s, t in merged) * 1e-6,
                 kernels=dict(kernels), copies=dict(copies), idle_by_span=dict(idle),
                 host={k: list(v) for k, v in spans.host.items()}, items=dict(items))


def profile(work, spans: Spans, device) -> Trace:
    """Run ``work()`` (which returns the items it did) twice: untraced,
    with the spans on the host clock, then inside one profiler session and
    the ``WINDOW`` range, the device drained before the range closes;
    returns the reduced trace: the device from the second, the host spans'
    durations from the first."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as tprofile

    def drain():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        drain()
        spans.mode = "clock"
        work()
        drain()
        spans.mode = "profile"
        with tprofile(activities=acts) as prof:
            with record_function(WINDOW):
                items = work()
                drain()
    finally:
        spans.mode = None
    return reduce(prof.events(), spans, items)
