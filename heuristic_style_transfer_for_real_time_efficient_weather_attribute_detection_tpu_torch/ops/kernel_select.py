"""Measured route selection: which variant of an op runs, by measurement.

Counterpart of the JAX package's ``ops/kernel_select.py``, with a record
of the port's own: ``kernel_ab.json`` beside this module, keyed by the
card's name (``torch.cuda.get_device_name``), then by op.  The readers
consult :func:`winner` when their argument is ``"auto"``:

- ``fused_trunk_gram`` (``fused`` | ``packed``): PMG's camera route
  (``workloads.stream.StreamPredictor``);
- ``pmg_head_fold`` (``f32`` | ``bf16`` | ``q8`` | ``fused_bf16`` |
  ``fused_q8``): the head on PMG's fused camera route;
- ``rtm_stream_folded`` (``generic`` | ``folded`` | ``folded_q8``): RTM's
  camera route;
- ``eval_scan_chunk_<family>_<f32|bf16>`` (``standalone`` | ``scan_k4`` |
  ``scan_k8``): ``Engine.resolve_scan_chunk("auto")``.

A record chooses only among an op's kernel routes (``KERNEL_ROUTES``), the
variants that run the op's hand-written kernels.  The others are measured
and recorded beside them but never chosen: PMG's ``packed`` route and its
``f32``/``bf16``/``q8`` head folds run the head as library matmuls where
the fused route runs K4, and RTM's ``generic`` and ``folded`` routes run
the heads as library matmuls where ``folded_q8`` runs K6.  So PMG's route
stays ``fused`` and RTM's ``folded_q8`` on every card; the head fold and
the scan chunk are chosen by measurement.

Timings of one call move by more than the routes differ, so a variant
replaces the reader's default only when it beat the default in every
recorded call, and in at least ``MIN_CALLS`` of them, with every round of
the variant faster than every round of the default (:func:`decide`).
Where the running device has no record (the CPU, or a card never
measured) each reader keeps its fixed rule.  ``python3 chip_smoke.py
--record`` measures the variants on the card and adds one call to the
record; a call at another shape or default starts the op's calls anew.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
from typing import Dict, List, Optional, Sequence

import torch

RECORD_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernel_ab.json")
MIN_CALLS = 2

_SCAN = ("standalone", "scan_k4", "scan_k8")
_SCAN_OPS = [f"eval_scan_chunk_{fam}_{dt}" for fam in ("pmg", "pm", "rtm") for dt in ("f32", "bf16")]
VARIANTS: Dict[str, tuple] = {
    "fused_trunk_gram": ("fused", "packed"),
    "pmg_head_fold": ("f32", "bf16", "q8", "fused_bf16", "fused_q8"),
    "rtm_stream_folded": ("generic", "folded", "folded_q8"),
    **{op: _SCAN for op in _SCAN_OPS},
}
KERNEL_ROUTES: Dict[str, tuple] = {
    "fused_trunk_gram": ("fused",),
    "pmg_head_fold": ("fused_bf16", "fused_q8"),
    "rtm_stream_folded": ("folded_q8",),
    **{op: _SCAN for op in _SCAN_OPS},  # one set of kernels, dispatched k batches at a time
}


def known_variants(op: str) -> tuple:
    """The variants the code can run for ``op``; ``ValueError`` for an op
    that is not selectable."""
    if op not in VARIANTS:
        raise ValueError(f"{op!r} is not a selectable op; expected one of {sorted(VARIANTS)}")
    return VARIANTS[op]


@functools.lru_cache(maxsize=None)
def _table() -> Dict:
    try:
        with open(RECORD_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def backend_kind(device=None) -> str:
    """The record's key for ``device`` (default: the card where there is
    one): the card's name, or "cpu"."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev)


def winner(op: str, default: str, device=None) -> str:
    """The recorded winner of ``op`` on ``device``'s card, or ``default``
    where nothing is recorded.  A recorded winner that the code does not
    know, or that is not one of the op's kernel routes, raises
    ``ValueError``."""
    entry = _table().get(backend_kind(device), {}).get(op)
    if not isinstance(entry, dict):
        return default
    win = entry.get("winner")
    if win not in known_variants(op):
        raise ValueError(f"{RECORD_PATH}: {op} records winner {win!r}, which is not one of "
                         f"{known_variants(op)}")
    if win not in KERNEL_ROUTES[op]:
        raise ValueError(f"{RECORD_PATH}: {op} records winner {win!r}, which runs library calls "
                         f"in place of the op's kernels; expected one of {KERNEL_ROUTES[op]}")
    return win


def decide(op: str, calls: Sequence[Dict[str, List[float]]], default: str) -> str:
    """The variant the readers run, from the op's recorded ``calls`` (each
    variant's round times in one call): the kernel route other than
    ``default`` whose every round beat every round of ``default`` in each
    of at least MIN_CALLS calls (of several, the one with the least sum of
    medians), else ``default``."""
    best, best_t = default, None
    if len(calls) < MIN_CALLS:
        return best
    for v in KERNEL_ROUTES[op]:
        if v == default or not all(v in c and max(c[v]) < min(c[default]) for c in calls):
            continue
        t = sum(statistics.median(c[v]) for c in calls)
        if best_t is None or t < best_t:
            best, best_t = v, t
    return best


def record(op: str, rounds: Dict[str, Sequence[float]], shape: str, default: str,
           backend: Optional[str] = None) -> str:
    """Add one call's measurement of ``op`` to the record: ``rounds`` maps
    each measured variant to its rounds' times in microseconds, ``default``
    is the readers' fixed rule.  The op's winner is decided anew over all
    its calls (:func:`decide`) and returned.  Ops and variants the code
    does not know are refused, and so is a default that is not a measured
    kernel route."""
    known = known_variants(op)
    unknown = sorted(set(rounds) - set(known))
    if unknown:
        raise ValueError(f"{op}: unknown variants {unknown}; expected some of {known}")
    if default not in rounds or default not in KERNEL_ROUTES[op]:
        raise ValueError(f"default {default!r} is not a measured kernel route of {op} "
                         f"(measured {sorted(rounds)}, kernel routes {KERNEL_ROUTES[op]})")
    backend = backend or backend_kind()
    try:
        with open(RECORD_PATH) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    old = data.setdefault(backend, {}).get(op) or {}
    calls = old.get("calls", []) if (old.get("shape"), old.get("default")) == (shape, default) else []
    calls.append({v: [round(float(t), 2) for t in ts] for v, ts in rounds.items()})
    win = decide(op, calls, default)
    data[backend][op] = {"winner": win, "default": default, "calls": calls, "unit": "us",
                         "shape": shape}
    with open(RECORD_PATH, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    _table.cache_clear()
    return win
