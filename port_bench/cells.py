"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
names ``drivers/<driver>.py``), ``limits/<cell>.json`` and the reader of
each per-layer metric, ``layer_metrics/<metric>.py`` or, for a quantity
split by the end-to-end metric it moves (``idle_pct.infer``), the
quantity's ``layer_metrics/idle_pct.py``; all under ``port_bench/``.  A new
cell, configuration, traffic mix or per-layer metric is new files and new
entries; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from importlib import import_module
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = "port_bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, BENCH_DIR, *parts)) as f:
        return json.load(f)


def load(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    limits = {k: v["limit"] for k, v in _json(root, "limits", f"{name}.json")["numbers"].items()}
    return Cell(name, int(w["chips"]), _json(root, "configs", f"{w['config']}.json"),
                _json(root, "traffic", f"{w['traffic']}.json"), limits, e2e, per_layer)


def driver(cell: Cell) -> ModuleType:
    """The module ``drivers/<driver>.py`` that the cell's traffic names: its
    ``Run``, its ``control`` and its ``FAULTS``."""
    return import_module(f"{__package__}.drivers.{cell.traffic['driver']}")


def reader(root: str, metric: str) -> Callable:
    """``read(trace)`` of ``layer_metrics/<metric>.py``, or of the file of
    the part of the name before its first dot."""
    folder = os.path.join(root, BENCH_DIR, "layer_metrics")
    path = os.path.join(folder, f"{metric}.py")
    if not os.path.isfile(path):
        path = os.path.join(folder, f"{metric.split('.')[0]}.py")
    name = f"{BENCH_DIR}_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
