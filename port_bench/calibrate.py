"""The readings that a cell's limits are set from, on the card, at the
cell's own sizes, many seeds in one process:

- the program's numbers on each of ``--seeds`` (the lower readings);
- the control's on each of ``--control-seeds``: the reference put in the
  program's place, computed in the next precision below the cell's (TF32
  for float32 with TF32 off, per-tensor fp8 for bf16);
- each planted fault's (the driver's ``FAULTS``) on each of
  ``--control-seeds``.

    python3 -m port_bench.calibrate --workload rtm_resnet50.infer_bf16 \\
        --seeds 1 2 3 --control-seeds 1 2 3 --out calib.jsonl

One JSON line a reading goes to ``--out``; the largest program reading and
the smallest control and fault readings of each number to standard output.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from . import cells
from .run import ROOT, cache_env, context

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def program(driver, ctx) -> dict:
    """A run's numbers without its window: set-up, the traced run's fixed
    work untraced, then the check."""
    run = driver.Run(ctx)
    run.traced()
    numbers = run.check()
    return {"numbers": numbers, "failed": run.failed, "detail": run.detail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibration reads the card; none is available", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cell = cells.load(ROOT, a.workload)
    driver = cells.driver(cell)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    rows = []

    def keep(kind: str, seed: int, got: dict) -> None:
        row = {"cell": a.workload, "kind": kind, "seed": seed, **got}
        rows.append(row)
        with open(a.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)

    for seed in a.seeds:
        t0 = time.perf_counter()
        keep("program", seed, {**program(driver, context(ROOT, cell, seed, dev)),
                               "seconds": time.perf_counter() - t0})
    low = CONTROL[cell.traffic["dtype"]]
    for seed in a.control_seeds:
        numbers, detail = driver.control(context(ROOT, cell, seed, dev), low)
        keep(f"control_{low}", seed, {"numbers": numbers, "detail": detail})
        if a.no_faults:
            continue
        for name, fault in driver.FAULTS.items():
            with fault():
                keep(f"fault_{name}", seed, program(driver, context(ROOT, cell, seed, dev)))
    for name in cell.limits:
        prog = [r["numbers"][name] for r in rows if r["kind"] == "program"]
        others = {r["kind"]: [] for r in rows if r["kind"] != "program"}
        for r in rows:
            if r["kind"] != "program":
                others[r["kind"]].append(r["numbers"][name])
        print(json.dumps({"number": name, "lower": max(prog, default=None),
                          **{k: min(v) for k, v in others.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
