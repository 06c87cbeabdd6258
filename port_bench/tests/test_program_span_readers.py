"""The readers of the program's spans: a tiny traced CPU run of each cell
reports the forward, backward and optimizer times that the port's tracer
recorded in the profiled pass, and the readers return nothing for a
program without the tracer (a parent checkout).

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import json
import sys

import pytest
import torch

from port_bench import cells, run

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
CPU = torch.device("cpu")
TRAIN = {"fwd_ms.train", "bwd_ms.train", "opt_ms.train"}
INFER = {"fwd_ms.infer"}


@pytest.mark.parametrize("cell,names", [("pmg_tiny.train_tiny", TRAIN),
                                        ("rtm_tiny.train_tiny", TRAIN),
                                        ("rtm_tiny.infer_tiny", INFER)])
def test_a_tiny_traced_run_reports_the_span_metrics(tiny_root, cell, names, capsys):
    rc = run.execute(tiny_root, cell, 2 ** 31 + 43, 0.5, True, device=CPU)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"] is True
    got = {k: v for k, v in res["metrics"].items() if k in TRAIN | INFER}
    assert set(got) == names
    assert all(v["unit"] == "ms" and v["value"] > 0 for v in got.values())
    if cell.endswith("infer_tiny"):
        return
    trace = __import__(f"{PORT}.utils.trace", fromlist=["trace"])
    step = trace.mean_device_ms("train.step")
    parts = sum(got[m]["value"] for m in TRAIN)
    assert parts <= step  # on the CPU each is host time, nested in the step's
    assert len([r for r in trace.records() if r.name == "train.step"]) == 4  # traced_steps


@pytest.mark.parametrize("metric", sorted(TRAIN | INFER))
def test_the_readers_give_nothing_without_the_tracer(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, f"{PORT}.utils.trace", None)  # import raises
    assert cells.reader(run.ROOT, metric)(None) is None
