"""The benchmark's harness on the CPU: every name resolves to its file, a
cell added as files only is found, traffic repeats for a seed, the FLOP and
byte counts equal hand counts, the references equal the port and the
toolkit's golden logits, whole runs of tiny cells come out correct, and
each planted fault and the fp8 control make them come out incorrect.

    python -m pytest port_bench/tests -q

Tests marked ``cuda`` need a card and skip without one.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from port_bench import cells, run, weights
from port_bench.drivers import engine_run, train_step
from port_bench.families import pmg as fam_pmg
from port_bench.families import rtm as fam_rtm
from port_bench.reference import pmg as ref_pmg
from port_bench.reference import rtm as ref_rtm
from port_bench.reference.common import normalize
from port_bench.trace import WINDOW, Spans, profile, reduce
from port_bench.yardstick import stream_seed

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CPU = torch.device("cpu")


def _bench(root=REPO):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _ctx(root, cell_name, seed=5):
    return run.context(root, cells.load(root, cell_name), seed, CPU)


# -- names resolve ------------------------------------------------------------


def test_benchmark_json_keeps_to_its_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["port_bench"] and 1 <= b["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in b[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and os.path.isfile(os.path.join(REPO, c["file"]))
    reported = {}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        reported[w["name"]] = {m["name"] for m in b["end_to_end"]
                               if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported[w["name"]] and len(reported[w["name"]]) >= 2
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert all(m["moves"] in reported[w] for w in m["workloads"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_named_file_resolves(cell):
    c = cells.load(REPO, cell)
    fam = c.config["family"]
    for part in (f"families/{fam}.py", f"reference/{fam}.py",
                 f"drivers/{c.traffic['driver']}.py"):
        assert os.path.isfile(os.path.join(REPO, "port_bench", part)), part
    assert c.limits and c.per_layer
    for m in c.per_layer:
        assert callable(cells.reader(REPO, m["name"]))
    ref = ref_pmg if fam == "pmg" else ref_rtm
    assert ref.state_shapes(c.config)


def test_a_cell_and_a_metric_added_as_files_only_are_found(tiny_root):
    with open(os.path.join(tiny_root, "port_bench", "layer_metrics", "steps_per_s.tiny.py"),
              "w") as f:
        f.write("def read(t):\n    return t.items['steps'] / t.window_s\n")
    b = _bench(tiny_root)
    b["per_layer"].append({"name": "steps_per_s.tiny", "unit": "1/s", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "train_img_s", "workloads": ["pmg_tiny.train_tiny"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    c = cells.load(tiny_root, "pmg_tiny.train_tiny")
    assert c.config["hparams"]["ndf"] == 8 and c.traffic["batch"] == 8
    names = [m["name"] for m in c.per_layer]
    assert "steps_per_s.tiny" in names and "step_ms.train" in names
    tr = types.SimpleNamespace(items={"steps": 4}, window_s=2.0, busy_s=1.5)
    assert cells.reader(tiny_root, "steps_per_s.tiny")(tr) == 2.0
    # a quantity split by what it moves reads the quantity's own file
    assert cells.reader(tiny_root, "idle_pct.tiny")(tr) == 25.0
    assert cells.driver(c) is train_step
    with pytest.raises(KeyError):
        cells.load(tiny_root, "no_such.cell")


# -- traffic ------------------------------------------------------------------


def test_traffic_repeats_for_a_seed(tiny_root):
    ctx = _ctx(tiny_root, "pmg_tiny.train_tiny")
    big = 2 ** 31 + 977
    a, b, c = (train_step.Feed(ctx.cfg, ctx.traffic, s, CPU) for s in (big, big, big + 1))
    assert np.array_equal(a.pool, b.pool) and np.array_equal(a.labels, b.labels)
    assert not np.array_equal(a.pool, c.pool)
    for _ in range(7):  # across epochs
        assert np.array_equal(a.next(), b.next())
    ignored = (a.labels == -100).mean()
    assert 0.0 < ignored < 0.3 and a.labels.max() < 4
    assert stream_seed(big, "frames") != stream_seed(big, "labels")
    assert stream_seed(-3, "frames") == stream_seed(-3, "frames")


# -- counts -------------------------------------------------------------------


def test_pmg_flops_and_k1_bound_equal_hand_counts():
    cfg = {"img_size": 32, "tasks": {"a": [0, 1], "b": [0, 1, 2]},
           "hparams": {"ndf": 8, "patch_size": 16, "patch_div": 2, "gram_channels": 8,
                       "d_model": 16, "transformer_layers": 1, "transformer_heads": 2,
                       "norm": "batch", "use_token_attention": True,
                       "use_channel_attention": False}}
    # trunk 32 -> 8 (3 -> 8, k4), 8 x 8 (8 -> 16, 1x1); chan_proj 16 -> 8; 4 patches of 16
    macs = 8 * 8 * 8 * 3 * 16 + 8 * 8 * 16 * 8 + 8 * 8 * 8 * 16
    macs += 4 * 16 * 64 + 4 * 64 * 16  # Grams, token_proj
    macs += 8 * 4 * 16 * 16 + 2 * 4 * 4 * 16  # one transformer layer
    macs += 2 * 2 * 4 * 16 + 5 * 16  # pooling, heads
    assert fam_pmg.forward_flops(cfg, 3) == 2.0 * macs * 3
    with open(os.path.join(REPO, "port_bench", "configs", "pmg_shipped.json")) as f:
        shipped = json.load(f)
    nbytes = 4 * (256 * 14 * 14 * 96 + 256 * 9 * 96 * 96)
    assert math.isclose(fam_pmg.patch_gram_bound(shipped, 256, "float32"), nbytes / 3.35e12)


def _conv_macs(ref, cfg, side):
    """Multiply-adds of every convolution the reference forward runs."""
    import torch.nn.functional as F

    total, orig = [0], F.conv2d

    def counting(x, w, *a, **k):
        y = orig(x, w, *a, **k)
        total[0] += y.numel() // y.shape[0] * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    sd = {k: torch.zeros(s) for k, s in ref.state_shapes(cfg).items()}
    F.conv2d = counting
    try:
        with torch.no_grad():
            ref.features(sd, torch.zeros(1, 3, side, side), cfg)
    finally:
        F.conv2d = orig
    return total[0]


def test_rtm_flops_equal_the_counted_convolutions():
    cfg = cells.load(REPO, "rtm_resnet50.infer_bf16").config
    conv = _conv_macs(ref_rtm, cfg, 224)
    assert 4.08e9 < conv < 4.12e9  # ResNet-50's published ~4.1 GMACs less its fc
    n, c, t = 49, 2048, len(cfg["tasks"])
    heads = t * (2 * n * c + 2 * c * c) + sum(len(v) for v in cfg["tasks"].values()) * c
    assert fam_rtm.forward_flops(cfg, 2) == 2.0 * (conv + heads) * 2


@pytest.mark.parametrize("config", ["pmg_tiny", "rtm_tiny"])
def test_leaf_maps_cover_the_port_tree_with_reference_tensors(tiny_root, config):
    from importlib import import_module

    with open(os.path.join(tiny_root, "port_bench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    fam = fam_pmg if cfg["family"] == "pmg" else fam_rtm
    ref = ref_pmg if cfg["family"] == "pmg" else ref_rtm
    shapes, leaf_map = ref.state_shapes(cfg), fam.leaf_map(cfg)
    sd = {k: v.numpy() for k, v in weights.seeded(shapes, 0, "cpu").items()}
    params = import_module(f"{PORT}.engine.checkpoint").convert(cfg["family"], sd,
                                                                 fam.port_spec(cfg))
    port = dict(train_step._leaves(params))
    assert set(leaf_map) == set(port)
    for leaf, parts in leaf_map.items():
        n = sum(math.prod(shapes[k]) if rows is None else (rows[1] - rows[0]) * math.prod(
            shapes[k][1:]) for k, rows in parts)
        padded = port[leaf].numel() if leaf not in ("heads/w", "heads/b", "final/w", "final/b") \
            else n
        assert n == padded, leaf


# -- references ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["pmg_tiny_instance_se", "rtm_trunc5_attn", "pmg_shipped"])
def test_reference_equals_golden_logits_and_the_port(name):
    from importlib import import_module

    load_engine = import_module(PORT).load_engine
    fx = os.path.join(REPO, "tests", "fixtures")
    with open(os.path.join(fx, f"{name}.json")) as f:
        meta = json.load(f)
    cfg = {"hparams": meta["hparams"], "tasks": meta["tasks"]}
    ref = ref_pmg if meta["family"] == "pmg" else ref_rtm
    sd = {k: v.float() for k, v in torch.load(os.path.join(fx, f"{name}.pth"),
                                              weights_only=True).items()
          if v.is_floating_point()}
    assert set(sd) == set(ref.state_shapes(cfg))
    z = np.load(os.path.join(fx, f"{name}.npz"))
    with torch.no_grad():
        got = ref.forward(sd, torch.from_numpy(z["input"]).float(), cfg)
    for t in cfg["tasks"]:
        if f"logits/{t}" in z.files:
            np.testing.assert_allclose(got[t].numpy(), z[f"logits/{t}"], atol=2e-5, rtol=0)
    eng = load_engine(meta["family"], os.path.join(fx, f"{name}.pth"), meta["tasks"],
                      meta["hparams"], device="cpu", batch_size=4)
    frames = np.random.default_rng(0).integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)
    port = eng.run(frames, collect=("logits",))["logits"]
    with torch.no_grad():
        want = ref.forward(sd, normalize(torch.from_numpy(frames)), cfg)
    for i, t in enumerate(cfg["tasks"]):
        k = len(cfg["tasks"][t])
        np.testing.assert_allclose(port[:, i, :k], want[t].numpy(), atol=1e-4, rtol=1e-4)


# -- whole runs on the CPU ----------------------------------------------------

CELLS = ["pmg_tiny.train_tiny", "rtm_tiny.train_tiny", "rtm_tiny.infer_tiny"]
DRIVERS = {"train": train_step, "infer": engine_run}


def _run(root, cell, trace, capsys, seed=2 ** 31 + 41):
    rc = run.execute(root, cell, seed, 0.5, trace, device=CPU)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(tiny_root, cell, trace, capsys):
    res = _run(tiny_root, cell, trace, capsys)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(cells.load(tiny_root, cell).limits)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and "breakdown" in res
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        rate = "train_img_s" if "train" in cell else "img_s"
        assert res["metrics"][rate]["value"] > 0 and res["metrics"]["setup_s"]["value"] > 0


FAULTS = [(c, f) for c in CELLS for f in DRIVERS[c.split(".")[1].split("_")[0]].FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(tiny_root, cell, fault, capsys):
    with cells.driver(cells.load(tiny_root, cell)).FAULTS[fault]():
        res = _run(tiny_root, cell, False, capsys)
    assert res["correct"] is False, res["checks"]


def test_the_fp8_control_fails_the_tiny_inference_cell(tiny_root):
    for seed in (1, 2, 3):
        ctx = _ctx(tiny_root, "rtm_tiny.infer_tiny", seed)
        got, _ = engine_run.control(ctx, "fp8")
        assert got["answer_gap"] > ctx.limits["answer_gap"], got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pmg_tiny.train_tiny", "rtm_tiny.train_tiny"])
def test_the_tf32_control_fails_the_train_cell_on_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card: the CPU has no TF32")
    for seed in (1, 2, 3):
        ctx = _ctx(tiny_root, cell, seed)
        ctx.device = torch.device("cuda", 0)
        got, _ = train_step.control(ctx, "tf32")
        assert any(got[k] > ctx.limits[k] for k in got), got


@pytest.mark.parametrize("cell", ["rtm_tiny.train_tiny", "rtm_tiny.infer_tiny"])
def test_both_sides_draw_the_seeded_weights_on_the_run_device(tiny_root, cell, monkeypatch):
    """A CPU and a CUDA generator draw different weights from one seed, so
    the program's and the reference's must come from the run's device."""
    drv = cells.driver(cells.load(tiny_root, cell))
    seen = []

    def recording(cfg, root, seed, device):
        seen.append(device)
        return weights.state(cfg, root, seed, device)

    monkeypatch.setattr(drv, "load_state", recording)
    ctx = _ctx(tiny_root, cell)
    r = drv.Run(ctx)
    r.traced()
    r.check()
    assert len(seen) == 2 and all(isinstance(d, torch.device) and d == ctx.device for d in seen)


def test_answer_gap_reads_predictions():
    w = np.array([[[0.7, 0.2, 0.1], [0.45, 0.35, 0.2]]])  # [1, 2, 3]
    kmax = np.array([3, 3])
    got = engine_run._pred_gap(w, np.array([[0, -1]]), 0.5, kmax)
    assert np.allclose(got, 0.0)
    got = engine_run._pred_gap(w, np.array([[1, 0]]), 0.5, kmax)
    assert np.allclose(got, [[0.25, 0.05]])
    got = engine_run._pred_gap(w, np.array([[-1, 3]]), 0.5, kmax)
    assert np.allclose(got, [[0.2, 1.0]])


# -- the trace ----------------------------------------------------------------


def test_trace_reduces_busy_idle_and_copies():
    from torch.autograd import DeviceType

    def ev(name, dev, s, e):
        return types.SimpleNamespace(name=name, device_type=dev,
                                     time_range=types.SimpleNamespace(start=s, end=e))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    spans = Spans()
    spans.host["upload"] = [0.0]
    spans.host["step_fn"] = [0.0]
    events = [ev(WINDOW, cpu, 0, 1000), ev("upload", cpu, 0, 300), ev("step_fn", cpu, 300, 900),
              ev("Memcpy HtoD (Pageable -> Device)", cuda, 100, 300), ev("k1", cuda, 400, 600),
              ev("k2", cuda, 550, 700), ev("step_fn", cuda, 400, 700), ev("k1", cuda, 990, 1200)]
    t = reduce(events, spans, {"steps": 1})
    assert math.isclose(t.window_s, 1e-3) and math.isclose(t.busy_s, 0.51e-3)
    assert t.copies["h2d"] == [pytest.approx(2e-4)]
    assert sorted(t.kernels) == ["k1", "k2"] and len(t.kernel_s("k1")) == 2
    assert t.idle_by_span["upload"] == pytest.approx(1e-4)
    assert t.idle_by_span["step_fn"] == pytest.approx(1e-4 + 2.9e-4)
    assert "none" not in t.idle_by_span
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["device_ops"]) == 3


def test_host_spans_are_timed_outside_the_profiler():
    """The traced run's work runs twice: the spans' host-clock durations come
    from the untraced pass, the items and the device from the profiled one."""
    spans, modes = Spans(), []

    def work():
        modes.append(spans.mode)
        for _ in range(3):
            with spans("step_fn"):
                torch.ones(64).sum()
        return {"steps": 3}

    t = profile(work, spans, CPU)
    assert modes == ["clock", "profile"] and spans.mode is None
    assert len(t.host["step_fn"]) == 3 and t.items == {"steps": 3} and t.window_s > 0
    assert cells.reader(REPO, "enqueue_ms.train")(t) == pytest.approx(
        sum(t.host["step_fn"]) / 3 * 1e3)


# -- imports ------------------------------------------------------------------


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_path_loads_no_jax():
    top = _modules_after(
        "import port_bench.run, port_bench.cells, port_bench.trace, port_bench.calibrate\n"
        "import port_bench.drivers.train_step, port_bench.drivers.engine_run\n"
        "import port_bench.families.pmg, port_bench.families.rtm\n"
        f"import {PORT}.engine.checkpoint, {PORT}.engine.executor\n"
        f"import {PORT}.parallel.train, {PORT}.ops.preprocess, {PORT}.ops.cuda_kernels\n")
    assert not top & run.JAX_NAMES, top & run.JAX_NAMES
    assert PORT in top


def test_the_reference_imports_nothing_of_the_port():
    top = _modules_after("import port_bench.reference.common, port_bench.reference.pmg, "
                         "port_bench.reference.rtm")
    assert PORT not in top and not top & run.JAX_NAMES
