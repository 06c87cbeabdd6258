"""The benchmark's PM configuration on the CPU: the plain reference
(``port_bench/reference/pm.py``) equals the toolkit's golden logits, the
port's ``Engine.run`` equals the reference on seeded weights at a small
size and at the headline widths, the FLOP count equals a hand count, and a
tiny PM cell runs correct through ``port_bench.run.execute`` while each
planted fault makes it incorrect.

The whole runs go through a subprocess in a temporary checkout: this
process has JAX loaded (``tests/conftest.py``), which ``run.execute``
refuses."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
    checkpoint,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    Engine,
)
from port_bench import weights
from port_bench.drivers import engine_run
from port_bench.families import pm as fam_pm
from port_bench.reference import pm as ref_pm
from port_bench.reference.common import normalize
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
HEADLINE = "pm_headline.infer_f32"
TASKS = {"Weather Type": ["Clear", "Rain", "Snow", "Fog"], "Visibility": ["Low", "Good"],
         "Light Conditions": ["Day", "Night", "Dusk"]}
SMALL = {"ndf": 8, "norm": "instance", "patch_size": 40, "attn_tau": 0.7, "attn_use_se": True,
         "attn_softmax_spatial": True, "ablate_attention": False}
VARIANTS = {"instance_se": {}, "no_se": {"attn_use_se": False},
            "ablate": {"ablate_attention": True},
            "batch_sigmoid": {"norm": "batch", "attn_softmax_spatial": False}}
TINY_CELL = "pm_tiny.infer_tiny"


def _bench_json(*parts: str) -> dict:
    with open(os.path.join(REPO, "port_bench", *parts)) as f:
        return json.load(f)


def _headline_cfg() -> dict:
    return _bench_json("configs", "pm_headline.json")


# -- the reference ------------------------------------------------------------


@pytest.mark.parametrize("name", ["pm_small", "pm_no_se", "pm_ablate", "pm_batchnorm_sigmoid",
                                  "pm_deep_plan"])
def test_reference_equals_golden_logits(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    cfg = {"hparams": meta["hparams"], "tasks": meta["tasks"]}
    sd = {k: v.float() for k, v in torch.load(os.path.join(FIXTURES, f"{name}.pth"),
                                              weights_only=True).items()
          if v.is_floating_point()}
    shapes = ref_pm.state_shapes(cfg)
    assert set(sd) == set(shapes)
    assert all(tuple(sd[k].shape) == s for k, s in shapes.items())
    z = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    with torch.no_grad():
        got = ref_pm.forward(sd, torch.from_numpy(z["input"]).float(), cfg)
    for t in cfg["tasks"]:
        np.testing.assert_allclose(got[t].numpy(), z[f"logits/{t}"], atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", [*VARIANTS, "headline"])
def test_port_engine_equals_reference_on_seeded_weights(case):
    """The benchmark's own route on the CPU: weights drawn by
    ``weights.seeded`` in the toolkit's keys, loaded by ``convert`` as a
    user loads a checkpoint, run through ``Engine.run`` on uint8 frames."""
    if case == "headline":
        cfg, side, n = _headline_cfg(), 224, 2
    else:
        cfg, side, n = {"hparams": {**SMALL, **VARIANTS[case]}, "tasks": TASKS}, 64, 5
    sd = weights.seeded(ref_pm.state_shapes(cfg), 2 ** 33 + 7, "cpu")
    spec = fam_pm.port_spec(cfg)
    params = checkpoint.convert("pm", {k: v.numpy() for k, v in sd.items()}, spec)
    eng = Engine("pm", spec, params, batch_size=2, device="cpu")
    frames = np.random.default_rng(3).integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    port = eng.run(frames, collect=("logits",))["logits"]
    with torch.no_grad():
        want = ref_pm.forward(sd, normalize(torch.from_numpy(frames)), cfg)
    for i, (t, classes) in enumerate(cfg["tasks"].items()):
        np.testing.assert_allclose(port[:, i, :len(classes)], want[t].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=t)


# -- counts -------------------------------------------------------------------


def test_headline_flops_equal_a_hand_count():
    cfg = _headline_cfg()
    # (output side, cout, cin) of each 4 x 4 convolution: 224 -> 112 -> 56 -> 28 -> 14 -> 13
    convs = [(112, 64, 3), (56, 128, 64), (28, 256, 128), (14, 512, 256), (13, 1024, 512)]
    trunk = sum(s * s * co * ci * 16 for s, co, ci in convs)
    assert trunk == 2_689_335_296  # 2.69 G multiply-adds an image
    c, hw, t = 1024, 13 * 13, 12
    heads = t * (2 * c * (c // 16) + 2 * hw * c) + 52 * c  # SE, logits and pooling; 52 classes
    assert sum(len(v) for v in cfg["tasks"].values()) == 52
    assert fam_pm.forward_flops(cfg, 3) == 2.0 * (trunk + heads) * 3
    small = {"img_size": 64, "tasks": TASKS, "hparams": {**SMALL, "ablate_attention": True}}
    # 64 -> 32 -> 16 -> 8 -> 4 (3 -> 8 -> 16 -> 32 -> 64), then 3 x 3 at 128; GAP and classes
    trunk = (32 * 32 * 8 * 3 + 16 * 16 * 16 * 8 + 8 * 8 * 32 * 16 + 4 * 4 * 64 * 32
             + 3 * 3 * 128 * 64) * 16
    assert fam_pm.forward_flops(small, 1) == 2.0 * (trunk + 3 * 9 * 128 + 9 * 128)


# -- whole runs of a tiny cell ------------------------------------------------

_RUNS = """
import sys
import torch
from port_bench import run
from port_bench.drivers import engine_run

root, cell = sys.argv[1], sys.argv[2]
cpu = torch.device("cpu")
for trace in (False, True):
    assert run.execute(root, cell, 2 ** 31 + 41, 0.3, trace, device=cpu) == 0
for fault in engine_run.FAULTS:
    with engine_run.FAULTS[fault]():
        assert run.execute(root, cell, 2 ** 32 + 3, 0.2, False, device=cpu) == 0
"""


def _tiny_checkout(root: str) -> None:
    """A copy of ``port_bench/`` and ``BENCHMARK.json`` with a tiny PM
    cell, added as files and entries only, reporting what the headline
    cell reports and held to its limits."""
    shutil.copytree(os.path.join(REPO, "port_bench"), os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = {**_headline_cfg(), "name": "pm_tiny", "img_size": 64, "tasks": TASKS,
           "hparams": SMALL}
    files = {"configs/pm_tiny.json": cfg,
             "traffic/infer_tiny.json": {"driver": "engine_run", "dtype": "float32",
                                         "batch": 4, "pool": 8, "frames_per_call": 16,
                                         "scan_chunk": "off", "prob_threshold": 0.5,
                                         "traced_calls": 2},
             f"limits/{TINY_CELL}.json": _bench_json("limits", f"{HEADLINE}.json")}
    for path, obj in files.items():
        with open(os.path.join(root, "port_bench", path), "w") as f:
            json.dump(obj, f)
    bench["workloads"].append({"name": TINY_CELL, "config": "pm_tiny", "traffic": "infer_tiny",
                               "chips": 1, "why": "a tiny copy for the CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if HEADLINE in m.get("workloads", ()):
            m["workloads"].append(TINY_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The result lines of the tiny cell's runs, in one process without
    JAX: untraced, traced, then one untraced run under each planted
    fault."""
    root = str(tmp_path_factory.mktemp("pm_checkout"))
    _tiny_checkout(root)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, REPO])}
    out = subprocess.run([sys.executable, "-c", _RUNS, root, TINY_CELL], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(s) for s in out.stdout.splitlines() if s.startswith("{")]
    names = ["plain", "traced", *(f"fault_{f}" for f in engine_run.FAULTS)]
    assert len(lines) == len(names), out.stdout[-3000:]
    return dict(zip(names, lines))


@pytest.mark.parametrize("name", ["plain", "traced"])
def test_a_tiny_pm_run_is_correct(tiny_runs, name):
    res = tiny_runs[name]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"answer_gap"}
    got = res["metrics"]
    if name == "plain":
        assert got["img_s"]["value"] > 0 and got["setup_s"]["value"] > 0
    else:
        # the program's spans read on the CPU; the device metrics need a card
        assert {"fwd_ms.infer", "trunk_ms.infer", "norm_ms.infer"} <= set(got)
        assert 0 < got["norm_ms.infer"]["value"] < got["trunk_ms.infer"]["value"]
        assert got["trunk_ms.infer"]["value"] < got["fwd_ms.infer"]["value"]


@pytest.mark.parametrize("fault", sorted(engine_run.FAULTS))
def test_a_planted_fault_makes_the_tiny_pm_run_incorrect(tiny_runs, fault):
    res = tiny_runs[f"fault_{fault}"]
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_the_tf32_control_fails_the_tiny_pm_cell_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card: the CPU has no TF32")
    from port_bench import cells, run

    _tiny_checkout(str(tmp_path))
    cell = cells.load(str(tmp_path), TINY_CELL)
    for seed in (1, 2, 3):
        ctx = run.context(str(tmp_path), cell, seed, torch.device("cuda", 0))
        got, _ = engine_run.control(ctx, "tf32")
        assert got["answer_gap"] > ctx.limits["answer_gap"], got
