"""A checkout-shaped copy of the benchmark with tiny cells, for runs on the
CPU: PMG and RTM fine-tunes and an RTM batch run at a few images a batch,
each reporting what the full-size cell it mirrors reports."""

from __future__ import annotations

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TASKS = {"Weather Type": ["Clear", "Rain", "Snow", "Fog"], "Visibility": ["Low", "Good"],
         "Light Conditions": ["Day", "Night", "Dusk"]}
CONFIGS = {
    "pmg_tiny": {"family": "pmg", "img_size": 32, "parity_precision": True,
                 "weights": {"seeded": True}, "tasks": TASKS,
                 "hparams": {"ndf": 8, "patch_size": 16, "patch_div": 2, "gram_channels": 8,
                             "d_model": 16, "transformer_layers": 1, "transformer_heads": 2,
                             "norm": "batch", "use_token_attention": True,
                             "use_channel_attention": True}},
    "rtm_tiny": {"family": "rtm", "img_size": 32, "parity_precision": True,
                 "weights": {"seeded": True}, "tasks": TASKS,
                 "hparams": {"truncate_layer": 5, "use_attention": True, "attn_token_dim": 16,
                             "cls_hidden_dims": [8], "cls_num_layers": 1}},
}
TRAFFIC = {
    "train_tiny": {"driver": "train_step", "dtype": "float32",
                   "batch": 8, "pool": 24, "ignore_share": 0.1, "lr": 3e-4,
                   "weight_decay": 1e-4, "dropout_rate": 0.0, "augment": False,
                   "checked_steps": 3, "traced_steps": 4},
    "infer_tiny": {"driver": "engine_run", "dtype": "bfloat16",
                   "batch": 4, "pool": 8, "frames_per_call": 16, "scan_chunk": "off",
                   "prob_threshold": 0.5, "traced_calls": 2},
}
# tiny cell -> (config, traffic, the full-size cell whose metrics it reports)
CELLS = {"pmg_tiny.train_tiny": ("pmg_tiny", "train_tiny", "rtm_resnet50.train_f32"),
         "rtm_tiny.train_tiny": ("rtm_tiny", "train_tiny", "rtm_resnet50.train_f32"),
         "rtm_tiny.infer_tiny": ("rtm_tiny", "infer_tiny", "rtm_resnet50.infer_bf16")}
TRAIN_LIMITS = {"loss_gap_first": 1e-5, "loss_gap_later": 1e-4, "grad_gap": 1e-4,
                "change_gap": 1e-3}
LIMITS = {"pmg_tiny.train_tiny": TRAIN_LIMITS, "rtm_tiny.train_tiny": TRAIN_LIMITS,
          "rtm_tiny.infer_tiny": {"answer_gap": 0.05}}


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of ``port_bench/`` and ``BENCHMARK.json`` whose cells are the
    tiny ones, added as files and entries only."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "port_bench"), os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, cfg in CONFIGS.items():
        write_json(os.path.join(root, "port_bench", "configs", f"{name}.json"), cfg)
    for name, tr in TRAFFIC.items():
        write_json(os.path.join(root, "port_bench", "traffic", f"{name}.json"), tr)
    for cell, (config, traffic, big) in CELLS.items():
        write_json(os.path.join(root, "port_bench", "limits", f"{cell}.json"),
                   {"numbers": {k: {"limit": v} for k, v in LIMITS[cell].items()}})
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                   "why": "a tiny copy for the CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if big in m.get("workloads", ()):
                m["workloads"].append(cell)
    write_json(os.path.join(root, "BENCHMARK.json"), bench)
    return root
