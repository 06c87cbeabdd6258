"""The port's CLI (``…_torch/cli.py``, ``weather_torch.py``) on the CPU: the
JAX CLI's flags plus ``--device``, the classifier, export and train modes
on a tiny synthetic set writing the JAX CLI's artifacts (with the explain
and style-transfer epilogues), and ``--data_parallel`` over several cards
without torchrun refusing with the command line to use.  The embedding modes (tsne,
tsne_interactive, clustering): tests/test_torch_embed.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO

import wadt  # noqa: F401
from wadt.cli import build_argparser as jax_argparser
from wadt.cli import main as jax_main

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import cli
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.export import (
    ExportedPredictor,
)

from tools.make_synth_dataset import make as make_synth
from _torch_threads import one_torch_thread  # noqa: F401

TINY = {"hparams": dict(ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
                        transformer_layers=1, transformer_heads=2, norm="batch")}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    synth = make_synth(str(root / "synth"), n_per_class=2, size=64)
    cfg = str(root / "hparams.json")
    with open(cfg, "w") as f:
        json.dump(TINY, f)
    return synth, cfg, str(root)


def _base(env):
    synth, cfg, root = env
    return ["pmg", "--build_classifier", os.path.join(synth, "tasks.json"),
            "--config_path", cfg, "--batch_size", "4"], synth, root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_parser_has_every_jax_flag_and_device():
    jax_dests = {a.dest for a in jax_argparser()._actions}
    dests = {a.dest for a in cli.build_argparser()._actions}
    assert dests == jax_dests | {"device"}
    assert cli.build_argparser().parse_args(["pmg"]).device == "cuda"
    assert set(cli.MODES) == set(dict(
        (a.dest, a.choices) for a in jax_argparser()._actions)["mode"])


def test_cli_classifier_writes_the_jax_artifacts(env):
    base, synth, root = _base(env)
    runs = {}
    for name, main, extra in (("jax", jax_main, []), ("port", cli.main, ["--device", "cpu"])):
        save = os.path.join(root, f"eval_{name}")
        exported = os.path.join(root, f"exported_{name}.pth")
        rc = main(base + ["--mode", "classifier", "--data", os.path.join(synth, "dataset.json"),
                          "--save_dir", save, "--save_test_images", "--export_torch", exported]
                  + extra)
        assert rc == 0
        runs[name] = (save, exported)
    save, exported = runs["port"]
    assert os.path.exists(os.path.join(save, "metrics_test.json"))
    groups = os.listdir(os.path.join(save, "test_images"))
    assert set(groups) <= {"Clear", "Rain", "Snow", "Fog", "Unlabeled"}
    assert sum(len(os.listdir(os.path.join(save, "test_images", g))) for g in groups) == 8
    assert os.path.getsize(exported) > 1000
    assert _files(save) == _files(runs["jax"][0])
    # the exported .pth holds the JAX CLI's key schema
    got = torch.load(exported, weights_only=True)
    want = torch.load(runs["jax"][1], weights_only=True)
    assert list(got) == list(want)
    with open(os.path.join(save, "metrics_test.json")) as f:
        got = json.load(f)
    with open(os.path.join(runs["jax"][0], "metrics_test.json")) as f:
        want = json.load(f)
    assert list(got) == list(want)


def test_cli_export_mode(env):
    base, synth, root = _base(env)
    metas = {}
    for name, main, extra in (("jax", jax_main, ["--export_platforms", "cpu"]),
                              ("port", cli.main, ["--device", "cpu"])):
        save = os.path.join(root, f"aot_{name}")
        assert main(base + ["--mode", "export", "--save_dir", save] + extra) == 0
        with open(os.path.join(save, "exported", "export_meta.json")) as f:
            metas[name] = json.load(f)
    out = os.path.join(root, "aot_port", "exported")
    assert sorted(os.listdir(out)) == ["export_meta.json", "forward.pt2"]
    jax_keys = set(metas["jax"]) - {"jax_version"}
    assert set(metas["port"]) == jax_keys | {"torch_version"}
    for k in ("family", "batch_size", "pack_k", "prob_threshold", "dtype", "outputs", "tasks"):
        assert metas["port"][k] == metas["jax"][k], k
    assert metas["port"]["platforms"] == ["cpu"]
    pred = ExportedPredictor(out, device="cpu")
    res = pred.run(np.zeros((2, 224, 224, 3), np.uint8))
    assert res["preds"].shape == (2, len(pred.task_names))


def test_cli_export_refuses_another_platform(env):
    base, _, root = _base(env)
    with pytest.raises(ValueError, match="one platform"):
        cli.main(base + ["--mode", "export", "--save_dir", os.path.join(root, "aot2"),
                         "--device", "cpu", "--export_platforms", "cpu,cuda"])


def test_cli_inference_with_compilation_cache_goes_on(env, capsys):
    base, synth, root = _base(env)
    save = os.path.join(root, "cache_run")
    rc = cli.main(base + ["--mode", "inference", "--image_folder", os.path.join(synth, "images"),
                          "--save_dir", save, "--compilation_cache", os.path.join(root, "cache"),
                          "--device", "cpu", "--data_parallel"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "--compilation_cache has no effect here" in out
    assert "single device visible" in out
    assert not os.path.exists(os.path.join(root, "cache"))


def test_cli_defaults_to_the_card(env, monkeypatch):
    """Without --device the CLI runs on the card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, synth, root = _base(env)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(base + ["--mode", "inference", "--image_folder", os.path.join(synth, "images"),
                         "--save_dir", os.path.join(root, "no_card")])


def test_cli_missing_build_classifier_is_usage_error(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["pmg", "--mode", "classifier", "--save_dir", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 2


def test_cli_classifier_explain_and_style_transfer_write_the_jax_files(env):
    """``--mode classifier`` with ``--visualize_gradcam --save_gradcam_images
    --integrated_gradients --style_transfer`` writes the JAX CLI's gradcam/,
    integrated_gradients/ and StyleTransfer/ files, with its names."""
    base, synth, root = _base(env)
    files = {}
    for name, main, extra in (("jax", jax_main, []), ("port", cli.main, ["--device", "cpu"])):
        save = os.path.join(root, f"explain_{name}")
        assert main(base + ["--mode", "classifier", "--data", os.path.join(synth, "dataset.json"),
                            "--save_dir", save, "--visualize_gradcam", "--save_gradcam_images",
                            "--integrated_gradients", "--style_transfer",
                            "--style_iterations", "2", "--num_workers", "2"] + extra) == 0
        files[name] = [f for f in _files(save)
                       if f.split(os.sep)[0] in ("gradcam", "integrated_gradients", "StyleTransfer")]
    assert files["port"] == files["jax"]
    n = 8  # images in the synthetic set
    for d in ("gradcam", "integrated_gradients", "StyleTransfer"):
        assert sum(f.startswith(d + os.sep) for f in files["port"]) == n, d
    assert any(f.startswith(os.path.join("gradcam", "gradcam_b0001_i")) for f in files["port"])


def test_cli_train_mode_writes_the_artifacts(env):
    """``--mode train`` on the CPU at the tiny spec for 1 epoch writes the
    JAX CLI's training artifacts, and the best checkpoint loads back."""
    base, synth, root = _base(env)
    save = os.path.join(root, "train")
    assert cli.main(base + ["--mode", "train", "--data", os.path.join(synth, "dataset.json"),
                            "--epochs", "1", "--num_workers", "2", "--save_dir", save,
                            "--device", "cpu"]) == 0
    assert {"best_model", "best_model.pth", "hyperparameters.json", "training_history.json",
            "last_state", "train_progress.json"} <= set(os.listdir(save))
    side = json.load(open(os.path.join(save, "hyperparameters.json")))
    assert side["hparams"]["ndf"] == 8 and side["train_options"]["epochs"] == 1
    assert len(json.load(open(os.path.join(save, "training_history.json")))) == 1
    args = cli.build_argparser().parse_args(
        base + ["--model_path", os.path.join(save, "best_model.pth"), "--device", "cpu"])
    args.prob_threshold = 0.5
    eng = cli.build_engine(args)
    out = eng.run(np.zeros((2, 64, 64, 3), np.uint8))
    assert np.isfinite(out["probs"]).all()


def test_data_parallel_over_cards_names_its_roadmap_item(env, monkeypatch):
    """One process that sees several cards raises with the torchrun command
    line, naming the deliberate difference in ROADMAP.md section C."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    base, synth, root = _base(env)
    with pytest.raises(RuntimeError, match=r"ROADMAP.md section C.*torchrun --nproc_per_node=2"):
        cli.main(base + ["--mode", "inference", "--image_folder", os.path.join(synth, "images"),
                         "--save_dir", os.path.join(root, "dp"), "--data_parallel"])


def test_launcher_and_script_entry():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "weather_torch.py", "--help"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "weather-torch" in run.stdout and "--device" in run.stdout
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert ('weather-torch = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_'
            'detection_tpu_torch.cli:main"') in text
    assert ('weather = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_'
            'detection_tpu.cli:main"') in text
