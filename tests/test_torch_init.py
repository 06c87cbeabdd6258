"""Random init and ``load_engine`` without a checkpoint: the port's
``pmg.init`` tree has the JAX package's structure, shapes and dtypes (the
values differ, the generators do), every family's engine runs from random
params, and the parameter counts equal the JAX package's."""

import os

import numpy as np
import pytest
import torch

import wadt  # noqa: F401
from wadt.models import pm as jpm
from wadt.models import pmg as jpmg
from wadt.models import rtm as jrtm
from wadt.utils import reporting as jreporting

import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import models
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm, pmg, rtm
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import reporting
from _torch_threads import one_torch_thread  # noqa: F401

TASKS = {"A": ["x", "y", "z"], "B": ["p", "q"]}
PMG = dict(ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
           transformer_layers=2, transformer_heads=2, norm="batch")
HPARAMS = {"pmg": PMG, "pm": dict(ndf=8, patch_size=16),
           "rtm": dict(truncate_layer=5, use_attention=True, attn_token_dim=16)}
JAX_MODS = {"pmg": jpmg, "pm": jpm, "rtm": jrtm}
PORT_MODS = {"pmg": pmg, "pm": pm, "rtm": rtm}


def _tree_layout(tree, path=""):
    """[(path, shape, dtype name)] of every leaf, in the tree's own order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _tree_layout(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _tree_layout(v, f"{path}[{i}]")]
    dtype = str(tree.dtype).replace("torch.", "")
    return [(path, tuple(tree.shape), dtype)]


def _jax_init(family, hparams, seed=0):
    import jax

    jspec = JAX_MODS[family].build_spec(TASKS, hparams)
    return jspec, JAX_MODS[family].init(jax.random.PRNGKey(seed), jspec)


@pytest.mark.parametrize("se", [False, True])
@pytest.mark.parametrize("transformer", [True, False])
def test_pmg_init_tree_matches_jax(se, transformer):
    hp = dict(PMG, use_channel_attention=se, use_token_attention=transformer)
    _, jparams = _jax_init("pmg", hp)
    spec = pmg.build_spec(TASKS, hp)
    params = pmg.init(torch.Generator().manual_seed(0), spec)
    assert _tree_layout(params) == _tree_layout(jparams)
    assert ("se" in params) == se and ("transformer" in params) == transformer
    if se:
        assert set(params["se"]["fc1"]) == {"w"}  # bias-free SE
    assert all("b" not in blk["conv"] for blk in params["trunk"])  # bias-free trunk
    if transformer:
        attn = params["transformer"][0]["attn"]
        assert all(float(attn[n].abs().sum()) == 0.0 for n in ("bq", "bk", "bv", "bo"))
        assert params["transformer"][0]["ffn1"]["w"].shape == (32, 64)
    # heads zero-padded to Kmax
    assert float(params["heads"]["w"][1, :, 2:].abs().sum()) == 0.0
    assert float(params["heads"]["b"][1, 2:].abs().sum()) == 0.0
    again = pmg.init(torch.Generator().manual_seed(0), spec)
    assert torch.equal(again["token_proj"]["w"], params["token_proj"]["w"])


@pytest.mark.parametrize("family", ["pmg", "pm", "rtm"])
def test_init_tree_and_counts_match_jax(family, capsys):
    hp = HPARAMS[family]
    jspec, jparams = _jax_init(family, hp)
    spec = models.build_spec(family, TASKS, hp)
    assert spec == PORT_MODS[family].build_spec(TASKS, hp)
    params = PORT_MODS[family].init(torch.Generator().manual_seed(0), spec)
    assert _tree_layout(params) == _tree_layout(jparams)
    assert reporting.count(params) == jreporting.count(jparams)
    want = jreporting.print_model_parameters(family, jparams, jspec)
    want_out = capsys.readouterr().out
    assert reporting.print_model_parameters(family, params, spec) == want
    assert capsys.readouterr().out == want_out
    if family == "pmg":
        assert pmg.count_params(params) == jpmg.count_params(jparams)


@pytest.mark.parametrize("family", ["pmg", "pm", "rtm"])
def test_load_engine_without_checkpoint_runs(family):
    eng = port.load_engine(family, tasks=TASKS, hparams=HPARAMS[family], batch_size=2, device="cpu")
    want = PORT_MODS[family].init(torch.Generator().manual_seed(0), eng.spec)
    assert _tree_layout(eng.params) == _tree_layout(want)
    frames = np.random.RandomState(0).randint(0, 256, (3, 64, 64, 3), np.uint8)
    out = eng.run(frames, collect=("probs", "preds"))
    assert out["probs"].shape == (3, 2, 3) and out["preds"].shape == (3, 2)
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, atol=1e-5)
    # seeded: a second engine gives the same results
    again = port.load_engine(family, "", TASKS, HPARAMS[family], batch_size=2, device="cpu")
    np.testing.assert_array_equal(again.run(frames)["probs"], out["probs"])


def test_load_engine_native_directory_names_the_roadmap(tmp_path):
    """A directory is a native checkpoint now (ROADMAP.md A15, done): one
    without the native files is refused by name."""
    os.makedirs(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="not a native checkpoint directory"):
        port.load_engine("pmg", str(tmp_path / "ckpt"), TASKS, PMG, device="cpu")


def test_trunk_features_matches_apply_capture():
    spec = pmg.build_spec(TASKS, PMG)
    params = pmg.init(torch.Generator().manual_seed(1), spec)
    x = torch.randn(2, 32, 32, 3)
    _, aux = pmg.apply(params, x, spec, capture=("features",))
    assert torch.equal(pmg.trunk_features(params, x, spec), aux["features"])
