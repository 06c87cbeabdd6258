"""The port's checkpoint export, non-strict loading and native format on the
CPU against the JAX package's: the reference key schema bit for bit on
every fixture, the same printed missing/unexpected reports and present
tensors in non-strict mode, the wrong-family error, and the native
directory round trip (``params.pt`` + ``native_meta.json``)."""

import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

import wadt  # noqa: F401
from wadt.engine import checkpoint as jckpt
from wadt.models import get_family as jget_family
from wadt.models import pmg as jpmg
from wadt.models import rtm as jrtm

import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
    checkpoint,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
    get_family,
    pmg,
    rtm,
)
from _torch_threads import one_torch_thread  # noqa: F401

CASES = sorted(os.path.splitext(f)[0] for f in os.listdir(FIXTURES) if f.endswith(".json"))
SKIP_SUBSTR = ("num_batches_tracked",)  # training bookkeeping, re-emitted as int64 0
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
PMG_HP = dict(ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
              transformer_layers=1, transformer_heads=2, norm="batch")


def _fixture(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    state = checkpoint.load_state_dict(os.path.join(FIXTURES, f"{name}.pth"))
    if meta["family"] == "pm":  # the loader's SE probe, as load_engine applies it
        meta["hparams"] = dict(meta["hparams"], attn_use_se=checkpoint.checkpoint_has_se(state))
    return meta, state


@pytest.mark.parametrize("name", CASES)
def test_export_roundtrip_bitexact_and_equal_to_jax(name):
    meta, orig = _fixture(name)
    family = meta["family"]
    spec = get_family(family).build_spec(meta["tasks"], meta["hparams"])
    exported = checkpoint.export_state_dict(family, checkpoint.convert(family, orig, spec), spec)
    missing = [k for k in orig if k not in exported and not any(s in k for s in SKIP_SUBSTR)]
    assert not missing, f"keys lost in round-trip: {missing[:10]}"
    for k, v in exported.items():
        if any(s in k for s in SKIP_SUBSTR):
            assert v.dtype == np.int64 and v.shape == () and v == 0, k
            continue
        assert k in orig, f"exported unknown key {k}"
        np.testing.assert_array_equal(v.astype(np.float32), orig[k].astype(np.float32),
                                      err_msg=f"{name}/{k}")
    jspec = jget_family(family).build_spec(meta["tasks"], meta["hparams"])
    jexported = jckpt.export_state_dict(family, jckpt.convert(family, orig, jspec), jspec)
    assert list(exported) == list(jexported)
    for k, v in jexported.items():
        assert exported[k].dtype == v.dtype and exported[k].shape == v.shape, k
        np.testing.assert_array_equal(exported[k], v, err_msg=f"{name}/{k} vs the JAX export")


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_exported_checkpoint_reloads_to_same_logits(suffix, tmp_path):
    name = "pmg_tiny_instance_se"
    meta, _ = _fixture(name)
    spec = pmg.build_spec(meta["tasks"], meta["hparams"])
    params = checkpoint.load_torch_checkpoint("pmg", os.path.join(FIXTURES, f"{name}.pth"), spec)
    out = str(tmp_path / f"exported{suffix}")
    checkpoint.save_torch_checkpoint("pmg", params, spec, out)
    params2 = checkpoint.load_torch_checkpoint("pmg", out, spec)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32))
    la, _ = pmg.apply(params, x, spec)
    lb, _ = pmg.apply(params2, x, spec)
    assert torch.equal(la, lb)


def test_save_torch_checkpoint_from_bf16_params(tmp_path):
    spec = pmg.build_spec(TASKS, PMG_HP)
    params = pmg.init(torch.Generator().manual_seed(0), spec)
    bf16 = Engine("pmg", spec, params, batch_size=2, dtype=torch.bfloat16, device="cpu")._run_params
    out = str(tmp_path / "bf16.pth")
    checkpoint.save_torch_checkpoint("pmg", bf16, spec, out)
    state = torch.load(out, weights_only=True)
    assert state["token_proj.weight"].dtype == torch.float32
    torch.testing.assert_close(state["token_proj.weight"], bf16["token_proj"]["w"].float().T,
                               atol=0, rtol=0)
    # the reference's BatchNorm counter: a 0-d int64 tensor, so the export
    # reloads non-strict without a shape mismatch
    nbt = state["feature_extractor.1.num_batches_tracked"]
    assert nbt.dtype == torch.int64 and nbt.shape == () and int(nbt) == 0
    checkpoint.load_torch_checkpoint("pmg", out, spec, strict=False)


def _jax_full_state(family, hp, seed):
    import jax

    mod = {"pmg": jpmg, "rtm": jrtm}[family]
    jspec = mod.build_spec(TASKS, hp)
    full = jckpt.export_state_dict(family, mod.init(jax.random.PRNGKey(seed), jspec), jspec)
    return jspec, full


def _both_nonstrict(family, hp, state, capsys):
    """(JAX params, its printed report, port params, its printed report)."""
    jspec = {"pmg": jpmg, "rtm": jrtm}[family].build_spec(TASKS, hp)
    spec = get_family(family).build_spec(TASKS, hp)
    capsys.readouterr()
    jparams = jckpt.convert(family, state, jspec, strict=False)
    jout = capsys.readouterr().out
    params = checkpoint.convert(family, state, spec, strict=False)
    out = capsys.readouterr().out
    return jspec, jparams, jout, spec, params, out


def test_nonstrict_fills_missing_keys_like_jax(capsys):
    _, full = _jax_full_state("pmg", PMG_HP, 5)
    partial = {k: v for k, v in full.items() if not k.startswith("token_proj")}
    partial["some.unknown.key"] = np.zeros(3, np.float32)
    spec = pmg.build_spec(TASKS, PMG_HP)
    with pytest.raises(KeyError):
        checkpoint.convert("pmg", partial, spec, strict=True)
    jspec, jparams, jout, spec, params, out = _both_nonstrict("pmg", PMG_HP, partial, capsys)
    assert "Missing keys (2)" in out and "Unexpected keys (1)" in out
    assert out == jout
    # present tensors bit for bit; the missing ones from the port's own init
    got = checkpoint.export_state_dict("pmg", params, spec)
    want = jckpt.export_state_dict("pmg", jparams, jspec)
    for k in full:
        if not k.startswith("token_proj"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    init = pmg.init(torch.Generator().manual_seed(0), spec)
    assert torch.equal(params["token_proj"]["w"], init["token_proj"]["w"])
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32))
    logits, _ = pmg.apply(params, x, spec)
    assert torch.isfinite(logits).all()


def test_nonstrict_init_key_seeds_the_missing_tensors():
    _, full = _jax_full_state("pmg", PMG_HP, 5)
    partial = {k: v for k, v in full.items() if not k.startswith("classifiers.")}
    spec = pmg.build_spec(TASKS, PMG_HP)
    a = checkpoint.convert("pmg", partial, spec, strict=False, init_key=3)
    b = checkpoint.convert("pmg", partial, spec, strict=False, init_key=3)
    c = checkpoint.convert("pmg", partial, spec, strict=False, init_key=4)
    assert torch.equal(a["heads"]["w"], b["heads"]["w"])
    assert not torch.equal(a["heads"]["w"], c["heads"]["w"])
    assert torch.equal(a["queries"], c["queries"])  # present: from the checkpoint


@pytest.mark.parametrize("form", ["backbone", "raw"])
def test_nonstrict_rtm_canonicalizes_backbone_aliases_like_jax(form, capsys):
    hp = dict(truncate_layer=5, use_attention=True, attn_token_dim=8)
    _, full = _jax_full_state("rtm", hp, 7)
    aliased = {}
    for k, v in full.items():
        if k.startswith("truncated_encoder."):
            seq, _, tail = k[len("truncated_encoder."):].partition(".")
            root = checkpoint._SEQ_TO_NAME[int(seq)]
            aliased[f"backbone.{root}.{tail}" if form == "backbone" else f"{root}.{tail}"] = v
        else:
            aliased[k] = v
    aliased.pop("attentions.attention_A.q")
    jspec, jparams, jout, spec, params, out = _both_nonstrict("rtm", hp, aliased, capsys)
    assert out == jout and "Missing keys (1)" in out
    assert "truncated_encoder" not in out.split("Unexpected keys")[-1]
    got = checkpoint.export_state_dict("rtm", params, spec)
    want = jckpt.export_state_dict("rtm", jparams, jspec)
    for k in full:
        if k != "attentions.attention_A.q":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_nonstrict_rtm_classifier_partial_copy_like_jax(capsys):
    hp = dict(truncate_layer=5, use_attention=False)
    _, full = _jax_full_state("rtm", hp, 9)
    bad = dict(full)
    w = bad["classifiers.classifier_A.0.weight"]
    bad["classifiers.classifier_A.0.weight"] = np.concatenate([w, w[:1]])  # one row too many
    bad.pop("classifiers.classifier_B.0.bias")
    jspec, jparams, jout, spec, params, out = _both_nonstrict("rtm", hp, bad, capsys)
    assert out == jout
    np.testing.assert_array_equal(
        checkpoint.export_state_dict("rtm", params, spec)["classifiers.classifier_A.0.weight"],
        jckpt.export_state_dict("rtm", jparams, jspec)["classifiers.classifier_A.0.weight"])


def test_nonstrict_shape_mismatch_errors_like_jax():
    hp = dict(truncate_layer=5, use_attention=False)
    jspec, full = _jax_full_state("rtm", hp, 8)
    bad = dict(full)
    bad["truncated_encoder.0.weight"] = np.zeros((8, 3, 7, 7), np.float32)
    with pytest.raises(ValueError, match="shape mismatch") as want:
        jckpt.convert("rtm", bad, jspec, strict=False)
    with pytest.raises(ValueError, match="shape mismatch") as got:
        checkpoint.convert("rtm", bad, rtm.build_spec(TASKS, hp), strict=False)
    assert str(got.value) == str(want.value)


def test_wrong_family_names_the_schema_like_jax():
    meta, state = _fixture("rtm_trunc5_attn")
    hp = dict(PMG_HP)
    jspec = jpmg.build_spec(meta["tasks"], hp)
    spec = pmg.build_spec(meta["tasks"], hp)
    with pytest.raises(ValueError, match="matches RTM") as want:
        jckpt.convert("pmg", state, jspec)
    with pytest.raises(ValueError, match="matches RTM") as got:
        checkpoint.convert("pmg", state, spec)
    assert str(got.value) == str(want.value)
    # load_torch_checkpoint(strict=False) does not fall back on a wrong family
    with pytest.raises(ValueError, match="matches RTM"):
        checkpoint.load_torch_checkpoint("pmg", os.path.join(FIXTURES, "rtm_trunc5_attn.pth"),
                                         spec, strict=False)


def test_load_torch_checkpoint_nonstrict_falls_back(tmp_path, capsys):
    _, full = _jax_full_state("pmg", PMG_HP, 5)
    partial = {k: torch.from_numpy(np.array(v, order="C")) for k, v in full.items()
               if not k.startswith("token_proj")}
    path = str(tmp_path / "partial.pth")
    torch.save(partial, path)
    spec = pmg.build_spec(TASKS, PMG_HP)
    with pytest.raises(KeyError):
        checkpoint.load_torch_checkpoint("pmg", path, spec)
    params = checkpoint.load_torch_checkpoint("pmg", path, spec, strict=False)
    out = capsys.readouterr().out
    assert "falling back to strict=False" in out and "Missing keys (2)" in out
    assert params["token_proj"]["w"].shape == (16 * 16, 32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


@pytest.mark.parametrize("with_like", [False, True])
def test_native_roundtrip(tmp_path, with_like):
    spec = pmg.build_spec(TASKS, PMG_HP)
    params = pmg.init(torch.Generator().manual_seed(2), spec)
    path = str(tmp_path / "native")
    checkpoint.save_native(params, path)
    assert sorted(os.listdir(path)) == ["native_meta.json", "params.pt"]
    with open(os.path.join(path, "native_meta.json")) as f:
        meta = json.load(f)
    assert meta["format_version"] == 1
    assert meta["manifest"]["token_proj/w"] == {"shape": [256, 32], "dtype": "float32"}
    like = pmg.init(torch.Generator().manual_seed(0), spec) if with_like else None
    back = checkpoint.load_native(path, like=like)
    got, want = _leaves(back), _leaves(params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_native_mismatch_raises(tmp_path):
    spec = pmg.build_spec(TASKS, PMG_HP)
    path = str(tmp_path / "native")
    checkpoint.save_native(pmg.init(torch.Generator().manual_seed(2), spec), path)
    other = pmg.build_spec(TASKS, dict(PMG_HP, d_model=64))
    with pytest.raises(ValueError, match="does not match `like`"):
        checkpoint.load_native(path, like=pmg.init(torch.Generator().manual_seed(0), other))
    fewer = pmg.build_spec(TASKS, dict(PMG_HP, use_token_attention=False))
    with pytest.raises(ValueError, match="missing"):
        checkpoint.load_native(path, like=pmg.init(torch.Generator().manual_seed(0), fewer))
    with open(os.path.join(path, "native_meta.json")) as f:
        meta = json.load(f)
    meta["manifest"]["token_proj/w"]["shape"] = [1, 1]
    with open(os.path.join(path, "native_meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="its manifest"):
        checkpoint.load_native(path)


def test_load_engine_native_directory(tmp_path):
    eng = port.load_engine("pmg", tasks=TASKS, hparams=PMG_HP, batch_size=2, device="cpu")
    spec = eng.spec
    params = pmg.init(torch.Generator().manual_seed(11), spec)
    path = str(tmp_path / "native")
    checkpoint.save_native(params, path)
    loaded = port.load_engine("pmg", path, TASKS, PMG_HP, batch_size=2, device="cpu")
    want = Engine("pmg", spec, params, batch_size=2, device="cpu")
    frames = np.random.RandomState(0).randint(0, 256, (3, 64, 64, 3), np.uint8)
    np.testing.assert_array_equal(loaded.run(frames)["probs"], want.run(frames)["probs"])


def test_jax_orbax_directory_is_refused(tmp_path):
    import jax

    jspec = jpmg.build_spec(TASKS, PMG_HP)
    path = str(tmp_path / "orbax")
    jckpt.save_native(jpmg.init(jax.random.PRNGKey(0), jspec), path)
    with pytest.raises(ValueError, match="Orbax.*save_torch_checkpoint"):
        port.load_engine("pmg", path, TASKS, PMG_HP, device="cpu")
