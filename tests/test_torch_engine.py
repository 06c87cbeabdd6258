"""The port's ``Engine`` on the CPU against the JAX package's ``Engine`` at
full width on the shipped checkpoint, plus its device contract: it runs on
the card unless asked for the CPU, and raises when there is no card."""

import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

import wadt  # noqa: F401
import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    enable_parity_precision,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import checkpoint as tckpt
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg as tpmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import s2d_pack
from _torch_threads import one_torch_thread  # noqa: F401

SHIPPED = os.path.join(FIXTURES, "pmg_shipped")
N = 5  # not a multiple of the batch size: the pad path runs

enable_parity_precision()


def _meta():
    with open(SHIPPED + ".json") as f:
        return json.load(f)


def _frames(n=N, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 224, 224, 3), np.uint8)


def _labels(n=N, seed=1):
    meta = _meta()
    ks = [len(v) for v in meta["tasks"].values()]
    rng = np.random.RandomState(seed)
    lab = np.stack([rng.randint(0, k, n) for k in ks], axis=1).astype(np.int32)
    lab[0, 3] = lab[2, 0] = -100  # missing labels
    return lab


@pytest.fixture(scope="module")
def shipped():
    meta = _meta()
    spec = tpmg.build_spec(meta["tasks"], meta["hparams"])
    params = tckpt.load_torch_checkpoint("pmg", SHIPPED + ".pth", spec)
    return spec, params


@pytest.fixture(scope="module")
def jax_run():
    from wadt.engine import checkpoint as jckpt
    from wadt.engine.executor import Engine as JEngine
    from wadt.models import pmg as jpmg

    meta = _meta()
    jspec = jpmg.build_spec(meta["tasks"], meta["hparams"])
    jparams = jckpt.load_torch_checkpoint("pmg", SHIPPED + ".pth", jspec)
    eng = JEngine("pmg", jspec, jparams, batch_size=4)
    return eng.run(_frames(), labels=_labels(), collect=("probs", "preds", "logits"))


def test_run_matches_jax_engine_at_full_width(shipped, jax_run):
    spec, params = shipped
    eng = Engine("pmg", spec, params, batch_size=4, device="cpu")
    assert eng.pack_k == 4
    got = eng.run(_frames(), labels=_labels(), collect=("probs", "preds", "logits"))
    np.testing.assert_allclose(got["probs"], np.asarray(jax_run["probs"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got["preds"], np.asarray(jax_run["preds"]))
    np.testing.assert_allclose(got["logits"], np.asarray(jax_run["logits"]), atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(got["count_per_task"], jax_run["count_per_task"])
    np.testing.assert_allclose(got["loss_per_task"], jax_run["loss_per_task"], atol=1e-4, rtol=1e-4)
    mask = np.asarray(got["probs"].sum(-1))
    np.testing.assert_allclose(mask, 1.0, atol=1e-5)


@pytest.mark.parametrize("variant", ["prepacked", "float_path", "dispatch_fetch"])
def test_input_layouts_and_paths_agree(shipped, jax_run, variant):
    """Pre-packed [N,56,56,48] input, the float path (packed="off") and the
    dispatch/fetch API all give the raw-input results."""
    spec, params = shipped
    frames = _frames()
    if variant == "prepacked":
        eng = Engine("pmg", spec, params, batch_size=4, device="cpu")
        packed = s2d_pack(torch.from_numpy(frames), 4).contiguous().numpy()
        got = eng.run(packed, collect=("probs", "preds"))
    elif variant == "float_path":
        eng = Engine("pmg", spec, params, batch_size=4, device="cpu", packed="off")
        assert eng.pack_k is None
        got = eng.run(frames, collect=("probs", "preds"))
    else:
        eng = Engine("pmg", spec, params, batch_size=4, device="cpu")
        handles = [eng.dispatch(frames[:4]), eng.dispatch(frames[4:])]
        parts = [eng.fetch(h) for h in handles]
        got = {k: np.concatenate([p[k] for p in parts]) for k in ("probs", "preds")}
    np.testing.assert_allclose(got["probs"], np.asarray(jax_run["probs"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got["preds"], np.asarray(jax_run["preds"]))


def test_threshold_gives_unknown(shipped):
    spec, params = shipped
    eng = Engine("pmg", spec, params, batch_size=4, prob_threshold=0.99, device="cpu")
    out = eng.run(_frames(), measure_time=True, scan_chunk=2)
    assert (out["preds"] == -1).all()
    assert out["times"].shape == (2,)
    probs = eng.predict_dict(_frames(2))
    assert list(probs) == list(spec.tasks.names)
    assert probs["Weather Type"].shape == (2, 8)


def test_load_engine_on_cpu(shipped):
    meta = _meta()
    eng = port.load_engine("pmg", SHIPPED + ".pth", meta["tasks"], meta["hparams"],
                           batch_size=2, device="cpu")
    spec, params = shipped
    want = Engine("pmg", spec, params, batch_size=2, device="cpu").run(_frames(2))
    got = eng.run(_frames(2))
    np.testing.assert_array_equal(got["probs"], want["probs"])


def test_default_device_raises_without_a_card(shipped, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, params = shipped
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine("pmg", spec, params)
    meta = _meta()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.load_engine("pmg", SHIPPED + ".pth", meta["tasks"], meta["hparams"])


@pytest.mark.parametrize("kwargs,err,match", [
    (dict(mesh=object()), TypeError, "make_mesh"),
    (dict(dtype=torch.float16), ValueError, "float32 or torch.bfloat16"),
])
def test_unported_options_raise(shipped, kwargs, err, match):
    """A ``mesh`` that is not a ``parallel.mesh.Mesh`` raises in the Engine
    (a mesh runs: tests/test_torch_parallel.py), as does a dtype other than
    float32 and bf16.  bf16 runs in the Engine (tests/test_torch_bf16.py)
    and in the stream (tests/test_torch_stream_bf16.py)."""
    spec, params = shipped
    with pytest.raises(err, match=match):
        Engine("pmg", spec, params, device="cpu", **kwargs)


@pytest.mark.parametrize("bad", [
    np.zeros((2, 224, 224, 3), np.float32),
    np.zeros((2, 56, 56, 12), np.uint8),
    np.zeros((224, 224, 3), np.uint8),
])
def test_wire_contract_rejects(shipped, bad):
    spec, params = shipped
    eng = Engine("pmg", spec, params, batch_size=2, device="cpu")
    with pytest.raises(ValueError):
        eng.run(bad)
