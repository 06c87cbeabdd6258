"""The port's PM family on the CPU: the five golden fixtures, the attention
and embedding taps, the checkpoint leg (with and without SE), the same
params fed to both packages (``params_from_jax``), and the ``Engine`` and
``StreamPredictor`` against the JAX package's.

PM runs no hand-written kernel; the ``cuda``-marked test runs its Engine
on the card against the CPU path and skips here.
"""

import dataclasses
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
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm as tpm
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
    normalize_uint8,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream as tstream
from _torch_threads import one_torch_thread  # noqa: F401

# f32 CPU torch vs the frozen f32 reference (tests/test_parity.py:27, :58-70)
ATOL = RTOL = 2e-4
EMB_TOL = 2e-3
PM_FIXTURES = ["pm_ablate", "pm_batchnorm_sigmoid", "pm_deep_plan", "pm_no_se", "pm_small"]
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
SMALL = {
    "instance_se": dict(ndf=8, patch_size=16, norm="instance"),
    "batch_sigmoid": dict(ndf=8, patch_size=16, norm="batch", attn_softmax_spatial=False),
    "group_no_se": dict(ndf=32, patch_size=16, norm="group", attn_use_se=False),
    "ablate": dict(ndf=8, patch_size=32, norm="instance", ablate_attention=True),
}

enable_parity_precision()


def _case(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    spec = tpm.build_spec(meta["tasks"], meta["hparams"])
    params = tckpt.load_torch_checkpoint("pm", os.path.join(FIXTURES, f"{name}.pth"), spec)
    x = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1)))
    return meta, data, spec, params, x


@pytest.mark.parametrize("name", PM_FIXTURES)
def test_fixture_logits_match_reference(name):
    meta, data, spec, params, x = _case(name)
    assert meta["family"] == "pm"
    logits, _ = tpm.apply(params, x, spec)
    for i, task in enumerate(spec.tasks.names):
        want = data[f"logits/{task}"]
        np.testing.assert_allclose(logits[:, i, : want.shape[1]].numpy(), want,
                                   atol=ATOL, rtol=RTOL, err_msg=task)


def test_attention_and_embeddings_match_reference():
    _, data, spec, params, x = _case("pm_small")
    _, aux = tpm.apply(params, x, spec, capture=("attn", "task_embeddings"))
    for i, task in enumerate(spec.tasks.names):
        np.testing.assert_allclose(aux["attn"][:, i].numpy(), data[f"attn/{task}"][:, 0],
                                   atol=ATOL, rtol=RTOL, err_msg=task)
        np.testing.assert_allclose(aux["task_embeddings"][:, i].numpy(), data[f"task_emb/{task}"],
                                   atol=EMB_TOL, rtol=EMB_TOL, err_msg=task)


# -- checkpoint leg --------------------------------------------------------------


@pytest.mark.parametrize("name,has_se", [("pm_small", True), ("pm_no_se", False)])
def test_checkpoint_leg_matches_jax_converter(name, has_se):
    """The SE probe and ``convert_pm`` leaf for leaf against the JAX
    package's, on a checkpoint with SE blocks and one without."""
    from wadt.engine import checkpoint as jckpt
    from wadt.models import pm as jpm

    state = tckpt.load_state_dict(os.path.join(FIXTURES, f"{name}.pth"))
    assert tckpt.checkpoint_has_se(state) is has_se
    assert jckpt.checkpoint_has_se(state) is has_se
    assert tckpt.sniff_family(state) == "pm"
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    hp = dict(meta["hparams"], attn_use_se=True)  # SE on in the spec, weights or not
    got = tckpt.convert("pm", state, tpm.build_spec(meta["tasks"], hp))
    want = jckpt.convert("pm", state, jpm.build_spec(meta["tasks"], hp))
    assert len(got["trunk"]) == len(want["trunk"])
    for tb, jb in zip(got["trunk"], want["trunk"]):
        assert sorted(tb["conv"]) == sorted(jb["conv"]) == ["b", "w"]
        for grp in ("conv", "norm"):
            for k in jb[grp]:
                np.testing.assert_array_equal(tb[grp][k].numpy(), np.asarray(jb[grp][k]))
    assert sorted(got["heads"]) == sorted(want["heads"])
    for k in want["heads"]:
        np.testing.assert_array_equal(got["heads"][k].numpy(), np.asarray(want["heads"][k]))
    assert bool(got["heads"]["se1_w"].abs().sum() > 0) is has_se


def test_load_engine_probes_se_and_matches_fixture():
    meta, data, spec, params, _ = _case("pm_no_se")
    hp = dict(meta["hparams"], attn_use_se=True)  # the probe overrides it
    eng = port.load_engine("pm", os.path.join(FIXTURES, "pm_no_se.pth"), meta["tasks"], hp,
                           batch_size=2, device="cpu", packed="off")
    assert eng.spec.attn_use_se is False and eng.pack_k is None
    x = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1)))
    logits, _ = tpm.apply(eng.params, x, eng.spec)
    want = data[f"logits/{spec.tasks.names[0]}"]
    np.testing.assert_allclose(logits[:, 0, : want.shape[1]].numpy(), want, atol=ATOL, rtol=RTOL)


# -- the same params in both packages ------------------------------------------


def _jax_and_port(case, seed=3):
    import jax

    from wadt.models import pm as jpm

    jspec = jpm.build_spec(TASKS, SMALL[case])
    jparams = jpm.init(jax.random.PRNGKey(seed), jspec)
    if jspec.norm == "batch":  # non-trivial running stats
        rng = np.random.RandomState(5)
        for blk in jparams["trunk"]:
            c = blk["norm"]["mean"].shape[0]
            blk["norm"]["mean"] = rng.randn(c).astype(np.float32) * 0.1
            blk["norm"]["var"] = rng.rand(c).astype(np.float32) + 0.5
    tspec = tpm.build_spec(TASKS, SMALL[case])
    return jpm, jspec, jparams, tspec, tckpt.params_from_jax(jparams, tspec)


@pytest.mark.parametrize("case", sorted(SMALL))
def test_apply_matches_jax(case):
    import jax.numpy as jnp

    from wadt.ops.preprocess import normalize_uint8 as jnormalize

    jpm, jspec, jparams, tspec, tparams = _jax_and_port(case)
    u8 = np.random.RandomState(11).randint(0, 256, (2, 64, 64, 3), np.uint8)
    taps = ("features", "attn", "task_embeddings", "shared_embedding")
    want, jaux = jpm.apply(jparams, jnormalize(jnp.asarray(u8)), jspec, capture=taps)
    got, taux = tpm.apply(tparams, normalize_uint8(torch.from_numpy(u8)), tspec, capture=taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    for tap in taps:
        np.testing.assert_allclose(taux[tap].numpy(), np.asarray(jaux[tap]), atol=ATOL, rtol=RTOL,
                                   err_msg=tap)
    hl, haux = tpm.head_apply(tparams, taux["features"], tspec, capture=("attn",))
    torch.testing.assert_close(hl, got, atol=0, rtol=0)
    torch.testing.assert_close(haux["attn"], taux["attn"], atol=0, rtol=0)


def test_spec_and_init_match_jax():
    import jax

    from wadt.models import pm as jpm

    assert tpm.DEFAULTS == jpm.DEFAULTS
    hp = {"ndf": 16, "patch_size": 32, "attn_tau": 0.5, "unrelated": 1}
    t, j = tpm.build_spec(TASKS, hp), jpm.build_spec(TASKS, hp)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.plan == j.plan and t.trunk_channels == j.trunk_channels
    g = torch.Generator().manual_seed(0)
    mine = tpm.init(g, t)
    theirs = jpm.init(jax.random.PRNGKey(0), j)
    flat = lambda tree: {k: v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}  # noqa: E731
    assert {str(k): tuple(np.shape(v)) for k, v in flat(mine).items()} == \
        {str(k): tuple(np.shape(v)) for k, v in flat(theirs).items()}
    # torch's default init ranges, and class columns past a task's count stay zero
    w0 = mine["trunk"][0]["conv"]["w"]
    assert float(w0.abs().max()) <= 1.0 / np.sqrt(16 * 3) + 1e-7
    assert float(mine["heads"]["cls_w"][1, :, 2:].abs().max()) == 0.0
    again = tpm.init(torch.Generator().manual_seed(0), t)
    torch.testing.assert_close(again["heads"]["se1_w"], mine["heads"]["se1_w"], atol=0, rtol=0)


def test_params_from_jax_rejects_mismatched_tree():
    _, _, jparams, tspec, _ = _jax_and_port("instance_se")
    with pytest.raises(ValueError, match="do not match"):
        tckpt.params_from_jax({"trunk": jparams["trunk"]}, tspec)
    with pytest.raises(ValueError, match="trunk blocks"):
        tckpt.params_from_jax(dict(jparams, trunk=jparams["trunk"][:-1]), tspec)


# -- Engine and StreamPredictor ------------------------------------------------


@pytest.mark.parametrize("case", ["instance_se", "batch_sigmoid"])
def test_engine_matches_jax_engine(case):
    from wadt.engine.executor import Engine as JEngine

    _, jspec, jparams, tspec, tparams = _jax_and_port(case)
    frames = np.random.RandomState(12).randint(0, 256, (5, 64, 64, 3), np.uint8)
    keys = ("probs", "preds", "logits")
    want = JEngine("pm", jspec, jparams, batch_size=4).run(frames, collect=keys)
    eng = Engine("pm", tspec, tparams, batch_size=4, device="cpu")
    assert eng.pack_k is None  # PM normalizes on the device, no stem fold
    got = eng.run(frames, collect=keys)
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got["preds"], np.asarray(want["preds"]))


def test_stream_generic_route_matches_jax():
    from wadt.workloads.stream import StreamPredictor

    _, jspec, jparams, tspec, tparams = _jax_and_port("instance_se")
    frames = np.random.RandomState(13).randint(0, 256, (3, 64, 64, 3), np.uint8)
    jpred = StreamPredictor("pm", jspec, jparams, use_kalman=True)
    pred = tstream.StreamPredictor("pm", tspec, tparams, use_kalman=True, device="cpu")
    assert pred.route == "generic"
    for i, f in enumerate(frames):
        np.testing.assert_allclose(pred(f), np.asarray(jpred(f)), atol=1e-5, rtol=1e-5,
                                   err_msg=f"frame {i}")
    with pytest.raises(ValueError, match="not a PM route"):
        tstream.StreamPredictor("pm", tspec, tparams, trunk_kernel="fused", device="cpu")


def test_default_device_raises_without_a_card(monkeypatch):
    _, _, _, tspec, tparams = _jax_and_port("instance_se")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine("pm", tspec, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamPredictor("pm", tspec, tparams)


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PM_FIXTURES)
def test_fixture_logits_on_card(name, cuda_device):
    _, data, spec, params, x = _case(name)
    with torch.inference_mode():
        logits, _ = tpm.apply(tckpt.to_device(params, cuda_device), x.to(cuda_device), spec)
    for i, task in enumerate(spec.tasks.names):
        want = data[f"logits/{task}"]
        np.testing.assert_allclose(logits[:, i, : want.shape[1]].cpu().numpy(), want,
                                   atol=ATOL, rtol=RTOL, err_msg=task)
