"""The port's camera path on the CPU: Kalman filter, the head and trunk
folds, the plain versions of the fused trunk+Gram (K3) and fused head (K4)
kernels against the JAX package's Pallas kernels in interpret mode, the
``StreamPredictor`` routes against JAX compositions on the same params
(``params_from_jax``), the golden-fixture walk of the head variants, and
``run_camera`` headless over a tiny video.

The kernels themselves run only on a CUDA card: the ``cuda``-marked tests
hold them against their plain versions there and skip elsewhere.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

import wadt  # noqa: F401
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    enable_parity_precision,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import checkpoint as tckpt
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg as tpmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import kalman as tkalman
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import goldens as tgoldens
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream as tstream

SMALL = dict(ndf=8, patch_size=64, patch_div=3, gram_channels=16, d_model=32,
             transformer_layers=1, transformer_heads=2, norm="batch")
NO_TX = dict(SMALL, transformer_layers=0, use_token_attention=False)
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
K3_TOL = 5e-3  # the JAX package's own bound for the fused trunk (tests/test_pallas.py:133)
K4_TOL = 1e-3
JAX_HEAD = {"fused_bf16": "pallas_bf16", "fused_q8": "pallas_q8"}

enable_parity_precision()


def _model(hp=SMALL, seed=3):
    """The same random PMG in both packages, with non-trivial BN statistics."""
    import jax

    from wadt.models import pmg as jpmg

    jspec = jpmg.build_spec(TASKS, hp)
    jparams = jpmg.init(jax.random.PRNGKey(seed), jspec)
    rng = np.random.RandomState(5)
    for blk in jparams["trunk"] if jspec.norm == "batch" else ():
        c = blk["norm"]["mean"].shape[0]
        blk["norm"]["mean"] = rng.randn(c).astype(np.float32) * 0.1
        blk["norm"]["var"] = rng.rand(c).astype(np.float32) + 0.5
    tspec = tpmg.build_spec(TASKS, hp)
    return jspec, jparams, tspec, tckpt.params_from_jax(jparams, tspec)


@pytest.fixture(scope="module")
def model():
    return _model()


def _frames(n, size=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), np.uint8)


def _leaves(jtree, ttree, path=()):
    """(path, jax leaf, torch leaf) for every leaf of two same-shaped trees."""
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree), path
        for k in jtree:
            yield from _leaves(jtree[k], ttree[k], path + (k,))
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            yield from _leaves(a, b, path + (i,))
    else:
        yield path, jtree, ttree


def _assert_bit_equal(jleaf, tleaf, what):
    a = np.asarray(jleaf)
    assert str(tleaf.dtype) == f"torch.{a.dtype}", (what, a.dtype, tleaf.dtype)
    np.testing.assert_array_equal(tleaf.float().numpy(), a.astype(np.float32), err_msg=str(what))


# -- Kalman ------------------------------------------------------------------


def test_kalman_matches_jax_over_30_steps():
    from wadt.ops import kalman as jkalman

    rng = np.random.RandomState(0)
    js, ts = jkalman.init_state(3, 4), tkalman.init_state(3, 4)
    for step in range(30):
        obs = rng.rand(3, 4).astype(np.float32)
        js, jm = jkalman.filter_update(js, obs)
        ts, tm = tkalman.filter_update(ts, torch.from_numpy(obs))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6, rtol=1e-6,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(ts.cov.numpy(), np.asarray(js.cov), atol=1e-6, rtol=1e-6)


# -- folds -------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["bf16", "q8"])
def test_fold_head_weights_bit_exact(model, variant):
    from wadt.models import pmg as jpmg

    jspec, jparams, tspec, tparams = model
    jf = jpmg.fold_head_weights(jparams, jspec, variant)
    tf = tpmg.fold_head_weights(tparams, tspec, variant)
    leaves = list(_leaves(jf, tf))
    assert len(leaves) > 10
    for path, a, b in leaves:
        _assert_bit_equal(a, b, path)
    with pytest.raises(ValueError, match="unknown head fold"):
        tpmg.fold_head_weights(tparams, tspec, "int4")


def test_fold_trunk_gram_weights_bit_exact(model):
    from wadt.ops.pallas_kernels import fold_trunk_gram_weights

    jspec, jparams, tspec, tparams = model
    jw = fold_trunk_gram_weights(jparams, jspec)
    tw = ck.fold_trunk_gram_weights(tparams, tspec)
    assert len(tw) == len(jw) == 8
    for i, (a, b) in enumerate(zip(jw, tw)):
        _assert_bit_equal(a, b, f"array {i}")


def test_fold_trunk_gram_limits():
    _, _, inst_spec, inst_params = _model(dict(SMALL, norm="instance"))
    assert ck.supports_fused_trunk_gram(inst_spec)
    with pytest.raises(NotImplementedError, match="BatchNorm only"):
        ck.fold_trunk_gram_weights(inst_params, inst_spec)
    _, _, deep_spec, deep_params = _model(dict(SMALL, patch_size=70))
    assert not ck.supports_fused_trunk_gram(deep_spec)
    with pytest.raises(ValueError, match="trunk plan"):
        ck.fold_trunk_gram_weights(deep_params, deep_spec)


@pytest.mark.parametrize("hp", [SMALL, dict(SMALL, patch_size=70), dict(SMALL, use_channel_attention=True)],
                         ids=["fused_plan", "deep_plan", "se"])
def test_supports_fused_trunk_gram_matches_jax(hp):
    from wadt.models import pmg as jpmg
    from wadt.ops.pallas_kernels import supports_fused_trunk_gram

    assert ck.supports_fused_trunk_gram(tpmg.build_spec(TASKS, hp)) == \
        supports_fused_trunk_gram(jpmg.build_spec(TASKS, hp))


# -- K3: fused trunk + Gram ----------------------------------------------------


@pytest.mark.parametrize("size", [64, 80])
def test_fused_trunk_gram_plain_matches_pallas(model, size):
    """Raw frames against the Pallas kernel on the same frames K-packed
    (80 px: a 5x5 final map, replicate-padded to 6x6)."""
    import jax.numpy as jnp

    from wadt.ops.pallas_kernels import fold_trunk_gram_weights, fused_trunk_gram
    from wadt.ops.preprocess import s2d_pack_uint8

    jspec, jparams, tspec, tparams = model
    K = tspec.plan[0].kernel * tspec.plan[1].kernel
    u8 = _frames(2, size)
    want = np.asarray(fused_trunk_gram(jnp.asarray(s2d_pack_uint8(u8, K)),
                                       fold_trunk_gram_weights(jparams, jspec), jspec, interpret=True))
    got = ck.fused_trunk_gram(torch.from_numpy(u8), ck.fold_trunk_gram_weights(tparams, tspec), tspec)
    np.testing.assert_allclose(got.numpy(), want, atol=K3_TOL, rtol=K3_TOL)


def test_fused_trunk_gram_plain_matches_model_tokens(model):
    """The fused trunk's bf16 chain against the port's float32 model Gram
    tokens (normalize -> trunk -> chan_proj -> patch Gram)."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models.trunk import (
        apply_trunk,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import conv2d
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        normalize_uint8,
    )

    _, _, tspec, tparams = model
    u8 = torch.from_numpy(_frames(2))
    feats = apply_trunk(tparams["trunk"], normalize_uint8(u8), tspec.plan, tspec.norm)
    want = ck.patch_gram_plain(conv2d(feats, tparams["chan_proj"]), tspec.patch_div)
    got = ck.fused_trunk_gram(u8, ck.fold_trunk_gram_weights(tparams, tspec), tspec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=K3_TOL, rtol=K3_TOL)


# -- K4: fused head ------------------------------------------------------------


def _head_case(case):
    hp = NO_TX if case == "no_transformer" else SMALL
    variant = "bf16" if case == "no_transformer" else case
    return _model(hp, seed=1), variant


@pytest.mark.parametrize("case", ["bf16", "q8", "no_transformer"])
def test_fused_head_plain_matches_pallas(case):
    import jax.numpy as jnp

    from wadt.models import pmg as jpmg
    from wadt.ops.pallas_kernels import fused_head

    (jspec, jparams, tspec, tparams), variant = _head_case(case)
    tokens = np.random.RandomState(11).randn(2, 9, 256).astype(np.float32)
    want = np.asarray(fused_head(jnp.asarray(tokens), jpmg.fold_head_weights(jparams, jspec, variant),
                                 jspec, interpret=True))
    got = ck.fused_head(torch.from_numpy(tokens), tpmg.fold_head_weights(tparams, tspec, variant),
                        tspec).numpy()
    np.testing.assert_allclose(got, want, atol=K4_TOL, rtol=K4_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("variant", ["f32", "bf16", "q8"])
def test_head_from_gram_tokens_on_folds_matches_jax(model, variant):
    """The plain head routes: float32 tokens meet the upcast bf16 weights,
    the int8 fold dequantizes in float32, as in the JAX package."""
    import jax.numpy as jnp

    from wadt.models import pmg as jpmg

    jspec, jparams, tspec, tparams = model
    if variant != "f32":
        jparams = jpmg.fold_head_weights(jparams, jspec, variant)
        tparams = tpmg.fold_head_weights(tparams, tspec, variant)
    tokens = np.random.RandomState(12).randn(2, 9, 256).astype(np.float32)
    want = np.asarray(jpmg.head_from_gram_tokens(jparams, jnp.asarray(tokens), jspec))
    got = tpmg.head_from_gram_tokens(tparams, torch.from_numpy(tokens), tspec).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -- StreamPredictor -----------------------------------------------------------


def _jax_probs_over_frames(step, frames, tasks):
    """Run a JAX per-frame step (frame -> logits [1,T,K]) with masked softmax
    and the Kalman update; return the smoothed probs of each frame."""
    import jax.numpy as jnp

    from wadt.engine.executor import class_mask, masked_softmax
    from wadt.ops import kalman as jkalman

    mask = jnp.asarray(class_mask(tasks))
    state = jkalman.init_state(len(tasks), tasks.max_classes)
    out = []
    for f in frames:
        probs = masked_softmax(step(f).astype(jnp.float32), mask)[0]
        state, smoothed = jkalman.filter_update(state, probs)
        out.append(np.asarray(smoothed))
    return out


@pytest.mark.parametrize("head_fold", ["fused_bf16", "fused_q8", "bf16", "q8", "f32"])
def test_stream_fused_route_matches_jax_composition(model, head_fold):
    """The JAX StreamPredictor's fused route compiles its Pallas kernels and
    cannot run on the CPU, so the reference composes the interpret-mode
    kernels: fused_trunk_gram -> head -> masked softmax -> Kalman update."""
    import jax.numpy as jnp

    from wadt.models import pmg as jpmg
    from wadt.ops.pallas_kernels import fold_trunk_gram_weights, fused_head, fused_trunk_gram
    from wadt.ops.preprocess import s2d_pack_uint8

    jspec, jparams, tspec, tparams = model
    K = jspec.plan[0].kernel * jspec.plan[1].kernel
    trunk = fold_trunk_gram_weights(jparams, jspec)
    fold = head_fold.replace("fused_", "")
    head = jparams if fold == "f32" else jpmg.fold_head_weights(jparams, jspec, fold)

    def step(frame):
        tokens = fused_trunk_gram(jnp.asarray(s2d_pack_uint8(frame[None], K)), trunk, jspec,
                                  interpret=True)
        if head_fold in JAX_HEAD:
            return fused_head(tokens, head, jspec, interpret=True)
        return jpmg.head_from_gram_tokens(head, tokens, jspec)

    frames = _frames(3, seed=4)
    want = _jax_probs_over_frames(step, frames, jspec.tasks)
    pred = tstream.StreamPredictor("pmg", tspec, tparams, use_kalman=True,
                                   trunk_kernel="fused", head_fold=head_fold, device="cpu")
    assert pred.route == "fused" and pred.head_fold == head_fold
    for i, f in enumerate(frames):
        np.testing.assert_allclose(pred(f), want[i], atol=K4_TOL, rtol=K4_TOL, err_msg=f"frame {i}")


def test_stream_packed_route_matches_jax(model):
    from wadt.workloads.stream import StreamPredictor

    jspec, jparams, tspec, tparams = model
    frames = _frames(3, seed=5)
    jpred = StreamPredictor("pmg", jspec, jparams, use_kalman=True, trunk_kernel="packed")
    pred = tstream.StreamPredictor("pmg", tspec, tparams, use_kalman=True,
                                   trunk_kernel="packed", device="cpu")
    assert pred.route == "packed" and not jpred._fused
    for i, f in enumerate(frames):
        np.testing.assert_allclose(pred(f), jpred(f), atol=1e-5, rtol=1e-5, err_msg=f"frame {i}")


def test_stream_generic_route_matches_jax(model):
    from wadt.models import pmg as jpmg
    from wadt.ops.preprocess import normalize_uint8

    jspec, jparams, tspec, tparams = model
    frames = _frames(3, seed=6)
    want = _jax_probs_over_frames(
        lambda f: jpmg.apply(jparams, normalize_uint8(f[None]), jspec)[0], frames, jspec.tasks)
    pred = tstream.StreamPredictor("pmg", tspec, tparams, use_kalman=True,
                                   trunk_kernel="generic", device="cpu")
    for i, f in enumerate(frames):
        np.testing.assert_allclose(pred(f), want[i], atol=1e-5, rtol=1e-5, err_msg=f"frame {i}")


def test_stream_auto_routes(model):
    _, _, tspec, tparams = model
    auto = tstream.StreamPredictor("pmg", tspec, tparams, device="cpu")
    assert (auto.route, auto.head_fold) == ("fused", "fused_bf16")
    assert auto.params["token_proj"]["w"].dtype == torch.bfloat16
    assert "trunk" not in auto.params  # head-only tree on the folded route
    probs = auto(_frames(1)[0])
    assert probs.shape == (2, 3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)
    assert probs[1, 2] == 0.0  # task B has two classes
    # PMG's first block is always k=s p0, so "auto" falls back to packed
    for hp in (dict(SMALL, norm="instance"), dict(SMALL, patch_size=70)):
        _, _, spec, params = _model(hp)
        assert tstream.StreamPredictor("pmg", spec, params, device="cpu").route == "packed"


def test_stream_rejects_bad_choices(model):
    _, _, tspec, tparams = model
    with pytest.raises(ValueError, match="head_fold applies only"):
        tstream.StreamPredictor("pmg", tspec, tparams, trunk_kernel="packed",
                                head_fold="fused_q8", device="cpu")
    with pytest.raises(ValueError, match="unknown head_fold"):
        tstream.StreamPredictor("pmg", tspec, tparams, head_fold="pallas_q8", device="cpu")
    with pytest.raises(ValueError, match="unknown trunk_kernel"):
        tstream.StreamPredictor("pmg", tspec, tparams, trunk_kernel="xla", device="cpu")
    _, _, inst_spec, inst_params = _model(dict(SMALL, norm="instance"))
    with pytest.raises(ValueError, match="batch-norm"):
        tstream.StreamPredictor("pmg", inst_spec, inst_params, trunk_kernel="fused", device="cpu")
    pred = tstream.StreamPredictor("pmg", tspec, tparams, device="cpu")
    with pytest.raises(ValueError, match="raw uint8 frame"):
        pred.submit(np.zeros((1, 64, 64, 3), np.uint8))


@pytest.mark.parametrize("family,item", [("rtm", "A14"), ("pm", "A13")])
def test_stream_other_families_name_the_roadmap(model, family, item):
    _, _, tspec, tparams = model
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tstream.StreamPredictor(family, tspec, tparams, device="cpu")


def test_stream_labels_and_reset(model):
    _, _, tspec, tparams = model
    pred = tstream.StreamPredictor("pmg", tspec, tparams, use_kalman=True, device="cpu")
    frame = _frames(1)[0]
    first = pred(frame)
    labels = pred.labels(first, prob_threshold=0.99)
    assert [t for t, _, _ in labels] == ["A", "B"]
    assert labels[0][1] == "Unknown"  # the Kalman warm-up keeps probs < 0.99
    pred(frame)
    pred.reset()
    np.testing.assert_array_equal(pred(frame), first)


def test_default_device_raises_without_a_card(model, monkeypatch):
    _, _, tspec, tparams = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamPredictor("pmg", tspec, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgoldens.pmg_head_fold_fixture_parity(FIXTURES, "fused_q8")


# -- golden fixtures -----------------------------------------------------------


@pytest.fixture(scope="module")
def golden_rows():
    return tgoldens.pmg_head_fold_fixture_parity(FIXTURES, tgoldens.VARIANTS, device="cpu")


@pytest.mark.parametrize("variant", tgoldens.VARIANTS)
def test_head_fold_golden_walk_cpu(golden_rows, variant):
    rows = golden_rows[variant]
    assert len(rows) == 4, rows  # every pmg_* fixture
    for name, agree, drift in rows:
        assert agree, f"{variant} flips argmax on {name} (drift {drift})"
        assert drift <= tgoldens.HEAD_FOLD_MAX_DRIFT, (variant, name, drift)


def test_golden_walk_matches_jax_walk(golden_rows):
    """Same fixtures and drifts as the JAX package's walk of the same
    variants (its pallas_* names), to float32 noise."""
    from wadt.utils.goldens import pmg_head_fold_fixture_parity

    want = pmg_head_fold_fixture_parity(FIXTURES, ["bf16", "pallas_q8"])
    for port_name, jax_name in (("bf16", "bf16"), ("fused_q8", "pallas_q8")):
        got = golden_rows[port_name]
        assert [r[0] for r in got] == [r[0] for r in want[jax_name]]
        assert [r[1] for r in got] == [r[1] for r in want[jax_name]]
        np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want[jax_name]], atol=1e-4)


# -- run_camera ----------------------------------------------------------------


def test_run_camera_headless_video(model, tmp_path):
    import cv2

    _, _, tspec, tparams = model
    vid = str(tmp_path / "in.avi")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"XVID"), 5.0, (64, 48))
    rng = np.random.RandomState(1)
    for _ in range(6):
        w.write(rng.randint(0, 256, (48, 64, 3), np.uint8))
    w.release()
    out = tmp_path / "cam"
    times = tstream.run_camera("pmg", tspec, tparams, str(out), video_path=vid, display=False,
                               measure_time=True, kalman_filter=True, max_frames=5,
                               save_camera_video=True, device="cpu")
    assert len(times) == 5
    with open(out / "times_camera.json") as f:
        assert len(json.load(f)) == 5
    assert any(n.endswith(".avi") for n in os.listdir(out))


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fused_trunk_gram_kernel_matches_plain_on_card(model, cuda_device):
    _, _, tspec, tparams = model
    w = ck.fold_trunk_gram_weights(tckpt.to_device(tparams, cuda_device), tspec)
    x = torch.from_numpy(_frames(2, 80)).to(cuda_device)
    ck.reset_launches()
    got = ck.fused_trunk_gram(x, w, tspec)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_trunk_gram"] == 1
    want = ck.fused_trunk_gram_plain(x, w, tspec)
    torch.testing.assert_close(got, want, atol=K3_TOL, rtol=K3_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16", "q8", "no_transformer"])
def test_fused_head_kernel_matches_plain_on_card(case, cuda_device):
    (_, _, tspec, tparams), variant = _head_case(case)
    folded = tpmg.fold_head_weights(tckpt.to_device(tparams, cuda_device), tspec, variant)
    tokens = torch.from_numpy(np.random.RandomState(11).randn(2, 9, 256).astype(np.float32))
    tokens = tokens.to(cuda_device)
    ck.reset_launches()
    got = ck.fused_head(tokens, folded, tspec)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_head"] == 1
    want = ck.fused_head_plain(tokens, folded, tspec)
    torch.testing.assert_close(got, want, atol=K4_TOL, rtol=K4_TOL)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
