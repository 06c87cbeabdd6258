"""The port's patch-Gram style transfer on the CPU (``…_torch/workloads/style_transfer.py``,
``ops/gram.style_patch_grams``) against the JAX package's: the golden
``style_grams``, the style split and the preprocess helpers on the same
arrays, and the optimization loop on the same params (``params_from_jax``)
at gray init: losses, iterations, pixels and progress lines."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tests.conftest import FIXTURES

import wadt  # noqa: F401
from wadt.models import pmg as jpmg
from wadt.ops import gram as jgram
from wadt.ops import preprocess as jpre
from wadt.workloads import style_transfer as jst

import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    enable_parity_precision,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.checkpoint import (
    params_from_jax,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import gram as tgram
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
    preprocess as tpre,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
    style_transfer as tst,
)
from _torch_threads import one_torch_thread  # noqa: F401

enable_parity_precision()

STYLE_GRAMS_TOL = 2e-3  # the JAX package's bound (tests/test_parity.py:96)
LOSS_RTOL = 1e-4  # port loop against the JAX loop, float32 on both sides
GRAM_TOL = 1e-6  # one split, the same float32 sums in another order

TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
# the tiny PMG spec of tests/test_explain_stream.py:12-16
TINY = dict(ndf=8, patch_size=64, patch_div=2, gram_channels=16, d_model=32,
            transformer_layers=1, transformer_heads=2, norm="batch")


@pytest.fixture(scope="module")
def model():
    import jax

    jspec = jpmg.build_spec(TASKS, TINY)
    jparams = jpmg.init(jax.random.PRNGKey(0), jspec)
    spec = pmg.build_spec(TASKS, TINY)
    return jspec, jparams, spec, params_from_jax(jparams, spec)


def _styles(n, seed):
    return np.random.RandomState(seed).randn(n, 64, 64, 3).astype(np.float32) * 0.5


def test_style_grams_match_the_golden_fixture():
    """The shipped PMG's style signature of the fixture input, through a
    loaded engine's params."""
    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(FIXTURES, "pmg_shipped.npz"))
    eng = port.load_engine("pmg", os.path.join(FIXTURES, "pmg_shipped.pth"), meta["tasks"],
                           meta["hparams"], device="cpu")
    x = torch.from_numpy(np.ascontiguousarray(data["input"][0:1].transpose(0, 2, 3, 1)))
    with torch.no_grad():
        grams = tst.extract_style_grams(eng.params, eng.spec, x)[0].numpy()
    assert grams.shape == data["style_grams"].shape == (9, 128, 128)
    np.testing.assert_allclose(grams, data["style_grams"], atol=STYLE_GRAMS_TOL,
                               rtol=STYLE_GRAMS_TOL)


@pytest.mark.parametrize("shape,div", [((2, 14, 14, 8), 3), ((1, 9, 7, 5), 2), ((2, 8, 8, 4), 4),
                                       ((1, 5, 11, 3), 5)])
def test_style_patch_grams_match_jax(shape, div):
    """Crops and the scrambled regroup (more than one patch row), on the
    same array."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    got = tgram.style_patch_grams(torch.from_numpy(x), div)
    want = np.asarray(jgram.style_patch_grams(x, div))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=GRAM_TOL, rtol=GRAM_TOL)


def test_style_patch_grams_sum_bf16_in_float32_and_float64_in_float64():
    x = np.random.RandomState(1).randn(2, 6, 6, 4).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tgram.style_patch_grams(xb, 2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, tgram.style_patch_grams(xb.float(), 2), atol=0, rtol=0)
    got64 = tgram.style_patch_grams(torch.from_numpy(x).double(), 2)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), tgram.style_patch_grams(
        torch.from_numpy(x), 2).double().numpy(), atol=GRAM_TOL)


def test_style_patch_grams_refuse_a_map_smaller_than_the_split():
    with pytest.raises(ValueError, match="patch_div"):
        tgram.style_patch_grams(torch.zeros(1, 2, 5, 3), 3)
    with pytest.raises(ValueError, match="patch_div"):
        jgram.style_patch_grams(np.zeros((1, 2, 5, 3), np.float32), 3)


def test_patch_grams_match_jax_and_the_tokens():
    x = np.random.RandomState(2).randn(2, 7, 5, 6).astype(np.float32)
    got = tgram.patch_grams(torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgram.patch_grams(x, 2)), atol=GRAM_TOL,
                               rtol=GRAM_TOL)
    tokens = tgram.patch_gram_tokens(torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.reshape(2, 4, 36).numpy(), tokens.numpy(), atol=GRAM_TOL)


def test_denormalize_and_normalize01_match_jax():
    x = np.random.RandomState(3).randn(2, 5, 4, 3).astype(np.float32) * 2
    got = tpre.denormalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpre.denormalize(x)))
    assert got.min() >= 0.0 and got.max() <= 1.0
    u = np.random.RandomState(4).rand(2, 5, 4, 3).astype(np.float32)
    np.testing.assert_allclose(tpre.normalize01(torch.from_numpy(u)).numpy(),
                               np.asarray(jpre.normalize01(u)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tpre.denormalize(tpre.normalize01(torch.from_numpy(u))).numpy(), u,
                               atol=1e-6)


@pytest.mark.parametrize("target_loss,log_every", [(0.0, 2), (None, 3), (1e9, 0)])
def test_style_loop_matches_jax_at_gray_init(model, capsys, target_loss, log_every):
    """Losses within 1e-4 relative, iterations equal, pixels equal, and the
    same progress lines.  ``None`` sets the target between the two images'
    losses after two steps, so one image stops early and the other goes on."""
    jspec, jparams, spec, params = model
    styles = _styles(2, 5)
    if target_loss is None:
        _, probe, _ = jst.run_patch_gram_style_transfer_batch(
            jparams, jspec, styles, num_iterations=2, init_type="gray", target_loss=0.0,
            log_every=0)
        target_loss = float(np.sqrt(probe[0] * probe[1]))
    kw = dict(num_iterations=7, lr=0.05, init_type="gray", target_loss=target_loss,
              log_every=log_every)
    capsys.readouterr()
    jimgs, jloss, jiters = jst.run_patch_gram_style_transfer_batch(jparams, jspec, styles, **kw)
    jout = capsys.readouterr().out
    timgs, tloss, titers = tst.run_patch_gram_style_transfer_batch(params, spec, styles,
                                                                   device="cpu", **kw)
    tout = capsys.readouterr().out
    np.testing.assert_array_equal(titers, jiters)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL, atol=0)
    for a, b in zip(timgs, jimgs):
        assert a.size == b.size == (64, 64)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tout == jout
    if target_loss == 1e9:
        assert list(titers) == [1, 1]
    if log_every == 3:  # the two images stopped at different iterations
        assert len(set(titers.tolist())) == 2


def test_batch_equals_solo(model):
    """Each image of a batch follows the trajectory it would alone."""
    _, _, spec, params = model
    styles = _styles(2, 3)
    imgs, losses, iters = tst.run_patch_gram_style_transfer_batch(
        params, spec, styles, num_iterations=5, lr=0.05, init_type="gray", target_loss=0.0,
        log_every=0, device="cpu")
    assert list(iters) == [5, 5]
    for i in range(2):
        img, loss, it = tst.run_patch_gram_style_transfer(
            params, spec, styles[i : i + 1], num_iterations=5, lr=0.05, init_type="gray",
            target_loss=0.0, log_every=0, device="cpu")
        assert it == 5
        np.testing.assert_allclose(losses[i], loss, rtol=LOSS_RTOL)
        # uint8 off by one at most: batched and solo convolutions sum in other orders
        assert np.abs(np.asarray(imgs[i], int) - np.asarray(img, int)).max() <= 1


def test_early_stop_applies_the_last_step(model):
    """A huge target stops every image after one applied step: the pixels
    moved, as the reference breaks after ``optimizer.step()``."""
    _, _, spec, params = model
    imgs, losses, iters = tst.run_patch_gram_style_transfer_batch(
        params, spec, _styles(2, 4), num_iterations=10, lr=0.05, init_type="gray",
        target_loss=1e9, log_every=0, device="cpu")
    assert list(iters) == [1, 1]
    assert np.isfinite(losses).all()
    assert float(np.abs(np.asarray(imgs[0], np.float32) / 255.0 - 0.5).max()) > 0.01


def test_noise_init_is_independent_of_position(model):
    """The noise of image i is keyed on (seed, seed_offset + i): the same
    image gets the same trajectory solo, batched or re-chunked."""
    _, _, spec, params = model
    styles = _styles(2, 9)
    imgs, losses, _ = tst.run_patch_gram_style_transfer_batch(
        params, spec, styles, num_iterations=3, init_type="noise", target_loss=0.0,
        log_every=0, device="cpu")
    img1, loss1, _ = tst.run_patch_gram_style_transfer(
        params, spec, styles[1:2], num_iterations=3, init_type="noise", target_loss=0.0,
        log_every=0, seed_offset=1, device="cpu")
    np.testing.assert_allclose(losses[1], loss1, rtol=LOSS_RTOL)
    assert np.abs(np.asarray(imgs[1], int) - np.asarray(img1, int)).max() <= 1
    a, b = tst.noise_init((4, 4, 3), 0, 1), tst.noise_init((4, 4, 3), 0, 1)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, tst.noise_init((4, 4, 3), 0, 2))
    assert not torch.equal(a, tst.noise_init((4, 4, 3), 1, 1))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_style_transfer_composite_bytes_equal_jax():
    rng = np.random.RandomState(6)
    orig = Image.fromarray(rng.randint(0, 256, (90, 120, 3), np.uint8))
    gen = Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8))
    got = tst.style_transfer_composite(orig, gen)
    want = jst.style_transfer_composite(orig, gen)
    assert got.size == want.size == (512, 256)
    assert got.tobytes() == want.tobytes()
    assert tst.style_transfer_composite(orig, gen, 32).tobytes() == \
        jst.style_transfer_composite(orig, gen, 32).tobytes()


def test_style_loop_wants_a_card_unless_cpu_is_asked(model, monkeypatch):
    _, _, spec, params = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.run_patch_gram_style_transfer_batch(params, spec, _styles(1, 0), num_iterations=1)
