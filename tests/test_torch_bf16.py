"""The port's bf16 batch path on the CPU.

- (a) K5's plain version (``cuda_kernels.gram_proj_plain``) against the
  Pallas kernel ``make_proj_kernel`` (``tools/exp_pmg_projkernel.py``) in
  interpret mode, which reads W transposed to d-major while the port reads
  ``token_proj`` in its own c-major order (the Gram is symmetric);
- (b) single bf16 ops against the JAX package's float32 functions on the
  same bf16-valued inputs, rounded to bf16: that is JAX's bf16 semantics
  for one op (bf16 products summed in float32, one rounding);
- (c) the ``Engine``'s params contract in bf16;
- (d) the port's bf16 ``Engine`` on tiny PMG, PM and RTM specs against the
  JAX package's float32 ``Engine`` on the same params.  The JAX bf16 Engine
  cannot run on this CPU (XLA:CPU has no bf16 x bf16 = f32 dot,
  ``tests/test_misc_paths.py:85``), so float32 is the reference, held with
  the tolerance stated at ``PROB_DRIFT``.

The kernels themselves run only on a CUDA card: the ``cuda``-marked test
holds the bf16 Engine on the card against its CPU path and skips here.
"""

import functools
import unittest.mock

import numpy as np
import pytest
import torch

import wadt  # noqa: F401
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    enable_parity_precision,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import checkpoint as tckpt
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine, to_device
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import get_family
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import nn as tnn
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.gram import (
    patch_gram_tokens,
)

enable_parity_precision()

BF16 = torch.bfloat16
TASKS = {"a": ["x", "y", "z"], "b": ["p", "q"], "c": ["u", "v", "w", "s"]}
TINY = {
    "pmg": dict(ndf=8, patch_size=64, patch_div=3, gram_channels=16, d_model=32,
                transformer_layers=1, transformer_heads=2, norm="batch"),
    "pm": dict(ndf=8, patch_size=16, norm="instance"),
    "rtm": dict(truncate_layer=5, attn_token_dim=32, cls_hidden_dims=[16], cls_num_layers=1),
}
# bf16 Engine vs the float32 JAX Engine, largest probability difference.
# bf16 keeps 8 significant bits, so each rounded activation is off by up
# to 2^-9 of itself; over the tiny specs' layers the probabilities moved
# by at most 9.4e-4 (PMG), 2.5e-4 (PM), 1.5e-4 (RTM) over three seeds
# each.  5e-3 leaves five times that, and is still far below a change of
# decision: argmax must agree wherever the float32 top-2 probabilities are
# more than 2 * PROB_DRIFT apart (it agreed on every sample measured).
PROB_DRIFT = 5e-3


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 values to bf16 and back (nearest even)."""
    return torch.tensor(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _assert_within_one_ulp(got: torch.Tensor, want_f32: np.ndarray, slack=0.0):
    """got (bf16) equals want rounded to bf16, or its neighbour: the float32
    sums of the two frameworks run in different orders.  ``slack`` adds what
    such sums may differ by where their terms cancel."""
    assert got.dtype == BF16
    g = got.float().numpy()
    w = _bf16(want_f32)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(mag, 1e-30))[1] - 8)  # bf16 spacing at mag
    bad = np.abs(g - w) > ulp + slack
    assert not bad.any(), f"{int(bad.sum())} of {g.size} values off by more than one bf16 ulp"


# -- (a) K5 against the Pallas kernel -----------------------------------------


@pytest.mark.parametrize("kgroup", [1, 8])
def test_gram_proj_plain_matches_pallas_k5(kgroup):
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from tools.exp_pmg_projkernel import make_proj_kernel

    b, np_, c, k = 2, 4, 16, 32
    rng = np.random.RandomState(kgroup)
    patches = rng.randn(b, np_, 10, c).astype(np.float32)
    gram = _bf16(np.einsum("bpnc,bpnd->bpcd", patches, patches) / 10.0)  # symmetric
    w = _bf16(rng.randn(c * c, k).astype(np.float32) / c)  # c-major, as token_proj
    bias = rng.randn(k).astype(np.float32)
    w2 = w.reshape(c, c, k).transpose(1, 0, 2).reshape(c * c, k)  # the tool's d-major copy
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with unittest.mock.patch.object(pl, "pallas_call", interpret):
        proj = make_proj_kernel(b, np_, c, k, kgroup)
        want = np.asarray(proj(jnp.asarray(gram, jnp.bfloat16), jnp.asarray(w2, jnp.bfloat16),
                               jnp.asarray(bias[None, :])))
    got = ck.gram_proj(torch.from_numpy(gram.reshape(b, np_, c * c)).to(BF16),
                       torch.from_numpy(w).to(BF16), torch.from_numpy(bias))
    assert got.dtype == torch.float32 and got.shape == (b, np_, k)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# -- (b) single bf16 ops against JAX float32, rounded --------------------------


def test_linear_bf16_matches_jax_rounded():
    import jax.numpy as jnp

    from wadt.ops.nn import linear as jlinear

    rng = np.random.RandomState(1)
    x = _bf16(rng.randn(3, 5, 48).astype(np.float32))
    p = {"w": _bf16(rng.randn(48, 24).astype(np.float32) / 7), "b": _bf16(rng.randn(24).astype(np.float32))}
    want = np.asarray(jlinear(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()}))
    got = tnn.linear(torch.from_numpy(x).to(BF16), {n: torch.from_numpy(v).to(BF16) for n, v in p.items()})
    _assert_within_one_ulp(got, want)


@pytest.mark.parametrize("k,stride,pad,bias", [(4, 4, 0, False), (1, 1, 0, True), (4, 2, 1, True),
                                               (3, 1, 1, False)])
def test_conv2d_bf16_matches_jax_rounded(k, stride, pad, bias):
    """Both conv routes: space-to-depth + matmul (k = s, pad 0) and F.conv2d."""
    import jax.numpy as jnp

    from wadt.ops.nn import conv2d as jconv2d

    rng = np.random.RandomState(k * 10 + stride)
    x = _bf16(rng.randn(2, 18, 17, 8).astype(np.float32))
    p = {"w": _bf16(rng.randn(k, k, 8, 12).astype(np.float32) * 0.2)}
    if bias:
        p["b"] = _bf16(rng.randn(12).astype(np.float32))
    want = np.asarray(jconv2d(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()}, stride, pad))
    got = tnn.conv2d(torch.from_numpy(x).to(BF16), {n: torch.from_numpy(v).to(BF16) for n, v in p.items()},
                     stride, pad)
    _assert_within_one_ulp(got, want)


@pytest.mark.parametrize("h,w,c,div", [(14, 14, 32, 3), (7, 5, 16, 2)])
def test_patch_gram_tokens_bf16_matches_jax_rounded(h, w, c, div):
    import jax.numpy as jnp

    from wadt.ops.gram import patch_gram_tokens as jtokens

    x = _bf16(np.random.RandomState(h + c).randn(2, h, w, c).astype(np.float32))
    want = np.asarray(jtokens(jnp.asarray(x), div))
    got = patch_gram_tokens(torch.from_numpy(x).to(BF16), div)
    _assert_within_one_ulp(got, want)


def test_cast_tree_casts_every_float_leaf():
    tree = {"a": torch.ones(2), "n": {"mean": torch.zeros(3), "var": torch.ones(3)},
            "l": [torch.ones(1), torch.ones(1, dtype=torch.int8)], "q": torch.randn(2, 2)}
    out = tnn.cast_tree(tree, BF16)
    assert out["a"].dtype == out["n"]["mean"].dtype == out["n"]["var"].dtype == BF16
    assert out["l"][0].dtype == BF16 and out["l"][1].dtype == torch.int8
    assert out["q"].dtype == BF16 and tree["q"].dtype == torch.float32
    assert tnn.cast_tree(tree, None) is tree


def test_normalize_uint8_bf16_runs_in_bf16():
    import jax.numpy as jnp

    from wadt.ops.preprocess import normalize_uint8 as jnormalize

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        normalize_uint8,
    )

    u8 = np.random.RandomState(3).randint(0, 256, (2, 5, 5, 3), np.uint8)
    got = normalize_uint8(torch.from_numpy(u8), BF16)
    want = np.asarray(jnormalize(jnp.asarray(u8), jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)


# -- (c) the Engine's params contract -----------------------------------------


def _models(family, seed=0):
    """The same random tiny model in both packages."""
    import jax

    from wadt.models import get_family as jfamily

    jmod = jfamily(family)
    jspec = jmod.build_spec(TASKS, TINY[family])
    jparams = jmod.init(jax.random.PRNGKey(seed), jspec)
    tspec = get_family(family).build_spec(TASKS, TINY[family])
    return jspec, jparams, tspec, tckpt.params_from_jax(jparams, tspec)


def test_engine_bf16_params_stay_f32():
    """As tests/test_misc_paths.py:60 requires of the JAX Engine: params
    stay float32, the run copy is bf16, and assigning params derives it
    anew (with the stem fold, which is built from the run copy)."""
    _, _, tspec, tparams = _models("pmg")
    eng = Engine("pmg", tspec, tparams, batch_size=4, dtype=BF16, device="cpu")
    assert eng.params["queries"].dtype == torch.float32
    assert eng._run_params["queries"].dtype == BF16
    assert eng._run_params["trunk"][0]["norm"]["mean"].dtype == BF16
    stem = eng._stem
    assert stem["w"].dtype == torch.float32  # bf16-valued, held in float32 for the stem kernel
    torch.testing.assert_close(stem["w"], stem["w"].to(BF16).float(), atol=0, rtol=0)
    _, _, _, other = _models("pmg", seed=1)
    eng.params = other
    assert eng.params["heads"]["w"].dtype == torch.float32
    assert eng._run_params["heads"]["w"].dtype == BF16
    torch.testing.assert_close(eng._run_params["heads"]["w"], other["heads"]["w"].to(BF16))
    assert not torch.equal(eng._stem["w"], stem["w"])
    with pytest.raises(ValueError, match="dtype"):
        Engine("pmg", tspec, tparams, dtype=torch.float16, device="cpu")


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_bf16_packed_trunk_features_equal_the_old_chain(norm):
    """The bf16 trunk from uint8, with the stem's cast, batch norm and
    LeakyReLU now in the stem (its plain version here), gives the bits of
    the chain that ran them as separate bf16 passes: the float32 stem with
    the identity affine, ``.to(bf16)``, ``batch_norm_infer`` recomputing
    its affine on the bf16 params, ``leaky_relu``; then the other blocks."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.norms import (
        apply_norm,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        packed_affine,
    )

    spec = pmg.build_spec(TASKS, {**TINY["pmg"], "norm": norm})
    rng = np.random.RandomState(11)
    params = {"trunk": [{
        "conv": {"w": torch.from_numpy(rng.randn(b.kernel, b.kernel, b.cin, b.cout).astype(np.float32)
                                       * (b.kernel * b.kernel * b.cin) ** -0.5)},
        "norm": {n: torch.from_numpy(v.astype(np.float32)) for n, v in {
            "scale": rng.rand(b.cout) + 0.5, "bias": rng.randn(b.cout) * 0.1,
            "mean": rng.randn(b.cout) * 0.1, "var": rng.rand(b.cout) + 0.5}.items()}}
        for b in spec.plan]}
    p16 = tnn.cast_tree(params, BF16)
    x8 = torch.from_numpy(rng.randint(0, 256, (3, 64, 64, 3), np.uint8))
    got = pmg.packed_trunk_features(p16, x8, spec, dtype=BF16)

    b0 = spec.plan[0]
    k = b0.kernel
    p0 = p16["trunk"][0]
    w0f = p0["conv"]["w"].reshape(-1, b0.cout).float()
    scale, shift = (torch.as_tensor(a) for a in packed_affine(k))
    bias = -(shift @ w0f)
    wf = (scale[:, None] * w0f).to(BF16).float()
    y = ck.stem_plain(x8, wf, torch.ones_like(bias), bias, k, leaky=False)
    y = tnn.leaky_relu(apply_norm(y.to(BF16), p0["norm"], spec.norm), 0.2)
    for pp, bk in zip(p16["trunk"][1:], spec.plan[1:]):
        y = tnn.conv2d(y, pp["conv"], stride=bk.stride, padding=bk.pad)
        y = tnn.leaky_relu(apply_norm(y, pp["norm"], spec.norm), 0.2)
    assert got.dtype == BF16 and got.shape == y.shape
    assert torch.equal(got.view(torch.int16), y.view(torch.int16))


# -- (d) the bf16 Engine against the JAX float32 Engine ------------------------


@pytest.mark.parametrize("family", ["pmg", "pm", "rtm"])
def test_bf16_engine_matches_jax_f32_engine(family):
    from wadt.engine.executor import Engine as JEngine

    jspec, jparams, tspec, tparams = _models(family)
    frames = np.random.RandomState(7).randint(0, 256, (6, 64, 64, 3), np.uint8)
    keys = ("probs", "preds", "logits")
    want = JEngine(family, jspec, jparams, batch_size=4, prob_threshold=0.0).run(frames, collect=keys)
    eng = Engine(family, tspec, tparams, batch_size=4, prob_threshold=0.0, dtype=BF16, device="cpu")
    got = eng.run(frames, collect=keys)
    f32 = Engine(family, tspec, tparams, batch_size=4, prob_threshold=0.0, device="cpu").run(frames)
    wp = np.asarray(want["probs"])
    assert got["probs"].dtype == np.float32 and got["logits"].dtype == np.float32
    drift = np.abs(got["probs"] - wp).max()
    assert drift <= PROB_DRIFT, drift
    assert not np.array_equal(got["probs"], f32["probs"])  # bf16 really ran
    top2 = np.sort(wp, axis=-1)
    decisive = top2[..., -1] - top2[..., -2] > 2 * PROB_DRIFT
    np.testing.assert_array_equal(got["preds"][decisive], np.asarray(want["preds"])[decisive])
    np.testing.assert_allclose(got["probs"].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("packed", ["auto", "off"])
def test_bf16_pmg_packed_and_float_paths_agree(packed):
    """The uint8 stem path (K2 with the identity affine, then batch norm in
    bf16) and the float path (bf16 normalize, bf16 conv) differ only in
    where the first conv's inputs are rounded."""
    _, _, tspec, tparams = _models("pmg")
    frames = np.random.RandomState(8).randint(0, 256, (4, 64, 64, 3), np.uint8)
    eng = Engine("pmg", tspec, tparams, batch_size=4, dtype=BF16, device="cpu", packed=packed)
    assert (eng.pack_k is None) == (packed == "off")
    ref = Engine("pmg", tspec, tparams, batch_size=4, device="cpu").run(frames)["probs"]
    assert np.abs(eng.run(frames)["probs"] - ref).max() <= PROB_DRIFT


def test_bf16_capture_taps_come_back_float32():
    _, _, tspec, tparams = _models("pmg")
    frames = np.random.RandomState(9).randint(0, 256, (2, 64, 64, 3), np.uint8)
    eng = Engine("pmg", tspec, tparams, batch_size=2, dtype=BF16, device="cpu",
                 capture=("features", "tokens", "pooled"))
    out = eng.run(frames, collect=("features", "tokens", "pooled"))
    assert out["tokens"].dtype == np.float32 and out["tokens"].shape == (2, 9, 32)
    np.testing.assert_array_equal(out["pooled"], _bf16(out["pooled"]))  # bf16-valued


@pytest.mark.parametrize("name", ["pmg_shipped", "pm_small", "rtm_trunc5_attn"])
def test_loaded_params_are_contiguous(name):
    """Checkpoint leaves come out contiguous (transposed weights copied in
    their new order), as the kernels take them: ``token_proj`` goes to K5
    as it is loaded."""
    import json
    import os

    from tests.conftest import FIXTURES

    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    spec = get_family(meta["family"]).build_spec(meta["tasks"], meta["hparams"])
    params = tckpt.load_torch_checkpoint(meta["family"], os.path.join(FIXTURES, f"{name}.pth"), spec)
    leaves = tnn.cast_tree(params, BF16)

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from walk(v)
        elif isinstance(t, list):
            for v in t:
                yield from walk(v)
        else:
            yield t

    assert all(t.is_contiguous() for t in walk(leaves))


def test_load_engine_passes_dtype(tmp_path):
    import json
    import os

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from tests.conftest import FIXTURES

    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    eng = port.load_engine("pmg", os.path.join(FIXTURES, "pmg_shipped.pth"), meta["tasks"],
                           meta["hparams"], batch_size=2, dtype=BF16, device="cpu")
    assert eng.dtype == BF16 and eng._run_params["token_proj"]["w"].dtype == BF16


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pmg", "pm", "rtm"])
def test_bf16_engine_on_card_matches_cpu(family, cuda_device):
    _, _, tspec, tparams = _models(family)
    frames = np.random.RandomState(7).randint(0, 256, (6, 64, 64, 3), np.uint8)
    ck.reset_launches()
    got = Engine(family, tspec, tparams, batch_size=4, dtype=BF16).run(frames)
    if family == "pmg":
        assert ck.LAUNCHES["gram_proj"] == 2 and ck.LAUNCHES["patch_gram"] == 2
    want = Engine(family, tspec, tparams, batch_size=4, dtype=BF16, device="cpu").run(frames)
    assert np.abs(got["probs"] - want["probs"]).max() <= PROB_DRIFT


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
def test_linear_bf16_on_card_within_one_ulp(bias, cuda_device):
    """One cuBLAS call on the card (parity mode: no bf16 split-K sums) keeps
    the rule: the float32 product plus bias, rounded once.  cuBLAS sums in
    another order than numpy: K * 2^-24 of the sum of |terms| is allowed
    beyond the ulp, which matters only where the terms cancel."""
    rng = np.random.RandomState(2)
    x = _bf16(rng.randn(4, 9, 192).astype(np.float32))
    p = {"w": _bf16(rng.randn(192, 384).astype(np.float32) / 14)}
    if bias:
        p["b"] = _bf16(rng.randn(384).astype(np.float32))
    want = x @ p["w"] + p.get("b", 0.0)
    got = tnn.linear(torch.from_numpy(x).to(cuda_device, BF16),
                     {n: torch.from_numpy(v).to(cuda_device, BF16) for n, v in p.items()})
    _assert_within_one_ulp(got.cpu(), want, slack=192 * 2.0 ** -24 * (np.abs(x) @ np.abs(p["w"])))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_bf16_stem_on_card_rounds_as_the_chain(norm, cuda_device):
    """The bf16 stem kernel: its sum rounded to bf16 (y0) within one bf16
    ulp of the plain version's, and, for batch norm, the norm and LeakyReLU
    in the kernel bit for bit the bf16 chain applied to the kernel's own y0."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg

    spec = pmg.build_spec(TASKS, {**TINY["pmg"], "norm": norm})
    _, _, _, tparams = _models("pmg")
    p16 = tnn.cast_tree(to_device(tparams, cuda_device), BF16)
    st = pmg.fold_stem(p16, spec, BF16)
    x8 = torch.from_numpy(np.random.RandomState(12).randint(0, 256, (4, 64, 64, 3), np.uint8)).to(cuda_device)
    k = spec.plan[0].kernel
    y0 = ck.stem(x8, st["w"], None, None, k, leaky=False, out_dtype=BF16, bias=st["bias"])
    want = ck.stem_plain(x8, st["w"], None, None, k, leaky=False, out_dtype=BF16, bias=st["bias"])
    torch.testing.assert_close(y0.float(), want.float(), atol=2e-4, rtol=2.0 ** -7)
    if norm == "batch":
        y = ck.stem(x8, st["w"], st["scale"], st["shift"], k, out_dtype=BF16, bias=st["bias"])
        chain = tnn.leaky_relu(y0 * st["scale"] + st["shift"], 0.2)
        assert torch.equal(y.view(torch.int16), chain.view(torch.int16))
