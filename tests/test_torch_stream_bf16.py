"""The port's bf16 camera path on the CPU: ``StreamPredictor(dtype=bf16)``
on every route of PMG, PM and RTM against the JAX package's bf16
``StreamPredictor`` (its fused route with the Pallas kernels in interpret
mode; PMG's generic route against its packed step, the JAX package having
no generic PMG camera step), on the same params
(``params_from_jax``); the bf16 ``fold_stream_weights`` against the JAX
fold; and ``dequant_matvec``'s bf16 mode (K6) against the JAX camera
path's expression.

Tolerances: probabilities within 5e-3 of the JAX bf16 predictor (PERF.md
section 2's bf16 limit; the drift measured here is at most 1.9e-4, on
PMG's generic route, the bf16 roundings of the two packages' activations
differing in summation order); the ``fused`` route ignores ``dtype`` in both packages, so its
bf16 and float32 predictors are equal bit for bit; against the port's own
batch path (``Engine(dtype=bf16, batch_size=1)``, ``pmg.apply`` on the bf16
tree) the ``packed`` and ``generic`` routes are equal bit for bit.  The
kernels' own checks on the card are ``chip_smoke.py`` phase 22 and the
``cuda``-marked test below.
"""

import functools

import numpy as np
import pytest
import torch

import wadt  # noqa: F401
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    enable_parity_precision,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import checkpoint as tckpt
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    Engine,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm as tpm
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg as tpmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import rtm as trtm
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import cast_tree
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
    normalize_uint8,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream as tstream

from tests.test_torch_rtm import _leaves, _q8_close
from _torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
PROB_TOL = 5e-3  # PERF.md section 2: the bf16 limit in probability
K6_PLAIN_TOL = 1e-6  # times max|y|: the same products, summed in another order
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
HPARAMS = {
    # tests/test_torch_stream.py SMALL: the fused route takes it
    "pmg": dict(ndf=8, patch_size=64, patch_div=3, gram_channels=16, d_model=32,
                transformer_layers=1, transformer_heads=2, norm="batch"),
    # tests/test_explain_stream.py:378, with one hidden MLP layer so that the
    # int8 fold has an mlp_q8 layer
    "rtm": dict(truncate_layer=5, attn_token_dim=32, cls_hidden_dims=[24], cls_num_layers=1),
    # tests/test_torch_pm.py "instance_se": the PM headline's instance norm and SE
    "pm": dict(ndf=8, patch_size=16, norm="instance"),
}
CASES = [("pmg", "fused"), ("pmg", "packed"), ("pmg", "generic"),
         ("rtm", "generic"), ("rtm", "folded"), ("rtm", "folded_q8"), ("pm", "generic")]

enable_parity_precision()


def _perturb_bn(bn, rng):
    c = bn["mean"].shape[0]
    bn["mean"] = rng.randn(c).astype(np.float32) * 0.1
    bn["var"] = rng.rand(c).astype(np.float32) + 0.5


@functools.lru_cache(maxsize=None)
def _model(family):
    """The same random model in both packages, with non-trivial batch-norm
    statistics."""
    import jax

    from wadt.models import get_family as jget

    jmod = jget(family)
    jspec = jmod.build_spec(TASKS, HPARAMS[family])
    jparams = jmod.init(jax.random.PRNGKey(3), jspec)
    rng = np.random.RandomState(5)
    if family == "rtm":
        bb = jparams["backbone"]
        _perturb_bn(bb["bn1"], rng)
        for stage in ("layer1", "layer2", "layer3", "layer4"):
            for block in bb.get(stage, ()):
                for k in ("bn1", "bn2", "bn3"):
                    _perturb_bn(block[k], rng)
                if "downsample" in block:
                    _perturb_bn(block["downsample"]["bn"], rng)
    elif jspec.norm == "batch":
        for blk in jparams["trunk"]:
            _perturb_bn(blk["norm"], rng)
    tmod = {"pmg": tpmg, "rtm": trtm, "pm": tpm}[family]
    tspec = tmod.build_spec(TASKS, HPARAMS[family])
    return jspec, jparams, tspec, tckpt.params_from_jax(jparams, tspec)


def _frames(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 64, 64, 3), np.uint8)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX fused route's Pallas kernels in interpret mode, so that the
    JAX ``StreamPredictor`` itself runs on the CPU."""
    from wadt.ops import pallas_kernels as pk

    for name in ("fused_trunk_gram", "fused_head"):
        monkeypatch.setattr(pk, name, functools.partial(getattr(pk, name), interpret=True))


def _jax_predictor(family, route, use_kalman, dtype):
    import jax.numpy as jnp

    from wadt.workloads.stream import StreamPredictor as JStream

    jspec, jparams, _, _ = _model(family)
    jdtype = jnp.bfloat16 if dtype == BF16 else jnp.float32
    if family == "pmg" and route == "generic":
        # the JAX StreamPredictor has no generic PMG step (it packs wherever
        # the first block is non-overlapping, as every PMG plan's is), and
        # its pmg.apply does not trace in bf16 on the CPU: the reference is
        # its packed bf16 step, the same function with the first conv's
        # inputs rounded elsewhere
        route = "packed"
    kw = dict(head_fold="pallas_bf16") if route == "fused" else {}
    pred = JStream(family, jspec, jparams, use_kalman=use_kalman, dtype=jdtype,
                   trunk_kernel=route, **kw)
    return lambda f: np.asarray(pred(f))


@pytest.mark.parametrize("family,route", CASES, ids=[f"{f}-{r}" for f, r in CASES])
def test_bf16_stream_matches_jax_bf16_stream(family, route, interpret_pallas):
    """Every route of every family in bf16 against the JAX bf16 predictor,
    Kalman on, within 5e-3 in probability."""
    _, _, tspec, tparams = _model(family)
    want = _jax_predictor(family, route, True, BF16)
    kw = dict(head_fold="fused_bf16") if route == "fused" else {}
    pred = tstream.StreamPredictor(family, tspec, tparams, use_kalman=True, dtype=BF16,
                                   trunk_kernel=route, device="cpu", **kw)
    assert pred.route == route and pred.dtype == BF16
    drift = 0.0
    for i, f in enumerate(_frames(3, seed=20)):
        got = pred(f)
        assert got.dtype == np.float32 and pred.kstate.cov.dtype == torch.float32
        ref = want(f)
        drift = max(drift, float(np.abs(got - ref).max()))
        np.testing.assert_allclose(got, ref, atol=PROB_TOL, rtol=0, err_msg=f"frame {i}")
    print(f"{family}/{route}: bf16 port vs JAX max |dp| {drift:.2e}")


def test_fused_route_ignores_dtype_in_both_packages(interpret_pallas):
    """The fused route's folds carry their own types: its bf16 predictor is
    its float32 predictor, bit for bit, in the port and in the JAX package."""
    _, _, tspec, tparams = _model("pmg")
    preds = {d: tstream.StreamPredictor("pmg", tspec, tparams, use_kalman=True, dtype=d,
                                        trunk_kernel="fused", head_fold="fused_bf16", device="cpu")
             for d in (torch.float32, BF16)}
    jpreds = {d: _jax_predictor("pmg", "fused", True, d) for d in (torch.float32, BF16)}
    for f in _frames(2, seed=21):
        np.testing.assert_array_equal(preds[BF16](f), preds[torch.float32](f))
        np.testing.assert_array_equal(jpreds[BF16](f), jpreds[torch.float32](f))


@pytest.mark.parametrize("route", ["packed", "generic"])
def test_pmg_bf16_routes_equal_the_batch_path_at_batch_1(route):
    """With Kalman off, the packed route is ``Engine(dtype=bf16,
    batch_size=1)`` and the generic route ``pmg.apply`` on the bf16 tree and
    the bf16-normalized frame, bit for bit."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
        class_mask, masked_softmax,
    )

    _, _, tspec, tparams = _model("pmg")
    pred = tstream.StreamPredictor("pmg", tspec, tparams, dtype=BF16, trunk_kernel=route,
                                   device="cpu")
    eng = Engine("pmg", tspec, tparams, batch_size=1, dtype=BF16, device="cpu")
    mask = torch.as_tensor(class_mask(tspec.tasks))
    for f in _frames(2, seed=22):
        if route == "packed":
            want = eng.run(f[None])["probs"][0]
        else:
            logits, _ = tpmg.apply(cast_tree(tparams, BF16),
                                   normalize_uint8(torch.from_numpy(f[None]), BF16), tspec)
            want = masked_softmax(logits.float(), mask)[0].numpy()
        np.testing.assert_array_equal(pred(f), want)


def test_bf16_predictor_agrees_with_float32():
    """On every route the bf16 predictor's argmax is float32's on these frames
    (the batch path's bf16 gate, PERF.md section 2)."""
    pairs = agree = 0
    for family, route in CASES:
        _, _, tspec, tparams = _model(family)
        p32, p16 = (tstream.StreamPredictor(family, tspec, tparams, dtype=d, trunk_kernel=route,
                                            device="cpu") for d in (torch.float32, BF16))
        for f in _frames(4, seed=23):
            a, b = p32(f), p16(f)
            np.testing.assert_allclose(b, a, atol=5e-2, rtol=0, err_msg=f"{family}/{route}")
            pairs += len(tspec.tasks)
            agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    assert agree / pairs >= 0.995, (agree, pairs)


def test_bf16_fold_must_match_the_predictor_dtype():
    _, _, tspec, tparams = _model("rtm")
    f32 = trtm.fold_stream_weights(tparams, tspec, quantize_fold=True)
    f16 = trtm.fold_stream_weights(tparams, tspec, dtype=BF16, quantize_fold=True)
    with pytest.raises(ValueError, match="does not fit route"):
        tstream.StreamPredictor("rtm", tspec, f32, dtype=BF16, trunk_kernel="folded_q8", device="cpu")
    with pytest.raises(ValueError, match="does not fit route"):
        tstream.StreamPredictor("rtm", tspec, f16, trunk_kernel="folded_q8", device="cpu")
    pred = tstream.StreamPredictor("rtm", tspec, f16, dtype=BF16, trunk_kernel="folded_q8",
                                   device="cpu")
    assert pred.params["attn_fold_q8"].data_ptr() == f16["attn_fold_q8"].data_ptr()  # reused
    with pytest.raises(ValueError, match="dtype must be"):
        tstream.StreamPredictor("rtm", tspec, tparams, dtype=torch.float16, device="cpu")


# -- the bf16 fold -----------------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True], ids=["folded", "folded_q8"])
def test_bf16_fold_stream_weights_matches_jax(quantize):
    """Every leaf's type equal; the casts (backbone, mlp, final, stem) and the
    float32 ``attn_pq`` equal; the bf16 fold within one bf16 rounding of the
    float32 sums; the int8 entries equal except the +-1 boundary entries, the
    bf16 scales equal."""
    import jax.numpy as jnp

    from wadt.models import rtm as jrtm

    jspec, jparams, tspec, tparams = _model("rtm")
    jf = jrtm.fold_stream_weights(jparams, jspec, dtype=jnp.bfloat16, quantize_fold=quantize)
    tf = trtm.fold_stream_weights(tparams, tspec, dtype=BF16, quantize_fold=quantize)
    jl, tl = dict(_leaves(jf)), dict(_leaves(tf))
    assert sorted(jl) == sorted(tl)
    for path, a in jl.items():
        b = tl[path]
        a = np.asarray(a)
        assert str(b.dtype) == f"torch.{a.dtype}", path
        got = b.float().numpy() if b.dtype == BF16 else b.numpy()
        want = a.astype(np.float32) if b.dtype == BF16 else a
        if path[0] in ("backbone", "final", "stem_w", "mlp") or path[-1] == "b":
            np.testing.assert_array_equal(got, want, err_msg=str(path))
    assert tf["attn_pq"].dtype == torch.float32
    np.testing.assert_allclose(tf["attn_pq"].numpy(), np.asarray(jf["attn_pq"]), atol=1e-5, rtol=1e-5)
    if not quantize:
        # summed in float32 by both, then one rounding to bf16
        np.testing.assert_allclose(tf["attn_fold"].float().numpy(),
                                   np.asarray(jf["attn_fold"]).astype(np.float32), rtol=2 ** -8, atol=1e-6)
        return
    fold = np.einsum("tcd,tde->tce", np.asarray(jparams["attn"]["proj_w"], np.float64),
                     np.asarray(jparams["attn"]["out_w"], np.float64))
    scale32 = np.abs(fold).max(axis=1) / 127.0
    _q8_close(tf["attn_fold_q8"].numpy(), np.asarray(jf["attn_fold_q8"]), fold, scale32)
    # the scales: float32 amax / 127 rounded once to bf16
    np.testing.assert_array_equal(tf["attn_fold_scale"].float().numpy(),
                                  np.asarray(jf["attn_fold_scale"]).astype(np.float32))
    (tq,), (jq,) = tf["mlp_q8"], jf["mlp_q8"]
    np.testing.assert_array_equal(tq["w8"].numpy(), np.asarray(jq["w8"]))
    np.testing.assert_array_equal(tq["scale"].float().numpy(), np.asarray(jq["scale"]).astype(np.float32))


# -- K6's bf16 mode -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 12, 256, 256), (3, 2, 64, 40), (2, 5, 33, 17)],
                         ids=["camera-like", "batch-3", "ragged"])
def test_dequant_matvec_plain_bf16_matches_jax_expression(shape):
    """The plain version's bf16 mode against the JAX camera path's
    ``einsum(x, w8.astype(bf16) * scale)`` with float32 sums, at 1e-6 x
    max|y|; and not the factored ``(x @ w8) * scale``, which differs by far
    more."""
    import jax.numpy as jnp

    b, t, c, d = shape
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(b, t, c).astype(np.float32)
    w8 = rng.randint(-127, 128, (t, c, d)).astype(np.int8)
    scale = (rng.rand(t, d).astype(np.float32) + 0.5) * 1e-2
    jx, jscale = jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16)
    w = jnp.asarray(w8).astype(jnp.bfloat16) * jscale[:, None, :]
    # the bf16 operands upcast exactly: XLA's CPU dot takes bf16 x bf16 ->
    # float32 only at some shapes
    want = np.asarray(jnp.einsum("btc,tcd->btd", jx.astype(jnp.float32), w.astype(jnp.float32),
                                 precision="highest"))
    tx, tscale = torch.from_numpy(x).to(BF16), torch.from_numpy(scale).to(BF16)
    got = ck.dequant_matvec(tx, torch.from_numpy(w8), tscale)  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (b, t, d)
    ymax = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=K6_PLAIN_TOL * ymax, rtol=0)
    factored = ck.dequant_matvec_plain(tx.float(), torch.from_numpy(w8), tscale.float()).numpy()
    assert np.abs(factored - want).max() > 100 * K6_PLAIN_TOL * ymax


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("family,route", CASES, ids=[f"{f}-{r}" for f, r in CASES])
def test_bf16_stream_on_card_matches_cpu(family, route, cuda_device):
    """On the card each bf16 route launches its kernels (K6's bf16 mode on
    ``folded_q8``) and agrees with the CPU path within 5e-3."""
    _, _, tspec, tparams = _model(family)
    preds = {dev: tstream.StreamPredictor(family, tspec, tparams, dtype=BF16, trunk_kernel=route,
                                          device=dev) for dev in ("cpu", "cuda")}
    ck.reset_launches()
    for f in _frames(2, seed=24):
        np.testing.assert_allclose(preds["cuda"](f), preds["cpu"](f), atol=PROB_TOL, rtol=0)
    if route == "folded_q8":
        assert ck.LAUNCHES["dequant_matvec"] == 2 * (1 + len(tspec.mlp_dims) - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 12, 2048, 2048), (3, 5, 33, 17), (9, 3, 128, 64)],
                         ids=["camera", "ragged", "batch-9"])
def test_dequant_matvec_bf16_kernel_matches_plain_on_card(shape, cuda_device):
    """K6's bf16 mode against its plain version at 1e-4 x max|y| (K6's limit)."""
    b, t, c, d = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(cuda_device).to(BF16)
    w8 = torch.from_numpy(rng.randint(-127, 128, (t, c, d)).astype(np.int8)).to(cuda_device)
    scale = torch.from_numpy((rng.rand(t, d).astype(np.float32) + 0.5) * 1e-2).to(cuda_device).to(BF16)
    ck.reset_launches()
    got = ck.dequant_matvec(x, w8, scale)
    assert ck.LAUNCHES["dequant_matvec"] == 1
    want = ck.dequant_matvec_plain(x, w8, scale)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4 * float(want.abs().max()), rtol=0)
    with pytest.raises(ValueError, match="scale"):
        ck.dequant_matvec(x, w8, scale.float())
