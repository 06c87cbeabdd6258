"""The port's CUDA kernel module on the CPU: each kernel's plain PyTorch
version against the JAX package's Pallas kernel (interpret mode) and its
XLA reference, on the same numpy inputs; the wrappers' CPU routing and
launch counts; and the failures that must raise rather than fall back.

The kernels themselves run only on a CUDA card: ``test_kernel_matches_plain_on_card``
holds them against their plain versions there and skips elsewhere.
"""

import numpy as np
import pytest
import torch

import wadt  # noqa: F401
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg as tpmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import gram as tgram
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import norms as tnorms
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import leaky_relu as tleaky_relu

GRAM_SHAPES = [(14, 14, 96, 3), (8, 8, 32, 4), (7, 5, 16, 2)]


@pytest.mark.parametrize("h,w,c,div", GRAM_SHAPES)
def test_gram_plain_matches_pallas_and_xla(h, w, c, div):
    import jax.numpy as jnp

    from wadt.ops.gram import patch_gram_tokens
    from wadt.ops.pallas_kernels import patch_gram_tokens_pallas

    x = np.random.RandomState(h * 100 + c).randn(2, h, w, c).astype(np.float32)
    got = ck.patch_gram_plain(torch.from_numpy(x), div).numpy()
    want_pallas = np.asarray(patch_gram_tokens_pallas(jnp.asarray(x), div, interpret=True))
    want_xla = np.asarray(patch_gram_tokens(jnp.asarray(x), div))
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_xla, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w,c,div", GRAM_SHAPES)
def test_split_and_pad_match_jax(h, w, c, div):
    """Replicate pad and row-major patch order, element for element."""
    import jax.numpy as jnp

    from wadt.ops import gram as jgram

    x = np.random.RandomState(7).randn(2, h, w, c).astype(np.float32)
    got, area = tgram.split_patches(torch.from_numpy(x), div)
    want, want_area = jgram.split_patches(jnp.asarray(x), div)
    assert area == want_area
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stem_case(leaky):
    """test_pallas.py's fused_stem setup: uint8 [2,32,32,3], k 4, 16 channels."""
    rng = np.random.RandomState(1)
    b, h, k, cout = 2, 32, 4, 16
    imgs = rng.randint(0, 256, (b, h, h, 3), np.uint8)
    conv_w = rng.randn(k, k, 3, cout).astype(np.float32) * 0.1
    bn = {
        "scale": rng.rand(cout).astype(np.float32) + 0.5,
        "bias": rng.randn(cout).astype(np.float32) * 0.1,
        "mean": rng.randn(cout).astype(np.float32) * 0.1,
        "var": rng.rand(cout).astype(np.float32) + 0.5,
    }
    return imgs, conv_w, bn, k


def _port_stem_operands(conv_w, bn, k, norm="batch"):
    """The port's own fold (pmg.fold_stem) of a one-block plan."""
    spec = tpmg.Spec(tasks=None, ndf=conv_w.shape[-1], patch_size=8, norm=norm)
    assert spec.plan[0].kernel == k
    params = {"trunk": [{"conv": {"w": torch.from_numpy(conv_w)},
                         "norm": {n: torch.from_numpy(v) for n, v in bn.items()}}]}
    return tpmg.fold_stem(params, spec)


def test_stem_plain_matches_fused_stem():
    import jax.numpy as jnp

    from wadt.config import IMAGENET_MEAN, IMAGENET_STD
    from wadt.ops.pallas_kernels import fused_stem

    imgs, conv_w, bn, k = _stem_case(True)
    inv = bn["scale"] / np.sqrt(bn["var"] + 1e-5)
    want = fused_stem(
        jnp.asarray(imgs), jnp.asarray(conv_w), jnp.asarray(inv),
        jnp.asarray(bn["bias"] - bn["mean"] * inv),
        IMAGENET_MEAN, IMAGENET_STD, stride=k, interpret=True,
    )
    op = _port_stem_operands(conv_w, bn, k)
    got = ck.stem_plain(torch.from_numpy(imgs), op["w"], op["scale"], op["shift"], k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_stem_plain_identity_affine_matches_conv():
    """The instance/group-norm split: no affine, no activation -> the raw
    normalized conv of the JAX package."""
    import jax.numpy as jnp

    from wadt.ops.nn import conv2d
    from wadt.ops.preprocess import normalize_uint8

    imgs, conv_w, bn, k = _stem_case(False)
    want = conv2d(normalize_uint8(jnp.asarray(imgs)), {"w": jnp.asarray(conv_w)}, stride=k)
    op = _port_stem_operands(conv_w, bn, k, norm="instance")
    got = ck.stem_plain(torch.from_numpy(imgs), op["w"], op["scale"], op["shift"], k, leaky=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def _bf16_chain(acc, bias, s, t, leaky=True):
    """The bf16 path's chain as PyTorch runs it on bf16 tensors: the float32
    sum plus bias cast, then ``batch_norm_infer``'s ``y * s + t`` and the
    LeakyReLU, each a bf16 operation."""
    y = (acc + bias).to(torch.bfloat16)
    if s is not None:
        y = y * s + t
    return tleaky_relu(y, 0.2) if leaky else y


def _emulated_epilogue(acc, bias, s, t, leaky=True):
    """csrc/stem.cu's bf16 epilogue in float32 tensors, rounded to bf16
    after each step: one float32 operation and one round to nearest even
    per step, as ``__fadd_rn`` / ``__fmul_rn`` and ``__float2bfloat16_rn``
    compute it."""
    def r(v):
        return v.to(torch.bfloat16).float()

    y = r(acc + bias)
    if s is not None:
        y = r(r(y * s.float()) + t.float())
    if leaky:
        y = torch.where(y >= 0, y, r(y * 0.2))
    return y


def _near_midpoints(n, rng):
    """float32 values at bf16 rounding midpoints and one float32 ulp either
    side of them, of both signs and across exponents."""
    base = torch.from_numpy((rng.randn(n) * 4.0 ** rng.randint(-6, 6, n)).astype(np.float32))
    base = base.to(torch.bfloat16).float()
    mid = base + torch.sign(base) * torch.ldexp(torch.ones(n), torch.frexp(base).exponent - 9)
    up = torch.nextafter(mid, torch.full_like(mid, float("inf")))
    down = torch.nextafter(mid, torch.full_like(mid, -float("inf")))
    return torch.cat([mid, up, down])


@pytest.mark.parametrize("case", ["seeded", "zeros", "negatives", "midpoints"])
@pytest.mark.parametrize("norm", [True, False], ids=["batch_norm", "no_norm"])
def test_stem_bf16_epilogue_emulation_equals_bf16_chain(case, norm):
    """The kernel's bf16 epilogue, step by step in float32 with a rounding
    after each, gives the PyTorch bf16 chain's bits, on seeded values,
    zeros, negatives and sums one float32 ulp either side of bf16 rounding
    midpoints (the sum, the product y0 * s and y1 + t all meet ties)."""
    rng = np.random.RandomState(["seeded", "zeros", "negatives", "midpoints"].index(case))
    c = 32
    if case == "midpoints":
        acc = _near_midpoints(3 * 64 * c, rng).reshape(-1, c)
        bias = torch.zeros(c)
    else:
        acc = torch.from_numpy(rng.randn(512, c).astype(np.float32) * 3)
        bias = torch.from_numpy(rng.randn(c).astype(np.float32))
        if case == "zeros":
            acc, bias = torch.zeros_like(acc), torch.zeros_like(bias)
            acc[::2] = -0.0
        elif case == "negatives":
            acc, bias = -acc.abs() - 1, -bias.abs()
    bn = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) for k, v in {
        "scale": rng.rand(c) + 0.5, "bias": rng.randn(c) * 0.1,
        "mean": rng.randn(c) * 0.1, "var": rng.rand(c) + 0.5}.items()}
    s, t = tnorms.batch_norm_affine(bn) if norm else (None, None)
    if norm:
        assert s.dtype == t.dtype == torch.bfloat16
    want = _bf16_chain(acc, bias, s, t)
    got = _emulated_epilogue(acc, bias, s, t)
    assert torch.equal(got.view(torch.int32), want.float().view(torch.int32))


def _bf16_stem_case(norm="batch"):
    """The bf16 fold of _stem_case's block on a bf16 tree."""
    imgs, conv_w, bn, k = _stem_case(True)
    spec = tpmg.Spec(tasks=None, ndf=conv_w.shape[-1], patch_size=8, norm=norm)
    params = {"trunk": [{"conv": {"w": torch.from_numpy(conv_w).to(torch.bfloat16)},
                         "norm": {n: torch.from_numpy(v).to(torch.bfloat16) for n, v in bn.items()}}]}
    return torch.from_numpy(imgs), tpmg.fold_stem(params, spec, torch.bfloat16), params, k


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_stem_plain_bf16_is_the_old_chain(norm):
    """bf16 stem_plain = the float32 stem with the identity affine, cast to
    bf16, then (batch norm) ``batch_norm_infer`` on the bf16 params and the
    LeakyReLU: the chain the bf16 path ran before the kernel took it in."""
    x8, st, params, k = _bf16_stem_case(norm)
    assert (st["scale"] is None) == (norm != "batch")
    fused = norm == "batch"
    got = ck.stem_plain(x8, st["w"], st["scale"], st["shift"], k, leaky=fused,
                        out_dtype=torch.bfloat16, bias=st["bias"])
    cout = st["w"].shape[1]
    want = ck.stem_plain(x8, st["w"], torch.ones(cout), st["bias"], k, leaky=False).to(torch.bfloat16)
    if fused:
        want = tleaky_relu(tnorms.batch_norm_infer(want, params["trunk"][0]["norm"]), 0.2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_stem_bf16_cpu_takes_plain_version_and_checks_its_operands():
    x8, st, _, k = _bf16_stem_case()
    ck.reset_launches()
    args = (x8, st["w"], st["scale"], st["shift"], k)
    got = ck.stem(*args, out_dtype=torch.bfloat16, bias=st["bias"])
    assert ck.LAUNCHES["stem"] == 0
    assert torch.equal(got, ck.stem_plain(*args, out_dtype=torch.bfloat16, bias=st["bias"]))
    with pytest.raises(ValueError, match="bias"):
        ck.stem(*args, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="both or neither"):
        ck.stem(x8, st["w"], st["scale"], None, k, out_dtype=torch.bfloat16, bias=st["bias"])
    with pytest.raises(ValueError, match="no bias"):
        ck.stem(*args, bias=st["bias"])
    with pytest.raises(ValueError, match="out_dtype"):
        ck.stem(*args, out_dtype=torch.float16, bias=st["bias"])


def _gram_call():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 7, 5, 16).astype(np.float32))
    return ck.patch_gram, (x, 2), ck.patch_gram_plain


def _stem_call():
    imgs, conv_w, bn, k = _stem_case(True)
    op = _port_stem_operands(conv_w, bn, k)
    args = (torch.from_numpy(imgs), op["w"], op["scale"], op["shift"], k)
    return ck.stem, args, ck.stem_plain


def _small_pmg():
    import jax

    from wadt.models import pmg as jpmg

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint as tckpt,
    )

    hp = dict(ndf=8, patch_size=64, patch_div=3, gram_channels=16, d_model=32,
              transformer_layers=1, transformer_heads=2)
    tasks = {"a": ["x", "y", "z"], "b": ["p", "q"]}
    spec = tpmg.build_spec(tasks, hp)
    return spec, tckpt.params_from_jax(jpmg.init(jax.random.PRNGKey(0), jpmg.build_spec(tasks, hp)), spec)


def _trunk_gram_call():
    spec, params = _small_pmg()
    imgs = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 64, 64, 3), np.uint8))
    return ck.fused_trunk_gram, (imgs, ck.fold_trunk_gram_weights(params, spec), spec), \
        ck.fused_trunk_gram_plain


def _head_call():
    spec, params = _small_pmg()
    tokens = torch.from_numpy(np.random.RandomState(3).randn(2, 9, 256).astype(np.float32))
    return ck.fused_head, (tokens, tpmg.fold_head_weights(params, spec, "q8"), spec), \
        ck.fused_head_plain


def _dequant_call():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 3, 40).astype(np.float32))
    w8 = torch.from_numpy(rng.randint(-127, 128, (3, 40, 24)).astype(np.int8))
    scale = torch.from_numpy(rng.rand(3, 24).astype(np.float32) * 0.01)
    return ck.dequant_matvec, (x, w8, scale), ck.dequant_matvec_plain


def _gram_proj_call():
    rng = np.random.RandomState(5)
    g = torch.from_numpy(rng.randn(2, 9, 256).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(256, 40).astype(np.float32) * 0.06).to(torch.bfloat16)
    b = torch.from_numpy(rng.randn(40).astype(np.float32))
    return ck.gram_proj, (g, w, b), ck.gram_proj_plain


def _gram_proj_two_bands_call():
    """M = 150: a second, ragged band of output rows; bf16 output."""
    rng = np.random.RandomState(8)
    g = torch.from_numpy(rng.randn(3, 50, 512).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(512, 64).astype(np.float32) * 0.05).to(torch.bfloat16)
    b = torch.from_numpy(rng.randn(64).astype(np.float32))
    return ck.gram_proj, (g, w, b, torch.bfloat16), ck.gram_proj_plain


def _gram_bf16_call():
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 7, 5, 16).astype(np.float32))
    return ck.patch_gram, (x.to(torch.bfloat16), 2), ck.patch_gram_plain


CASES = [_gram_call, _stem_call, _trunk_gram_call, _head_call, _dequant_call, _gram_proj_call]
CASE_IDS = ["patch_gram", "stem", "fused_trunk_gram", "fused_head", "dequant_matvec", "gram_proj"]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_cpu_tensor_takes_plain_version(case):
    wrapper, args, plain = case()
    ck.reset_launches()
    got = wrapper(*args)
    assert ck.LAUNCHES == dict.fromkeys(CASE_IDS, 0)
    torch.testing.assert_close(got, plain(*args), atol=0, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_other_devices_raise(case):
    """Neither CPU nor CUDA: the wrapper raises instead of picking a path."""
    wrapper, args, _ = case()
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)
    with pytest.raises(ValueError, match="not supported"):
        wrapper(*meta)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ck.build()


def test_batch_norm_affine_matches_infer():
    rng = np.random.RandomState(3)
    p = {n: torch.from_numpy(rng.rand(8).astype(np.float32) + 0.5)
         for n in ("scale", "bias", "mean", "var")}
    x = torch.from_numpy(rng.randn(2, 3, 3, 8).astype(np.float32))
    s, t = tnorms.batch_norm_affine(p)
    torch.testing.assert_close(x * s + t, tnorms.batch_norm_infer(x, p))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


def test_gram_proj_plain_is_the_bf16_linear():
    """K5's plain version is ``linear`` on the bf16 Gram before its one
    rounding: bf16 products summed in float32, the bias added in float32."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import linear

    _, (g, w, b), _ = _gram_proj_call()
    y = ck.gram_proj_plain(g, w, b)
    assert y.dtype == torch.float32 and y.shape == (2, 9, 40)
    torch.testing.assert_close(y.to(torch.bfloat16), linear(g, {"w": w, "b": b}), atol=0, rtol=0)


def test_patch_gram_keeps_bf16_and_rounds_once():
    """bf16 in, bf16 out: the float32 Gram of the same values, rounded once."""
    _, (x, div), _ = _gram_bf16_call()
    got = ck.patch_gram(x, div)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ck.patch_gram_plain(x.float(), div).to(torch.bfloat16),
                               atol=0, rtol=0)


def _to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, device) for v in x)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("case", [_gram_call, _stem_call, _gram_proj_call, _gram_bf16_call,
                                  _head_call, _gram_proj_two_bands_call],
                         ids=["patch_gram", "stem", "gram_proj", "patch_gram_bf16", "fused_head",
                              "gram_proj_two_bands"])
def test_kernel_matches_plain_on_card(case, cuda_device):
    wrapper, args, plain = case()
    args = _to_device(args, cuda_device)
    ck.reset_launches()
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert sum(ck.LAUNCHES.values()) == 1
    want = plain(*args)
    assert torch.equal(wrapper(*args), got)  # no order that depends on the run
    if case is _head_call:  # csrc/head.cu's float32 sums in another order
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
    elif case is _gram_proj_two_bands_call:  # float32 sums in another order, rounded once:
        # one bf16 ulp apart at most (2^-7 of the value), 1e-4 x max|y| near zero
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=1e-4 * float(want.float().abs().max()), rtol=2 ** -7)
    elif case is _gram_proj_call:  # float32 sums in another order: 1e-4 x max|y|
        torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)
    elif case is _gram_bf16_call:  # one rounding of the same float32 sums
        torch.testing.assert_close(got.float(), want.float(), atol=0, rtol=2 ** -8)
    else:
        tol = 1e-5 if wrapper is ck.patch_gram else 2e-4
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(260, 40), (256, 36)])
def test_gram_proj_refuses_k_or_n_off_eight_on_card(k, n, cuda_device):
    """K5 copies 16-byte runs of bf16: K and N not multiples of 8 raise."""
    g = torch.zeros((2, 9, k), dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros((k, n), dtype=torch.bfloat16, device=cuda_device)
    b = torch.zeros((n,), dtype=torch.float32, device=cuda_device)
    ck.reset_launches()
    with pytest.raises(ValueError, match="multiples of 8"):
        ck.gram_proj(g, w, b)
    assert ck.LAUNCHES["gram_proj"] == 0
