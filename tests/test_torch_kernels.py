"""The port's CUDA kernel module on the CPU: each kernel's plain PyTorch
version against the JAX package's Pallas kernel (interpret mode) and its
XLA reference, on the same numpy inputs; the wrappers' CPU routing and
launch counts; and the failures that must raise rather than fall back.

The kernels themselves run only on a CUDA card: ``test_kernel_matches_plain_on_card``
holds them against their plain versions there and skips elsewhere.
"""

import types

import numpy as np
import pytest
import torch

import wadt  # noqa: F401
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg as tpmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import gram as tgram
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import norms as tnorms
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import leaky_relu as tleaky_relu
from _torch_threads import one_torch_thread  # noqa: F401

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


def _tsne_repulsion_call():
    y = torch.from_numpy(np.random.RandomState(9).randn(300, 2).astype(np.float32) * 10.0)
    return ck.tsne_repulsion, (y,), ck.tsne_repulsion_plain


def _hdbscan_points():
    """Seeded float32 points in three clusters, the last 5 repeating the first 5."""
    rng = np.random.RandomState(10)
    x = rng.randn(300, 7) + rng.randn(3, 7)[rng.randint(0, 3, 300)] * 4.0
    x[-5:] = x[:5]
    return torch.from_numpy(x.astype(np.float32))


def _hdbscan_core_call():
    return ck.hdbscan_core_distances, (_hdbscan_points(), 5), ck.hdbscan_core_distances_plain


def _hdbscan_mst_call():
    x = _hdbscan_points()
    return ck.hdbscan_prim_mst, (x, ck.hdbscan_core_distances_plain(x, 5)), ck.hdbscan_prim_mst_plain


def _bn_epilogue_call():
    """The downsample site: two norms, the sum and the ReLU."""
    rng = np.random.RandomState(12)
    x, d = (torch.from_numpy(rng.randn(2, 8, 5, 7).astype(np.float32)) for _ in range(2))

    def norm():
        return {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
            "scale": rng.rand(8) + 0.5, "bias": rng.randn(8), "mean": rng.randn(8),
            "var": rng.rand(8) + 0.5}.items()}

    return ck.bn_epilogue, (x, norm(), True, d, norm()), ck.bn_epilogue_plain


def _instance_norm_leaky_call():
    """A PM trunk site: the instance norm and LeakyReLU of an NHWC conv output."""
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(2, 5, 7, 8).astype(np.float32))
    p = {"scale": torch.from_numpy(rng.rand(8).astype(np.float32) + 0.5),
         "bias": torch.from_numpy(rng.randn(8).astype(np.float32))}
    return ck.instance_norm_leaky, (x, p, 0.2), ck.instance_norm_leaky_plain


def _bn_train_one_rank(x, p, relu, d, pd):
    """``bn_train`` outside its operator: the same steps, each its plain
    version on the CPU, with a one-rank mesh whose all-reduce returns its
    tensor."""
    return ck.bn_train(x, p, relu, d, pd, shard=types.SimpleNamespace(
        total=x.shape[0], all_reduce=lambda t: t))


def _bn_train_call():
    """The downsample site in train mode: two norms on batch statistics, the
    sum and the ReLU -> (y, both norms with new running statistics).  On
    the CPU the operator runs the card's steps as their plain versions."""
    rng = np.random.RandomState(13)
    x, d = (torch.from_numpy(rng.randn(2, 8, 5, 7).astype(np.float32)) for _ in range(2))

    def norm():
        return {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
            "scale": rng.rand(8) + 0.5, "bias": rng.randn(8), "mean": rng.randn(8),
            "var": rng.rand(8) + 0.5}.items()}

    return ck.bn_train, (x, norm(), True, d, norm()), _bn_train_one_rank


def _bn_train_backward_call():
    """The same site's gradients of x, the second norm's input and each
    norm's scale and bias: autograd through the operator's backward."""
    _, (x, p, relu, d, pd), _ = _bn_train_call()
    dy = torch.from_numpy(np.random.RandomState(14).randn(*x.shape).astype(np.float32))

    def grads(fn):
        def run(x, d, dy):
            leaves = [t.detach().requires_grad_() for t in (x, d, p["scale"], p["bias"],
                                                            pd["scale"], pd["bias"])]
            q = {**p, "scale": leaves[2], "bias": leaves[3]}
            qd = {**pd, "scale": leaves[4], "bias": leaves[5]}
            with torch.enable_grad():
                return torch.autograd.grad(fn(leaves[0], q, relu, leaves[1], qd)[0], leaves, dy)
        return run

    return grads(ck.bn_train), (x, d, dy), grads(_bn_train_one_rank)


CASES = [_gram_call, _stem_call, _trunk_gram_call, _head_call, _dequant_call, _gram_proj_call,
         _tsne_repulsion_call, _hdbscan_core_call, _hdbscan_mst_call, _bn_epilogue_call,
         _instance_norm_leaky_call, _bn_train_call, _bn_train_backward_call]
CASE_IDS = ["patch_gram", "stem", "fused_trunk_gram", "fused_head", "dequant_matvec", "gram_proj",
            "tsne_repulsion", "hdbscan_core", "hdbscan_mst", "bn_epilogue", "instance_norm_leaky",
            "bn_train", "bn_train_backward"]


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


def _stem_bf16_call():
    x8, st, _, k = _bf16_stem_case()
    return (lambda *a: ck.stem(*a[:5], out_dtype=torch.bfloat16, bias=a[5]),
            (x8, st["w"], st["scale"], st["shift"], k, st["bias"]),
            lambda *a: ck.stem_plain(*a[:5], out_dtype=torch.bfloat16, bias=a[5]))


def _bn_epilogue_flat_call():
    """``_bn_epilogue_call`` with the norms' vectors as arguments of their own."""
    _, (x, p, relu, d, pd), _ = _bn_epilogue_call()
    keys = tuple(p)

    def unflat(fn):
        return lambda x, d, *v: fn(x, dict(zip(keys, v[:4])), relu, d, dict(zip(keys, v[4:])))

    return unflat(ck.bn_epilogue), (x, d, *p.values(), *pd.values()), unflat(ck.bn_epilogue_plain)


def _instance_norm_leaky_flat_call():
    """``_instance_norm_leaky_call`` with scale and bias as arguments of their own."""
    _, (x, p, slope), _ = _instance_norm_leaky_call()

    def unflat(fn):
        return lambda x, s, b: fn(x, {"scale": s, "bias": b}, slope)

    return (unflat(ck.instance_norm_leaky), (x, p["scale"], p["bias"]),
            unflat(ck.instance_norm_leaky_plain))


OPERATOR_CASES = {
    "patch_gram": (_gram_call, "patch_gram"), "patch_gram_bf16": (_gram_bf16_call, "patch_gram"),
    "stem": (_stem_call, "stem"), "stem_bf16": (_stem_bf16_call, "stem"),
    "gram_proj": (_gram_proj_call, "gram_proj"),
    "gram_proj_bf16_out": (_gram_proj_two_bands_call, "gram_proj"),
    "bn_epilogue": (_bn_epilogue_flat_call, "bn_epilogue"),
    "instance_norm_leaky": (_instance_norm_leaky_flat_call, "instance_norm_leaky"),
}


@pytest.mark.parametrize("name", list(OPERATOR_CASES))
def test_wrapper_calls_its_registered_operator(name):
    """K1, K2, K5, ``bn_epilogue`` and ``instance_norm_leaky``'s wrappers go through
    ``torch.ops.wadt_torch``: a trace
    of the wrapper holds the operator (what ``torch.export`` saves), its CPU
    kernel is the plain version, and its fake kernel gives the output's
    shape and type."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    case, op = OPERATOR_CASES[name]
    wrapper, args, plain = case()
    graph = make_fx(lambda *a: wrapper(*a))(*args).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets == [f"wadt_torch.{op}.default"]
    got = wrapper(*args)
    torch.testing.assert_close(got, plain(*args), atol=0, rtol=0)
    with FakeTensorMode() as mode:
        fake = wrapper(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert fake.shape == got.shape and fake.dtype == got.dtype


def _dispatched_operators(fn) -> list:
    """The ``wadt_torch`` operators that the dispatcher runs during ``fn()``,
    as the profiler's CPU activity records them (a dispatch mode cannot
    watch: its presence alone sends a registered kernel's call through the
    operator, as a trace must)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("wadt_torch::")]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["patch_gram", "stem", "gram_proj", "bn_epilogue",
                                  "instance_norm_leaky"])
def test_eager_card_call_skips_its_operator(name, cuda_device):
    """The five registered kernels' one call rule on the card: an eager call
    launches the kernel and dispatches no ``wadt_torch`` operator, also
    where a gradient is recorded (all but K2 have one), while ``make_fx`` of
    the same call still holds the operator."""
    from torch.fx.experimental.proxy_tensor import make_fx

    case, op = OPERATOR_CASES[name]
    wrapper, args, _ = case()
    args = _to_device(args, cuda_device)
    ck.reset_launches()
    assert _dispatched_operators(lambda: wrapper(*args)) == []
    torch.cuda.synchronize()
    assert ck.LAUNCHES[op] == 1
    if name != "stem":
        leaf = args[0].detach().requires_grad_()
        out = []
        assert _dispatched_operators(lambda: out.append(wrapper(leaf, *args[1:]))) == []
        assert ck.LAUNCHES[op] == 2 and out[0].requires_grad
    graph = make_fx(lambda *a: wrapper(*a))(*args).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets == [f"wadt_torch.{op}.default"]


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


# ---------------------------------------------------------------------------
# The registered gradients of K1 and K5 (the training path's autograd)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,div", [((2, 6, 6, 3), 3), ((2, 7, 5, 4), 2), ((1, 5, 7, 3), 3)],
                         ids=["even", "replicate_pad", "pad_both"])
def test_patch_gram_operator_passes_gradcheck(shape, div):
    """float64 on the CPU: the operator's registered backward (the per-patch
    adjoint and the replicate pad folded back) against finite differences."""
    x = torch.from_numpy(np.random.RandomState(sum(shape)).randn(*shape)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a: torch.ops.wadt_torch.patch_gram(a, div), (x,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_patch_gram_backward_is_autograd_of_plain(dtype):
    """The registered backward against autograd through the plain version:
    float32 within 1e-6 x max|dz|; bf16 sums in float32 either way and
    rounds once, to within one bf16 ulp."""
    rng = np.random.RandomState(4)
    z = torch.from_numpy(rng.randn(2, 14, 14, 16).astype(np.float32)).to(dtype)
    r = torch.from_numpy(rng.randn(2, 9, 256).astype(np.float32))
    got, want = (z.detach().clone().requires_grad_() for _ in range(2))
    (ck.patch_gram(got, 3).float() * r).sum().backward()
    (ck.patch_gram_plain(want, 3).float() * r).sum().backward()
    assert got.grad.dtype == dtype
    scale = float(want.grad.float().abs().max())
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.grad.float(), want.grad.float(), atol=tol * scale, rtol=0)


@pytest.mark.parametrize("out_bf16", [False, True], ids=["float32_out", "bf16_out"])
def test_gram_proj_backward_is_autograd_of_plain(out_bf16):
    """K5's plain version sums in float32, so its registered gradients are
    held to autograd through ``gram_proj_plain`` on float32 inputs (dG, dW,
    db within 1e-6 x max) instead of to a float64 gradcheck; and on the bf16
    operands of the training path, in their dtypes."""
    rng = np.random.RandomState(5)
    out = torch.bfloat16 if out_bf16 else torch.float32
    for dt in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(rng.randn(2, 9, 64).astype(np.float32)).to(dt)
        w = torch.from_numpy(rng.randn(64, 24).astype(np.float32) * 0.1).to(dt)
        b = torch.from_numpy(rng.randn(24).astype(np.float32))
        r = torch.from_numpy(rng.randn(2, 9, 24).astype(np.float32))
        got = [t.detach().clone().requires_grad_() for t in (g, w, b)]
        want = [t.detach().clone().requires_grad_() for t in (g, w, b)]
        (ck.gram_proj(*got, out).float() * r).sum().backward()
        (ck.gram_proj_plain(*want, out).float() * r).sum().backward()
        for a, c in zip(got, want):
            assert a.grad.dtype == c.grad.dtype == a.dtype
            torch.testing.assert_close(a.grad.float(), c.grad.float(),
                                       atol=1e-6 * float(c.grad.float().abs().max()), rtol=0)


@pytest.mark.cuda
def test_operator_gradients_match_plain_on_card(cuda_device):
    """On the card the forward is the kernel (one launch each) and the
    registered gradients equal autograd through the plain versions: K1
    float32 within 1e-5 x max, K1 bf16 and K5 within 1e-2 x max."""
    rng = np.random.RandomState(6)
    z = torch.from_numpy(rng.randn(4, 14, 14, 96).astype(np.float32)).to(cuda_device)
    r = torch.from_numpy(rng.randn(4, 9, 96 * 96).astype(np.float32)).to(cuda_device)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        # leaves of their own: z.to(float32) is z itself, and after the first
        # pass z would require grad and make the bf16 cast a non-leaf
        got, want = (z.to(dtype).detach().clone().requires_grad_() for _ in range(2))
        ck.reset_launches()
        (ck.patch_gram(got, 3).float() * r).sum().backward()
        assert ck.LAUNCHES["patch_gram"] == 1
        (ck.patch_gram_plain(want, 3).float() * r).sum().backward()
        torch.testing.assert_close(got.grad.float(), want.grad.float(),
                                   atol=tol * float(want.grad.float().abs().max()), rtol=0)
    g = ck.patch_gram(z.to(torch.bfloat16), 3)
    w = torch.from_numpy(rng.randn(96 * 96, 192).astype(np.float32) * 0.01).to(cuda_device).bfloat16()
    b = torch.from_numpy(rng.randn(192).astype(np.float32)).to(cuda_device)
    r2 = torch.from_numpy(rng.randn(4, 9, 192).astype(np.float32)).to(cuda_device)
    got = [t.detach().clone().requires_grad_() for t in (g, w, b)]
    want = [t.detach().clone().requires_grad_() for t in (g, w, b)]
    ck.reset_launches()
    (ck.gram_proj(*got, torch.bfloat16).float() * r2).sum().backward()
    assert ck.LAUNCHES["gram_proj"] == 1
    (ck.gram_proj_plain(*want, torch.bfloat16).float() * r2).sum().backward()
    for a, c in zip(got, want):
        torch.testing.assert_close(a.grad.float(), c.grad.float(),
                                   atol=1e-2 * float(c.grad.float().abs().max()), rtol=0)


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
