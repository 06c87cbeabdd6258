"""The PM trunk's instance norm and LeakyReLU as one pass
(``ops/cuda_kernels.instance_norm_leaky``, ``csrc/instance_norm_leaky.cu``
on the card; ``models/trunk.norm_leaky``).

On the CPU: the plain version is ``leaky_relu(instance_norm(x))`` bit for
bit, the closed-form gradient equals autograd's through that chain, the
launcher refuses what the kernel cannot read, a PM forward's five norm
sites equal the plain chain and launch nothing, and a batch-norm PMG trunk
never calls the instance norm.  On the card (``cuda``): the kernel against
the plain chain at the five PM headline sites (batch 256 and 1, float32
and bf16), twice the same bits, its refusals, its gradient, five launches a
PM forward, and a PM ``Engine`` at batch 256 against the plain route.  This
file imports no JAX, so that the card's machine runs it:
``python -m pytest tests/test_torch_instance_norm.py -q -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import checkpoint
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm, pmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import trunk
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import nn, norms
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import cast_tree
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import trace
from _torch_threads import one_torch_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
# (C, H) of the PM headline trunk's five sites at 224 px: (HW 12544, 3136, 784, 196, 169)
HEADLINE_SITES = [(64, 112), (128, 56), (256, 28), (512, 14), (1024, 13)]


def chain(x, p, slope=0.2):
    """The eager chain the kernel replaces."""
    return nn.leaky_relu(norms.instance_norm(x, p), slope)


def site_inputs(shape, dtype, seed, device="cpu"):
    """NHWC conv-output-like x (per-channel offsets and spreads) and an
    affine norm, seeded."""
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    x = (rng.standard_normal(shape, dtype=np.float32) * (rng.random(c) + 0.5).astype(np.float32)
         + rng.standard_normal(c).astype(np.float32))
    p = {"scale": (rng.random(c) + 0.5).astype(np.float32),
         "bias": (rng.standard_normal(c) * 0.3).astype(np.float32)}
    return (torch.from_numpy(x).to(device, dtype),
            {k: torch.from_numpy(v).to(device, dtype) for k, v in p.items()})


@pytest.mark.parametrize("hw", [(13, 13), (14, 14), (4, 8)], ids=["hw169", "hw196", "hw32"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_equals_eager_chain(dtype, hw):
    """On a CPU tensor the wrapper (through its operator) and the plain
    version are ``leaky_relu(instance_norm(x))`` bit for bit, and launch
    nothing."""
    x, p = site_inputs((2, *hw, 24), dtype, seed=1)
    want = chain(x, p)
    ck.reset_launches()
    for got in (ck.instance_norm_leaky_plain(x, p), ck.instance_norm_leaky(x, p, 0.2),
                ck.instance_norm_leaky(x, p, 0.2, inplace=True)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert ck.LAUNCHES["instance_norm_leaky"] == 0


def autograd_grads(fn, x, p, dy, needs):
    x, scale, bias = (t.detach().clone().requires_grad_(n)
                      for t, n in zip((x, p["scale"], p["bias"]), needs))
    fn(x, {"scale": scale, "bias": bias}).backward(dy)
    return [t.grad for t in (x, scale, bias)]


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False), (False, True, True)],
                         ids=["all", "x", "affine"])
@pytest.mark.parametrize("hw", [(13, 13), (8, 6)], ids=["hw169", "hw48"])
def test_closed_form_gradient_equals_autograd(hw, needs):
    """``instance_norm_leaky_backward`` (x's statistics from
    ``instance_norm_stats``) and the operator's registered gradient equal
    autograd's through the eager chain within 1e-5 of the largest
    gradient."""
    x, p = site_inputs((2, *hw, 8), torch.float32, seed=2)
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape, dtype=np.float32))
    want = autograd_grads(chain, x, p, dy, needs)
    closed = ck.instance_norm_leaky_backward(dy, x, *ck.instance_norm_stats(x), p["scale"],
                                             p["bias"], 0.2, needs)
    assert closed[3] is None
    op = autograd_grads(lambda x, p: torch.ops.wadt_torch.instance_norm_leaky(
        x, p["scale"], p["bias"], 0.2), x, p, dy, needs)
    for got in (closed[:3], op):
        for g, w, n in zip(got, want, needs):
            if not n:
                assert g is None
                continue
            assert g.dtype == w.dtype and g.shape == w.shape
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_closed_form_gradient_keeps_float64():
    """float64 x (the CPU's exact Grad-CAM): the statistics and the closed
    form run in float64, so the operator's gradients equal autograd's
    through the eager chain within 1e-12 of the largest."""
    x, p = site_inputs((2, 13, 13, 8), torch.float64, seed=2)
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape))
    assert ck.instance_norm_stats(x)[0].dtype == torch.float64
    want = autograd_grads(chain, x, p, dy, (True, True, True))
    got = autograd_grads(lambda x, p: ck.instance_norm_leaky(x, p, 0.2), x, p, dy, (True, True, True))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float64
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


def _strided(x):
    return x[:, :, ::2]


FITS = {
    "fits": lambda x, s, b: (x, s, b),
    "channels_first": lambda x, s, b: (x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), s, b),
    "float16": lambda x, s, b: (x.half(), s.half(), b.half()),
    "strided": lambda x, s, b: (_strided(x), s, b),
    "three_dims": lambda x, s, b: (x[0], s, b),
    "scale_of_another_type": lambda x, s, b: (x, s.double(), b),
    "bias_of_another_length": lambda x, s, b: (x, s, b[:-1]),
}


@pytest.mark.parametrize("case", list(FITS))
def test_kernel_takes_only_what_it_can_read(case):
    """The launcher's one check: contiguous NHWC (channels-last memory)
    float32 or bf16, scale and bias [C] of x's type; on the CPU it raises on
    everything (the kernel runs on the card only)."""
    x, p = site_inputs((2, 6, 5, 8), torch.float32, seed=4)
    x, s, b = FITS[case](x, p["scale"], p["bias"])
    assert ck._inl_fits(x, s, b) == (case == "fits")
    with pytest.raises(ValueError, match="contiguous NHWC float32 or bf16 CUDA"):
        ck._inl_launch(x, s, b, 0.2)


def test_kernel_is_in_the_library():
    """``instance_norm_leaky.cu`` builds into the one library with the others."""
    assert "instance_norm_leaky.cu" in ck._SOURCES
    assert "instance_norm_leaky" in ck.LAUNCHES


def _pm(hparams=None):
    spec = pm.build_spec(TASKS, hparams or {})
    return spec, pm.init(torch.Generator().manual_seed(0), spec)


def _images(n, px=64, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, px, px, 3),
                                                                         dtype=np.float32))


def test_pm_forward_counts_five_plain_sites(monkeypatch):
    """A PM forward on the CPU: five ``trunk.norm`` spans, no launch, and
    the same outputs as the forward with every site on the plain chain."""
    spec, params = _pm()
    assert len(spec.plan) == 5
    ck.reset_launches()
    with trace.recording(), torch.inference_mode():
        got = pm.apply(params, _images(2), spec)[0]
    assert sum(r.name == "trunk.norm" for r in trace.records()) == 5
    assert ck.LAUNCHES["instance_norm_leaky"] == 0
    plain_route(monkeypatch)
    with torch.inference_mode():
        assert torch.equal(got, pm.apply(params, _images(2), spec)[0])


def test_batch_norm_trunk_counts_only_plain_sites(monkeypatch):
    """PMG's batch-norm trunk keeps the plain chain, on the CPU as on the
    card: one ``trunk.norm`` span a block, and no instance-norm call."""
    spec = pmg.build_spec(TASKS, {})
    params = pmg.init(torch.Generator().manual_seed(0), spec)
    assert spec.norm == "batch"

    def refuse(*a, **k):
        raise AssertionError("a batch-norm trunk called the instance norm")

    monkeypatch.setattr(ck, "instance_norm_leaky", refuse)
    with trace.recording(), torch.inference_mode():
        got = pmg.trunk_features(params, _images(2), spec)
    assert sum(r.name == "trunk.norm" for r in trace.records()) == len(spec.plan)
    assert torch.equal(got, eager_trunk(params["trunk"], _images(2), spec.plan, spec.norm))


def eager_trunk(params, x, plan, norm):
    for p, b in zip(params, plan):
        x = nn.leaky_relu(norms.apply_norm(nn.conv2d(x, p["conv"], stride=b.stride, padding=b.pad),
                                           p["norm"], norm), 0.2)
    return x


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_trunk_routes_equal_eager_chain(dtype):
    """``apply_trunk``, and ``trunk_last_conv`` then
    ``apply_trunk_from_last_conv`` (Grad-CAM's split), equal the eager chain
    bit for bit on the CPU; the split leaves its conv output as it was."""
    spec, params = _pm()
    tp = cast_tree(params["trunk"], dtype)
    x = _images(2).to(dtype)
    want = eager_trunk(tp, x, spec.plan, spec.norm)
    assert torch.equal(trunk.apply_trunk(tp, x, spec.plan, spec.norm), want)
    last = trunk.trunk_last_conv(tp, x, spec.plan, spec.norm)
    kept = last.clone()
    assert torch.equal(trunk.apply_trunk_from_last_conv(tp, last, spec.plan, spec.norm), want)
    assert torch.equal(last, kept)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


def plane_gap(got, want):
    """Largest |got - want| of each (image, channel) plane over the plane's
    largest |want|, the largest over planes."""
    gap = (got.float() - want.float()).abs().amax(dim=(1, 2))
    return float((gap / want.float().abs().amax(dim=(1, 2)).clamp_min(1e-30)).max())


def bf16_ulp(v):
    """One bf16 ulp at each |v| (v float32 holding bf16 values)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)))
    return torch.exp2(e - 7)


def check_against_plain(got, x, p, what):
    """float32: within 1e-6 of each plane's scale; bf16: each value within
    one bf16 ulp (plus that float32 gap) of the float32 chain on the same
    inputs rounded once, which the plain bf16 chain is not (it rounds each
    of its steps)."""
    if x.dtype == torch.float32:
        gap = plane_gap(got, chain(x, p))
        assert gap <= 1e-6, f"{what}: {gap:.3e} of the plane's scale"
        return gap
    ref = chain(x.float(), {k: v.float() for k, v in p.items()})
    once = ref.to(torch.bfloat16).float()
    limit = bf16_ulp(once) + 1e-6 * ref.abs().amax(dim=(1, 2), keepdim=True)
    bad = (got.float() - once).abs() > limit
    assert not bad.any(), f"{what}: {int(bad.sum())} values beyond one bf16 ulp"
    return plane_gap(got, chain(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [256, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel_equals_plain_at_headline_sites_on_card(dtype, batch, cuda_device):
    """The five PM headline sites: one launch each, within the limits of
    ``check_against_plain``, twice the same bits, and in place the same
    bits over x's own memory."""
    for i, (c, h) in enumerate(HEADLINE_SITES):
        x, p = site_inputs((batch, h, h, c), dtype, seed=10 + i, device=cuda_device)
        ck.reset_launches()
        got = ck.instance_norm_leaky(x, p)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["instance_norm_leaky"] == 1
        assert got.dtype == dtype and got.stride() == x.stride()
        check_against_plain(got, x, p, f"[{batch},{h},{h},{c}] {dtype}")
        assert torch.equal(ck.instance_norm_leaky(x, p), got)
        ptr = x.data_ptr()
        same = ck.instance_norm_leaky(x, p, inplace=True)
        assert same.data_ptr() == ptr and torch.equal(x, got)
        del x, got, same


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 7, 5, 6), (3, 9, 9, 12), (2, 40, 40, 24)],
                         ids=["c6", "c12", "hw1600"])
def test_kernel_other_shapes_on_card(shape, dtype, cuda_device):
    """Channels the 16-byte vectors do not divide (the scalar variant) and
    planes past the registers (the streaming variant)."""
    x, p = site_inputs(shape, dtype, seed=20, device=cuda_device)
    check_against_plain(ck.instance_norm_leaky(x, p), x, p, str(list(shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in FITS if c != "fits"])
def test_kernel_refuses_what_it_cannot_read_on_card(case, cuda_device):
    """On the card the wrapper raises on tensors the kernel does not take:
    it never falls back to the plain chain."""
    x, p = site_inputs((2, 6, 5, 8), torch.float32, seed=4, device=cuda_device)
    x, s, b = FITS[case](x, p["scale"], p["bias"])
    with pytest.raises(ValueError, match="contiguous NHWC float32 or bf16 CUDA"):
        ck.instance_norm_leaky(x, {"scale": s, "bias": b})


@pytest.mark.cuda
def test_kernel_gradient_equals_plain_on_card(cuda_device):
    """Every input requiring grad, through the wrapper (eager: the autograd
    function, out of place) and through the operator (what a trace holds):
    one launch each, the output within the float32 limit, every gradient
    within 1e-5 of autograd's through the plain chain."""
    x, p = site_inputs((4, 14, 14, 512), torch.float32, seed=31, device=cuda_device)
    dy = torch.randn(x.shape, generator=torch.Generator(cuda_device).manual_seed(32),
                     device=cuda_device)
    needs = (True, True, True)
    want = autograd_grads(chain, x, p, dy, needs)
    for route in (lambda x, p: ck.instance_norm_leaky(x, p, inplace=True),
                  lambda x, p: torch.ops.wadt_torch.instance_norm_leaky(x, p["scale"], p["bias"], 0.2)):
        ck.reset_launches()
        kept = x.clone()
        got = autograd_grads(route, x, p, dy, needs)
        assert ck.LAUNCHES["instance_norm_leaky"] == 1
        assert torch.equal(x, kept)  # a recorded gradient is never in place
        for g, w in zip(got, want, strict=True):
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def headline_pm():
    spec = pm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    return spec, pm.init(torch.Generator().manual_seed(22), spec)


def plain_route(monkeypatch):
    monkeypatch.setattr(ck, "instance_norm_leaky",
                        lambda x, p, slope=0.2, inplace=False: ck.instance_norm_leaky_plain(x, p, slope))


@pytest.mark.cuda
def test_pm_forward_launches_five_fused_sites_on_card(cuda_device):
    spec, params = headline_pm()
    params = checkpoint.to_device(params, cuda_device)
    ck.reset_launches()
    with trace.recording(), torch.inference_mode():
        pm.apply(params, _images(2, px=224).to(cuda_device), spec)
        torch.cuda.synchronize()
    assert ck.LAUNCHES["instance_norm_leaky"] == 5
    assert sum(r.name == "trunk.norm" for r in trace.records()) == 5


@pytest.mark.cuda
def test_pm_engine_matches_plain_route_on_card(cuda_device, monkeypatch):
    """A float32 PM headline ``Engine`` at batch 256 (parity precision):
    probabilities within 1e-5 of the same engine on the plain chain."""
    config.enable_parity_precision()
    spec, params = headline_pm()
    eng = Engine("pm", spec, params, batch_size=256, device=cuda_device)
    frames = np.random.default_rng(23).integers(0, 256, (256, 224, 224, 3), dtype=np.uint8)
    ck.reset_launches()
    fused = eng.run(frames)
    assert ck.LAUNCHES["instance_norm_leaky"] == 5
    plain_route(monkeypatch)
    plain = eng.run(frames)
    assert ck.LAUNCHES["instance_norm_leaky"] == 5
    assert float(np.abs(fused["probs"] - plain["probs"]).max()) <= 1e-5
