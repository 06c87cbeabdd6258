"""The ResNet trunk's inference epilogue: the norm after each convolution,
the residual sum and the ReLU as one pass (``ops/cuda_kernels.bn_epilogue``,
``csrc/bn_epilogue.cu`` on the card; ``models/resnet``).

On the CPU: the plain version equals the eager chain it replaces (the norm's
affine as two broadcast passes, ``torch.relu``, ``h + identity``) bit for
bit at every kind of site, the operator's registered gradient equals
autograd's through that chain, the trunk equals that chain block for block,
and a full-depth forward has 49 sites.  On the card (``cuda``):
the kernel equals its plain version bit for bit at every shape of
ResNet-50's batch-128 and batch-1 trunk, forward and gradient, it refuses
tensors it does not take, Grad-CAM's route runs it with the plain chain's
gradients, and a bf16 RTM ``Engine`` gives the same probabilities through
it as through the plain version, with 49 launches a batch.  This file imports no JAX, so that the card's machine runs it:
``python -m pytest tests/test_torch_resnet_epilogue.py -q -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import resnet
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import rtm
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import norms
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import cast_tree
from _torch_threads import one_torch_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]
KINDS = ["norm", "norm_relu", "identity", "downsample"]
FULL_DEPTH_SITES = 1 + 3 * sum(n for n, _ in resnet.STAGES)  # the stem's norm, three a block


# -- the eager chain the epilogue replaces ----------------------------------


def eager_bn(x, p):
    scale, shift = norms.batch_norm_affine(p)
    return x * scale[:, None, None] + shift[:, None, None]


def eager_site(kind, x, p, other=None, p_other=None):
    if kind == "norm":
        return eager_bn(x, p)
    if kind == "norm_relu":
        return torch.relu(eager_bn(x, p))
    identity = other if kind == "identity" else eager_bn(other, p_other)
    return torch.relu(eager_bn(x, p) + identity)


def eager_block(p, x, stride):
    identity = x
    h = torch.relu(eager_bn(resnet._conv(x, p["conv1"]), p["bn1"]))
    h = torch.relu(eager_bn(resnet._conv(h, p["conv2"], stride=stride, padding=1), p["bn2"]))
    h = eager_bn(resnet._conv(h, p["conv3"]), p["bn3"])
    if "downsample" in p:
        identity = eager_bn(resnet._conv(x, p["downsample"]["conv"], stride=stride),
                            p["downsample"]["bn"])
    return torch.relu(h + identity)


def eager_children(params, x, children):
    for child in children:
        if child == "conv1":
            x = resnet._conv(x, params["conv1"], stride=2, padding=3)
        elif child == "bn1":
            x = eager_bn(x, params["bn1"])
        elif child == "relu":
            x = torch.relu(x)
        elif child == "maxpool":
            x = F.max_pool2d(x, 3, 2, 1)
        else:
            si = int(child[-1]) - 1
            for bi, bp in enumerate(params[child]):
                x = eager_block(bp, x, 1 if (si == 0 or bi > 0) else 2)
    return x


# -- inputs -----------------------------------------------------------------


def random_norm(rng, c, dtype=torch.float32, device="cpu"):
    vals = {"scale": rng.standard_normal(c) * 0.2 + 1.0, "bias": rng.standard_normal(c) * 0.3,
            "mean": rng.standard_normal(c) * 0.3, "var": rng.random(c) + 0.2}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device=device, dtype=dtype)
            for k, v in vals.items()}


def site_inputs(kind, shape, dtype, seed, device="cpu"):
    """x, p, other, p_other of one site: conv-output-like values, and for a
    residual site an identity of ReLU outputs or a second conv output."""
    rng = np.random.default_rng(seed)
    c = shape[1]

    def act():
        a = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return a.to(device=device, dtype=dtype)

    x, p = act(), random_norm(rng, c, dtype, device)
    if kind == "identity":
        return x, p, torch.relu(act()), None
    if kind == "downsample":
        return x, p, act(), random_norm(rng, c, dtype, device)
    return x, p, None, None


def fused_call(fn, kind, x, p, other, p_other):
    return fn(x, p, relu=kind != "norm", other=other, p_other=p_other)


def random_trunk(seed=3):
    """ResNet-50 params with seeded random norm statistics (float32, CPU)
    and a small gain on each block's last norm, so the activations stay
    finite through the 16 blocks."""
    params = resnet.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def renorm(p, gain=1.0):
        q = random_norm(rng, p["scale"].shape[0])
        q["scale"] = q["scale"] * gain
        return q

    params["bn1"] = renorm(params["bn1"])
    for si in range(len(resnet.STAGES)):
        for bp in params[f"layer{si + 1}"]:
            bp["bn1"], bp["bn2"], bp["bn3"] = renorm(bp["bn1"]), renorm(bp["bn2"]), renorm(bp["bn3"], 0.2)
            if "downsample" in bp:
                bp["downsample"]["bn"] = renorm(bp["downsample"]["bn"])
    return params


@pytest.fixture(scope="module")
def trunk():
    return random_trunk()


# -- CPU ----------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("hw", [7, 56], ids=["hw49", "hw3136"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_equals_eager_chain(kind, dtype, hw, batch):
    """The plain version, called directly and through the wrapper (the
    operator's CPU kernel), is the eager chain bit for bit."""
    x, p, other, p_other = site_inputs(kind, (batch, 16, hw, hw), dtype, seed=hw * 10 + batch)
    want = eager_site(kind, x, p, other, p_other)
    ck.reset_launches()
    for fn in (ck.bn_epilogue_plain, ck.bn_epilogue):
        got = fused_call(fn, kind, x, p, other, p_other)
        assert got.dtype == dtype
        assert torch.equal(got, want)
    assert ck.LAUNCHES["bn_epilogue"] == 0


def eager_grads(fn, kind, x, p, other, p_other, dy, only_x):
    """Output and gradients of ``fn`` at a site for the output gradient dy:
    x's alone (``only_x``: Grad-CAM's case), else every tensor's."""
    leaves = [x] if only_x else [x, *p.values()] + (
        [] if other is None else [other]) + ([] if p_other is None else list(p_other.values()))
    leaves = {id(t): t.detach().clone().requires_grad_() for t in leaves}

    def leaf(t):
        return None if t is None else leaves.get(id(t), t)

    args = (leaf(x), {k: leaf(v) for k, v in p.items()}, leaf(other),
            None if p_other is None else {k: leaf(v) for k, v in p_other.items()})
    with torch.enable_grad():
        y = fn(kind, *args)
        grads = torch.autograd.grad(y, list(leaves.values()), dy)
    return y.detach(), grads


@pytest.mark.parametrize("only_x", [True, False], ids=["activation", "all"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_operator_gradient_equals_eager_chain(kind, dtype, only_x):
    """Through the operator (what ``bn_epilogue`` calls when a gradient is
    recorded), the output and the gradients of the activation, the
    residual and every norm vector are autograd's through the eager chain,
    bit for bit."""
    x, p, other, p_other = site_inputs(kind, (3, 16, 7, 7), dtype, seed=21)
    dy = torch.from_numpy(np.random.default_rng(22).standard_normal((3, 16, 7, 7),
                                                                    dtype=np.float32)).to(dtype)
    got = eager_grads(lambda k, *a: fused_call(ck.bn_epilogue, k, *a), kind, x, p, other,
                      p_other, dy, only_x)
    assert len(got[1]) == (1 if only_x else {"downsample": 10, "identity": 6}.get(kind, 5))
    want = eager_grads(eager_site, kind, x, p, other, p_other, dy, only_x)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert g.dtype == w.dtype and torch.equal(g, w)


FITS = {
    "fits": lambda x, o, v: (x, o, v),
    "float16": lambda x, o, v: (x.half(), o.half(), [t.half() for t in v]),
    "not_contiguous": lambda x, o, v: (x.transpose(2, 3), o.transpose(2, 3), v),
    "other_of_another_type": lambda x, o, v: (x, o.double(), v),
    "other_of_another_shape": lambda x, o, v: (x, o[:1], v),
    "vector_of_another_length": lambda x, o, v: (x, o, [v[0][:-1], *v[1:]]),
    "vector_of_another_type": lambda x, o, v: (x, o, [v[0].double(), *v[1:]]),
}


@pytest.mark.parametrize("case", list(FITS))
def test_kernel_takes_only_what_it_can_read(case):
    """The launcher's one check: contiguous NCHW float32 or bf16, with the
    residual and every norm vector [C] of x's type; it raises on the rest."""
    x, p, other, _ = site_inputs("identity", (2, 8, 7, 5), torch.float32, seed=0)
    x, other, vecs = FITS[case](x, other, list(p.values()))
    assert ck._epilogue_fits(x, other, vecs) == (case == "fits")
    with pytest.raises(ValueError, match="contiguous NCHW float32 or bf16 CUDA"):
        ck._bn_epilogue_launch(x, *vecs, other, None, None, None, None, True)


def test_second_norm_needs_its_tensor():
    x, p, _, _ = site_inputs("norm", (1, 8, 7, 7), torch.float32, seed=1)
    with pytest.raises(ValueError, match="second norm"):
        ck.bn_epilogue(x, p, p_other=p)


def test_epilogue_is_in_the_kernel_library():
    """``bn_epilogue.cu`` builds into the one library with the others."""
    assert "bn_epilogue.cu" in ck._SOURCES
    assert "bn_epilogue" in ck.LAUNCHES


def test_eager_only_outside_traces():
    """The registered kernels' call rule (``ck._register``) skips the
    operator only on a plain tensor with no dispatch mode active: a fake
    tensor or a ``make_fx`` trace takes the operator, which is what an
    exported program holds.  Where a gradient is recorded through any
    tensor argument, the eager route is the autograd function that carries
    the operator's gradient."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    x = torch.ones(1, 2, 3, 3)
    assert ck._eager(x)
    with FakeTensorMode() as mode:
        assert not ck._eager(mode.from_tensor(x))
    seen = []
    make_fx(lambda t: seen.append(ck._eager(t)) or t + 1)(x)
    assert seen == [False]
    w = torch.ones(2, requires_grad=True)
    assert not ck._records_grad((x, None, True)) and ck._records_grad((x, None, w, 0.2))
    with torch.no_grad():
        assert not ck._records_grad((x, w))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("truncate", [2, 3, 5, 8])
def test_trunk_equals_eager_chain(trunk, truncate, dtype):
    """``apply_truncated`` (NHWC in, NHWC out) equals the eager chain bit
    for bit at every depth, the stem's norm with and without its ReLU."""
    params = cast_tree(trunk, dtype)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 64, 64, 3), dtype=np.float32))
    x = x.to(dtype)
    got = resnet.apply_truncated(params, x, truncate)
    want = resnet._nhwc(eager_children(params, resnet._nchw(x), resnet.CHILDREN[:truncate]))
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


def test_full_depth_counts_49_sites(trunk, monkeypatch):
    """49 ``bn_epilogue`` calls a full-depth forward, which on the CPU
    launch nothing and give the plain version's features."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 64, 64, 3), dtype=np.float32))
    ck.reset_launches()
    got = resnet.apply_truncated(trunk, x, 8)
    assert ck.LAUNCHES["bn_epilogue"] == 0
    calls = []

    def plain(*a, **k):
        calls.append(1)
        return ck.bn_epilogue_plain(*a, **k)

    monkeypatch.setattr(ck, "bn_epilogue", plain)
    assert torch.equal(resnet.apply_truncated(trunk, x, 8), got)
    assert len(calls) == FULL_DEPTH_SITES == 49


def test_gradient_route_takes_the_plain_version(trunk):
    """Grad-CAM's route (``stem_conv`` then ``apply_truncated_from_stem``
    under ``enable_grad`` on an activation that requires grad) on the CPU:
    every site is the plain version (no launch), and the features and the
    activation's gradient equal the eager chain's.  (On the card it is the
    kernel: ``test_gradient_route_runs_the_kernel_on_card``.)"""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 64, 64, 3), dtype=np.float32))
    with torch.no_grad():
        a0 = resnet.stem_conv(trunk, x)
    grads = []
    ck.reset_launches()
    for run in (
        lambda a: resnet.apply_truncated_from_stem(trunk, a, 8),
        lambda a: resnet._nhwc(eager_children(trunk, resnet._nchw(a), resnet.CHILDREN[1:8])),
    ):
        a = a0.clone().requires_grad_()
        with torch.enable_grad():
            feats = run(a)
            feats.square().mean().backward()
        grads.append((feats.detach(), a.grad))
    (f_got, g_got), (f_want, g_want) = grads
    assert ck.LAUNCHES["bn_epilogue"] == 0
    assert torch.equal(f_got, f_want)
    assert torch.equal(g_got, g_want)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


def trunk_sites():
    """(kind, C, H) of every distinct site of ResNet-50's trunk at 224 px:
    the stem's norm (with and without its ReLU), then each stage's."""
    sites = [("norm", 64, 112), ("norm_relu", 64, 112)]
    h = 56
    for si, (_, planes) in enumerate(resnet.STAGES):
        h_in, h = h, h if si == 0 else h // 2
        sites += [("norm_relu", planes, h_in), ("norm_relu", planes, h),
                  ("downsample", planes * resnet.EXPANSION, h),
                  ("identity", planes * resnet.EXPANSION, h)]
    return sorted(set(sites), key=sites.index)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel_equals_plain_on_card(dtype, batch, cuda_device):
    """Every site of the trunk, bit for bit, one launch each, twice the same."""
    for i, (kind, c, h) in enumerate(trunk_sites()):
        x, p, other, p_other = site_inputs(kind, (batch, c, h, h), dtype, seed=i, device=cuda_device)
        ck.reset_launches()
        got = fused_call(ck.bn_epilogue, kind, x, p, other, p_other)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["bn_epilogue"] == 1
        want = fused_call(ck.bn_epilogue_plain, kind, x, p, other, p_other)
        assert torch.equal(got, want), f"{kind} [{batch}, {c}, {h}, {h}] {dtype}"
        assert torch.equal(fused_call(ck.bn_epilogue, kind, x, p, other, p_other), got)
        del x, other, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_scalar_path_on_card(kind, dtype, cuda_device):
    """A tensor 2 bytes off 16-byte alignment, of odd length (C 3, 5x7
    maps), takes the kernel's one-element path: still bit for bit."""
    shape = (3, 3, 5, 7)
    n = int(np.prod(shape))
    x, p, other, p_other = site_inputs(kind, shape, dtype, seed=11, device=cuda_device)
    buf = torch.empty(n + 1, dtype=dtype, device=cuda_device)
    buf[1:] = x.reshape(-1)
    x = buf[1:].view(shape)
    assert x.data_ptr() % 16
    got = fused_call(ck.bn_epilogue, kind, x, p, other, p_other)
    assert torch.equal(got, fused_call(ck.bn_epilogue_plain, kind, x, p, other, p_other))


@pytest.mark.cuda
def test_bf16_engine_same_probs_through_the_kernel(trunk, cuda_device, monkeypatch):
    """An RTM ``Engine`` in bf16 at full depth: 49 launches a batch, and
    the probabilities equal those of the same engine on the plain
    epilogue bit for bit."""
    tasks = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
    spec = rtm.build_spec(tasks, {"attn_token_dim": 64})
    params = rtm.init(torch.Generator().manual_seed(0), spec)
    params["backbone"] = trunk
    eng = Engine("rtm", spec, params, batch_size=8, dtype=torch.bfloat16, device=cuda_device)
    frames = np.random.default_rng(8).integers(0, 256, (16, 224, 224, 3), dtype=np.uint8)
    ck.reset_launches()
    fused = eng.run(frames)
    assert ck.LAUNCHES["bn_epilogue"] == 2 * FULL_DEPTH_SITES
    monkeypatch.setattr(ck, "bn_epilogue", ck.bn_epilogue_plain)
    plain = eng.run(frames)
    assert ck.LAUNCHES["bn_epilogue"] == 2 * FULL_DEPTH_SITES
    assert np.array_equal(fused["probs"], plain["probs"])
    assert np.array_equal(fused["preds"], plain["preds"])


def operator_call(x, p, relu=True, other=None, p_other=None):
    """``wadt_torch::bn_epilogue`` itself, as a traced program calls it."""
    second = [None] * 4 if p_other is None else [p_other[k] for k in ck._NORM_KEYS]
    return torch.ops.wadt_torch.bn_epilogue(x, *(p[k] for k in ck._NORM_KEYS), other, *second,
                                            relu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_gradient_equals_plain_on_card(kind, dtype, cuda_device):
    """Every tensor requiring grad, through the wrapper (eager: the
    autograd function) and through the operator (what a trace holds): one
    launch each, and the output and every gradient the plain chain's bit
    for bit."""
    x, p, other, p_other = site_inputs(kind, (4, 256, 14, 14), dtype, seed=31, device=cuda_device)
    dy = torch.from_numpy(np.random.default_rng(32).standard_normal((4, 256, 14, 14),
                                                                    dtype=np.float32))
    dy = dy.to(cuda_device, dtype)
    want = eager_grads(eager_site, kind, x, p, other, p_other, dy, only_x=False)
    for route in (ck.bn_epilogue, operator_call):
        ck.reset_launches()
        got = eager_grads(lambda k, *a: fused_call(route, k, *a), kind, x, p, other, p_other, dy,
                          only_x=False)
        assert ck.LAUNCHES["bn_epilogue"] == 1
        assert torch.equal(got[0], want[0])
        for g, w in zip(got[1], want[1], strict=True):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in FITS if c != "fits"])
def test_kernel_refuses_what_it_cannot_read_on_card(case, cuda_device):
    """On the card the wrapper raises on tensors the kernel does not take:
    it never falls back to the plain version."""
    x, p, other, _ = site_inputs("identity", (2, 8, 7, 5), torch.float32, seed=0,
                                 device=cuda_device)
    x, other, vecs = FITS[case](x, other, list(p.values()))
    with pytest.raises(ValueError, match="contiguous NCHW float32 or bf16 CUDA"):
        ck.bn_epilogue(x, dict(zip(ck._NORM_KEYS, vecs)), True, other)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_gradient_route_runs_the_kernel_on_card(trunk, dtype, cuda_device, monkeypatch):
    """Grad-CAM's route on the card: every site is one launch, and the
    features and the activation's gradient equal those of the same route
    on the plain version bit for bit (cuDNN's deterministic algorithms:
    its default data-gradient algorithms sum in no fixed order)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    params = _to(cast_tree(trunk, dtype), cuda_device)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 64, 64, 3), dtype=np.float32))
    with torch.no_grad():
        a0 = resnet.stem_conv(params, x.to(cuda_device, dtype))
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(ck, "bn_epilogue", ck.bn_epilogue_plain)
        ck.reset_launches()
        a = a0.clone().requires_grad_()
        with torch.enable_grad():
            feats = resnet.apply_truncated_from_stem(params, a, 8)
            feats.float().square().mean().backward()
        runs.append((feats.detach(), a.grad, ck.LAUNCHES["bn_epilogue"]))
    (f_got, g_got, launches), (f_want, g_want, plain_launches) = runs
    assert launches == FULL_DEPTH_SITES and plain_launches == 0
    assert torch.equal(f_got, f_want)
    assert torch.equal(g_got, g_want)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
