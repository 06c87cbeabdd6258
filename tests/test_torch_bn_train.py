"""The ResNet trunk's train-mode batch norm: each norm, with the ReLU or the
residual sum and ReLU after it, as one operation with its own backward
(``ops/cuda_kernels.bn_train``, ``csrc/bn_train.cu`` on the card;
``models/resnet.apply_truncated_train``).

On the CPU: ``bn_train_plain`` is the eager chain it replaced
(``norms.train_batch_norm`` on the NHWC view, the sum, ``torch.relu``) bit
for bit, output, running statistics and every gradient; the operator runs
the card's route (the statistics' sums, the apply pass, the gradient's
sums, the gradient pass) on the steps' plain versions, and it agrees with
the chain, on one rank and split over two, and so does the train-mode
trunk; a full-depth forward has 49 sites.  On the card (``cuda``): the kernels against the chain at every site
shape of the trunk, two calls bit-identical, the route with a one-rank
stand-in mesh bit for bit the unsplit one, tensors the kernels cannot read
refused, and a forward and backward of the trunk with its launch counts.
This file imports no JAX, so that the card's machine runs it:
``python -m pytest tests/test_torch_bn_train.py -q -m cuda --noconftest``.
"""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.checkpoint import to_device
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import resnet
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import norms
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import cast_tree
from _torch_threads import one_torch_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]
KINDS = ["norm", "relu", "identity", "downsample"]
FULL_DEPTH_SITES = 1 + 3 * sum(n for n, _ in resnet.STAGES)  # the stem's norm, three a block
DOWNSAMPLE_BLOCKS = len(resnet.STAGES)  # each stage's first block
# Tolerances, as a share of the compared tensor's largest magnitude.
# float32: the route's statistics are float64 sums rounded once and its
# elementwise steps fused (one rounding where the chain rounds twice), so
# it and the chain differ by a few float32 roundings (1e-7 measured at
# these shapes); 1e-5 leaves room for the card's other summation order.
F32_TOL = 1e-5
# bf16: the route computes in float32 and rounds once, so it is held to the
# chain run in float32 on the same bf16 values, one bf16 rounding apart
# (2^-8 relative; 2^-7 for gradients, whose float32 sums round once more).
# (Against the bf16 chain, whose every step rounds, a ReLU output near zero
# can land on the other side of zero and move that value's gradient by a
# whole dy.)
BF16_TOL = 2.0 ** -8


# -- the eager chain the operation replaced ---------------------------------


def eager_norm(x, p, shard=None):
    y, new_p = norms.train_batch_norm(x.permute(0, 2, 3, 1), p, shard)
    return y.permute(0, 3, 1, 2), new_p


def eager_site(kind, x, p, other=None, p_other=None):
    """-> (y, new p, new p_other or None), each step one eager operation."""
    y, new_p = eager_norm(x, p)
    new_o = None
    if kind == "norm":
        return y, new_p, new_o
    if kind == "downsample":
        other, new_o = eager_norm(other, p_other)
    if kind != "relu":
        y = y + other
    return torch.relu(y), new_p, new_o


def eager_block_train(p, x, stride):
    new_p = dict(p)
    identity = x
    h, new_p["bn1"] = eager_norm(resnet._conv(x, p["conv1"]), p["bn1"])
    h, new_p["bn2"] = eager_norm(resnet._conv(torch.relu(h), p["conv2"], stride=stride, padding=1),
                                 p["bn2"])
    h, new_p["bn3"] = eager_norm(resnet._conv(torch.relu(h), p["conv3"]), p["bn3"])
    if "downsample" in p:
        identity, ds_bn = eager_norm(resnet._conv(x, p["downsample"]["conv"], stride=stride),
                                     p["downsample"]["bn"])
        new_p["downsample"] = {"conv": p["downsample"]["conv"], "bn": ds_bn}
    return torch.relu(h + identity), new_p


def eager_trunk_train(params, x, truncate):
    new_params = dict(params)
    x = resnet._nchw(x)
    for child in resnet.CHILDREN[:truncate]:
        if child == "conv1":
            x = resnet._conv(x, params["conv1"], stride=2, padding=3)
        elif child == "bn1":
            x, new_params["bn1"] = eager_norm(x, params["bn1"])
        elif child == "relu":
            x = torch.relu(x)
        elif child == "maxpool":
            x = F.max_pool2d(x, 3, 2, 1)
        else:
            si = int(child[-1]) - 1
            blocks = []
            for bi, bp in enumerate(params[child]):
                x, nb = eager_block_train(bp, x, 1 if (si == 0 or bi > 0) else 2)
                blocks.append(nb)
            new_params[child] = blocks
    return resnet._nhwc(x), new_params


# -- inputs -----------------------------------------------------------------


def random_norm(rng, c, dtype, device, running=torch.float32):
    vals = {"scale": rng.standard_normal(c) * 0.2 + 1.0, "bias": rng.standard_normal(c) * 0.3,
            "mean": rng.standard_normal(c) * 0.3, "var": rng.random(c) + 0.2}
    return {k: torch.from_numpy(v.astype(np.float32)).to(
        device=device, dtype=running if k in ("mean", "var") else dtype) for k, v in vals.items()}


def site_inputs(kind, shape, dtype, seed, device="cpu", running=torch.float32):
    """x, p, other, p_other and an output gradient of one site: conv-output
    values off zero (mean 0.5, spread 2, as a trunk's are), ReLU outputs as
    the identity or a second conv output."""
    rng = np.random.default_rng(seed)

    def act():
        a = rng.standard_normal(shape, dtype=np.float32) * 2.0 + 0.5
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    x, p = act(), random_norm(rng, shape[1], dtype, device, running)
    other = p_other = None
    if kind == "identity":
        other = torch.relu(act())
    elif kind == "downsample":
        other, p_other = act(), random_norm(rng, shape[1], dtype, device, running)
    dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device=device, dtype=dtype)
    return x, p, other, p_other, dy


def run_site(fn, kind, x, p, other, p_other, dy, relu=None):
    """(y, new p, new p_other, gradients of x, p's scale and bias, then
    other's and p_other's scale and bias where the site has them) of
    ``fn(x, p, relu, other, p_other)``; ``relu`` the kind's unless given."""
    leaves = [x, p["scale"], p["bias"]] + ([] if other is None else [other]) + (
        [] if p_other is None else [p_other["scale"], p_other["bias"]])
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    xl, pl = leaves[0], {**p, "scale": leaves[1], "bias": leaves[2]}
    ol = None if other is None else leaves[3]
    pol = None if p_other is None else {**p_other, "scale": leaves[-2], "bias": leaves[-1]}
    with torch.enable_grad():
        y, new_p, new_o = fn(xl, pl, kind != "norm" if relu is None else relu, ol, pol)
        grads = torch.autograd.grad(y, leaves, dy)
    return y.detach(), new_p, new_o, grads


def reference_pair(fn, kind, x, p, other, p_other, dy, y_got):
    """A reference ``fn``'s run of the site, and its gradients for dy
    masked by ``y_got``'s ReLU (``fn`` without its ReLU): the gradients
    the reference gives where it takes the ReLU as the run under test
    took it.  A value within a rounding of zero may fall on either side of
    the ReLU, and one such value moves its channel's dscale and dbias by a
    whole dy times its normalized value (1 of 103 M at the stem's site at
    batch 128 moved them 2e-4 of the largest)."""
    want = run_site(fn, kind, x, p, other, p_other, dy)
    if kind == "norm":
        return want, want
    masked = torch.where(y_got.to(dy.device) > 0, dy, torch.zeros_like(dy))
    return want, run_site(fn, kind, x, p, other, p_other, masked, relu=False)


def split(shard):
    """The card's route through its steps with ``shard`` (``_BnTrainSplit``);
    on CPU tensors the steps are their plain versions."""
    def call(x, p, relu, other, p_other):
        second = (None,) * 4 if p_other is None else tuple(p_other[k] for k in ck._NORM_KEYS)
        y, _, run = ck._BnTrainSplit.apply(shard, x, *(p[k] for k in ck._NORM_KEYS), other,
                                           *second, relu)
        new_o = None if p_other is None else {"mean": run[2], "var": run[3]}
        return y, {"mean": run[0], "var": run[1]}, new_o

    return call


class StandInRanks:
    """A data group of ``k`` ranks run as threads, for the route's mesh
    calls: ``all_reduce`` returns the sum of every rank's tensor.  One rank
    returns its tensor itself."""

    def __init__(self, k):
        self.k, self.slots, self.barrier = k, [None] * k, threading.Barrier(k, timeout=60)

    def shard(self, rank, total):
        ranks = self

        class Shard:
            def __init__(self):
                self.total = total

            def all_reduce(self, t):
                ranks.slots[rank] = t
                ranks.barrier.wait()
                out = sum(ranks.slots[1:], ranks.slots[0].clone()) if ranks.k > 1 else t
                ranks.barrier.wait()
                return out

        return Shard()


def upcast(d):
    return None if d is None else {k: v.float() for k, v in d.items()}


def assert_near(got, want, tol, what, keep=None):
    """|got - want| <= tol x max |want| (where ``keep`` says, if given)."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max().clamp_min(1e-30))
    err = (got - want).abs()
    if keep is not None:
        err = err[keep]
    worst = float(err.max()) if err.numel() else 0.0
    assert worst <= tol * scale, f"{what}: {worst:.3e} over {tol:.1e} x {scale:.3e}"


def hold_to_chain(got, want, tol, what, running=None):
    """A route's (y, new p, new p_other, grads) against the chain's; the
    running statistics of ``running``'s type (else the chain's), within
    F32_TOL of the chain's or, in bf16, one bf16 rounding."""
    assert_near(got[0], want[0], tol, f"{what} y")
    for i in (1, 2):
        if want[i] is not None:
            for k in ("mean", "var"):
                assert got[i][k].dtype == (running or want[i][k].dtype)
                run_tol = BF16_TOL if got[i][k].dtype == torch.bfloat16 else F32_TOL
                assert_near(got[i][k], want[i][k], run_tol, f"{what} running {k}")
    assert len(got[3]) == len(want[3])
    for i, (g, w) in enumerate(zip(got[3], want[3])):
        assert_near(g, w, 2 * tol, f"{what} gradient {i}")


# -- CPU ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_operator_is_the_eager_chain(kind, dtype):
    """``bn_train_plain`` is the eager chain bit for bit: the output, the
    new running statistics (float32 ones beside bf16 activations, as the
    mixed step keeps them, and bf16 ones) and every gradient.  The operator
    (``bn_train`` without a shard) on the CPU, the card's steps in their
    plain versions with its registered backward, launches nothing, keeps
    the running statistics' type and is held to that chain run in float32
    as :func:`test_route_matches_the_chain` holds the split route."""
    up = (lambda t: None if t is None else t.float())
    for running in (torch.float32, dtype):
        x, p, other, p_other, dy = site_inputs(kind, (3, 6, 5, 7), dtype, 11, running=running)
        want = run_site(lambda *a: eager_site(kind, *a[:2], *a[3:]), kind, x, p, other, p_other, dy)
        got = run_site(ck.bn_train_plain, kind, x, p, other, p_other, dy)
        assert torch.equal(got[0], want[0])
        for i in (1, 2):
            if want[i] is not None:
                assert all(torch.equal(got[i][k], want[i][k]) and got[i][k].dtype == running
                           for k in ("mean", "var"))
        assert all(torch.equal(g, w) for g, w in zip(got[3], want[3], strict=True))
        ck.reset_launches()
        got = run_site(ck.bn_train, kind, x, p, other, p_other, dy)
        assert ck.LAUNCHES["bn_train"] == ck.LAUNCHES["bn_train_backward"] == 0
        assert got[0].dtype == dtype
        want = run_site(ck.bn_train_plain, kind, x.float(), upcast(p), up(other), upcast(p_other),
                        dy.float())
        hold_to_chain(got, want, F32_TOL if dtype == torch.float32 else BF16_TOL,
                      f"{kind} {dtype} running {running}", running)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_route_matches_the_chain(kind, dtype):
    """The card's route (float64 statistics' sums, one fused apply pass,
    the gradient's sums and the closed-form gradient pass), run on its
    plain steps with a one-rank stand-in mesh: within F32_TOL of the chain
    in float32, within BF16_TOL of the chain run in float32 on the same
    values in bf16."""
    x, p, other, p_other, dy = site_inputs(kind, (4, 8, 5, 7), dtype, 3)
    got = run_site(split(StandInRanks(1).shard(0, 4)), kind, x, p, other, p_other, dy)
    up = (lambda t: None if t is None else t.float())
    want = run_site(ck.bn_train_plain, kind, x.float(), upcast(p), up(other), upcast(p_other),
                    dy.float())
    assert got[0].dtype == dtype
    hold_to_chain(got, want, F32_TOL if dtype == torch.float32 else BF16_TOL, f"{kind} {dtype}")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_batch_statistics(kind, dtype):
    """The operation's batch mean and biased variance of each norm ([2k, C]
    float32, the second norm's after x's): the operator on the CPU gives
    the route's own, and the route, on its plain steps, is within F32_TOL
    of them computed in float64 (its float64 sums round once, to float32),
    as is the chain's own (``norms.batch_norm_train``'s) in float32."""
    x, p, other, p_other, _ = site_inputs(kind, (3, 6, 5, 7), dtype, 17)
    second = (None,) * 4 if p_other is None else tuple(p_other[k] for k in ck._NORM_KEYS)
    args = (x, *(p[k] for k in ck._NORM_KEYS), other, *second, kind != "norm")
    chain, exact = [], []
    for t, q in ((x, p), (other, p_other)):
        if q is not None:
            _, mean, var = norms.batch_norm_train(t.permute(0, 2, 3, 1), q, (0, 1, 2))
            chain += [mean.float(), var.float()]
            exact += [t.double().mean((0, 2, 3)), t.double().var((0, 2, 3), correction=0)]
    route = ck._bn_train_forward(*args)[1]
    assert torch.equal(ck._bn_train(*args)[1], route)
    if dtype == torch.float32:
        for i, want in enumerate(exact):
            assert_near(chain[i], want, F32_TOL, f"chain's statistic {i}")
    assert route.dtype == torch.float32 and route.shape == (len(exact), x.shape[1])
    for i, want in enumerate(exact):
        assert_near(route[i], want, F32_TOL, f"statistic {i}")


@pytest.mark.parametrize("kind", KINDS)
def test_route_split_over_two_ranks_is_the_whole_batch(kind):
    """The route over a two-rank stand-in data group (threads, each with
    half the batch, the sums all-reduced between the passes) gives the
    whole batch's output and running statistics, and its gradients of x
    and other are the whole batch's rows; each rank's dscale and dbias are
    its own rows' share, summing to the whole batch's."""
    x, p, other, p_other, dy = site_inputs(kind, (4, 8, 5, 7), torch.float32, 5)
    whole = run_site(split(None), kind, x, p, other, p_other, dy)
    ranks, out, errors = StandInRanks(2), [None, None], []

    def rank(i):
        try:
            rows = slice(2 * i, 2 * i + 2)
            part = None if other is None else other[rows].contiguous()
            out[i] = run_site(split(ranks.shard(i, 4)), kind, x[rows].contiguous(), p, part, p_other,
                              dy[rows].contiguous())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
            ranks.barrier.abort()

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert_near(torch.cat([out[0][0], out[1][0]]), whole[0], F32_TOL, "y")
    for i in (1, 2):
        if whole[i] is not None:
            for k in ("mean", "var"):
                assert torch.equal(out[0][i][k], out[1][i][k])
                assert_near(out[0][i][k], whole[i][k], F32_TOL, f"running {k}")
    for j, w in enumerate(whole[3]):
        rows = w.dim() == 4  # an activation's gradient: each rank's rows; a vector's: summed
        got = torch.cat([out[0][3][j], out[1][3][j]]) if rows else out[0][3][j] + out[1][3][j]
        assert_near(got, w, 2 * F32_TOL, f"gradient {j}")


@pytest.mark.parametrize("kind", KINDS)
def test_one_rank_stand_in_is_the_unsplit_route(kind):
    """A one-rank stand-in's all-reduce changes nothing: the route with it
    is the route without a shard, bit for bit, and so are ``bn_train``
    with it (a CPU call with a shard takes the same route) and the
    operator, output and every gradient."""
    x, p, other, p_other, dy = site_inputs(kind, (2, 4, 3, 3), torch.float32, 7)
    a = run_site(split(StandInRanks(1).shard(0, 2)), kind, x, p, other, p_other, dy)
    b = run_site(split(None), kind, x, p, other, p_other, dy)
    meshed = run_site(lambda *args: ck.bn_train(*args, shard=StandInRanks(1).shard(0, 2)), kind, x,
                      p, other, p_other, dy)
    for c in (a, meshed, run_site(ck.bn_train, kind, x, p, other, p_other, dy)):
        assert torch.equal(c[0], b[0])
        assert all(torch.equal(g, w) for g, w in zip(c[3], b[3], strict=True))


def test_statistics_step_sums_in_float64():
    """The statistics step's plain version: each channel's sum and sum of
    squares in float64, and variances far below a large mean survive it."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((3, 2, 4, 5)) * 1e-2 + 1e3).astype(np.float32))
    part = ck.bn_train_stats_plain(x)
    xd = x.double()
    assert part.dtype == torch.float64 and part.shape == (1, 2, 2)
    assert torch.equal(part[0, :, 0], xd.sum((0, 2, 3)))
    m, v, _, _ = ck._bn_affine_plain(part, torch.ones(2), x.numel() // 2)
    want = xd.var((0, 2, 3), correction=0)
    assert torch.allclose(v.double(), want, rtol=1e-4)
    assert torch.allclose(m.double(), xd.mean((0, 2, 3)), rtol=1e-7)


@pytest.mark.parametrize("n,hw,splits", [(128, 112 * 112, 98), (128, 56 * 56, 25), (128, 28 * 28, 7),
                                         (128, 14 * 14, 2), (128, 7 * 7, 1), (2, 7 * 7, 1),
                                         (1, 1, 1)])
def test_reduction_runs(n, hw, splits):
    """One block of the reductions a (channel, run of at most ~16 K values)."""
    assert ck.bn_train_splits(n, hw) == splits
    assert -(-n * hw // splits) <= ck._BN_TRAIN_RUN or splits == 1


FITS = {
    "fits": lambda x, o, v, r: (x, o, v, r),
    "float16": lambda x, o, v, r: (x.half(), o.half(), [t.half() for t in v], r),
    "not_contiguous": lambda x, o, v, r: (x.transpose(2, 3), o.transpose(2, 3), v, r),
    "other_of_another_shape": lambda x, o, v, r: (x, o[:1], v, r),
    "scale_of_another_type": lambda x, o, v, r: (x, o, [v[0].double(), *v[1:]], r),
    "running_of_another_type": lambda x, o, v, r: (x, o, v, [r[0].double(), *r[1:]]),
    "running_of_another_length": lambda x, o, v, r: (x, o, v, [r[0][:-1], *r[1:]]),
}


@pytest.mark.parametrize("case", list(FITS))
def test_kernels_take_only_what_they_can_read(case):
    """The route's one check before the kernels: contiguous NCHW float32 or
    bf16, other, scale and bias of x's type, running statistics [C] of
    float32 or x's type."""
    x, p, other, _, _ = site_inputs("identity", (2, 8, 7, 5), torch.float32, 0)
    x, other, vecs, running = FITS[case](x, other, [p["scale"], p["bias"]], [p["mean"], p["var"]])
    assert ck._bn_train_fits(x, other, vecs, running) == (case == "fits")


def test_second_norm_needs_its_tensor():
    x, p, _, _, _ = site_inputs("norm", (1, 4, 3, 3), torch.float32, 1)
    for fn in (ck.bn_train, ck.bn_train_plain):
        with pytest.raises(ValueError, match="second norm"):
            fn(x, p, p_other=p)


def test_kernels_are_in_the_library():
    """``bn_train.cu`` builds into the one library with the others, and its
    launches count forward and backward apart."""
    assert "bn_train.cu" in ck._SOURCES
    assert {"bn_train", "bn_train_backward"} <= set(ck.LAUNCHES)


def test_trace_holds_the_operator():
    """A ``make_fx`` trace of a site holds ``wadt_torch.bn_train`` (what an
    exported program would carry) and runs it to the eager call's values."""
    from torch.fx.experimental.proxy_tensor import make_fx

    x, p, other, _, _ = site_inputs("identity", (2, 4, 3, 3), torch.float32, 2)

    def site(x, other):
        return ck.bn_train(x, p, True, other)[0]

    graph = make_fx(site)(x, other)
    assert sum("wadt_torch.bn_train" in str(n.target) for n in graph.graph.nodes) == 1
    assert torch.equal(graph(x, other), site(x, other))


@pytest.fixture(scope="module")
def trunk():
    return resnet.init(torch.Generator().manual_seed(4))


def tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def with_leaves(tree, leaves, path=""):
    if isinstance(tree, dict):
        return {k: with_leaves(v, leaves, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [with_leaves(v, leaves, f"{path}/{i}") for i, v in enumerate(tree)]
    return leaves[path]


def trunk_run(fn, params, x, truncate):
    """(features, new running statistics by path, each weight's gradient by
    path) of a train-mode trunk ``fn`` under the loss mean(features^2)."""
    leaves = {k: t.detach().clone().requires_grad_(not k.endswith(("/mean", "/var")))
              for k, t in tree_leaves(params)}
    with torch.enable_grad():
        feats, new = fn(with_leaves(params, leaves), x, truncate)
        feats.float().square().mean().backward()
    stats = {k: t for k, t in tree_leaves(new) if k.endswith(("/mean", "/var"))}
    return feats.detach(), stats, {k: t.grad for k, t in leaves.items() if t.grad is not None}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("truncate", [2, 3, 5, 6])
def test_trunk_train_is_the_eager_chain(trunk, truncate, dtype):
    """``apply_truncated_train`` on the CPU against the eager chain it
    replaced, the stem's norm with and without its ReLU: the same
    features, running statistics and weights' gradients, each tensor as
    close to the chain run in float64 as the chain in ``dtype`` is, within
    twice its gap (or F32_TOL of the tensor's largest value).  The route
    rounds once a site where the chain rounds at every step; a weight
    before a norm has a gradient that the norm all but cancels (5e-7 at the
    stem's conv), so its float32 roundings are a large share of it."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 48, 48, 3), dtype=np.float32))
    f64 = trunk_run(eager_trunk_train, cast_tree(trunk, torch.float64), x.double(), truncate)
    params = cast_tree(trunk, dtype)
    got = trunk_run(resnet.apply_truncated_train, params, x.to(dtype), truncate)
    chain = trunk_run(eager_trunk_train, params, x.to(dtype), truncate)
    assert got[0].dtype == dtype

    def hold(g, c, w, what):
        gap = (lambda a: float((a.double() - w).abs().max()))
        allowed = max(2 * gap(c), F32_TOL * float(w.abs().max()))
        assert gap(g) <= allowed, f"{what}: {gap(g):.3e} from float64, chain {gap(c):.3e}"

    hold(got[0], chain[0], f64[0], "features")
    for g, c, w in zip(got[1:], chain[1:], f64[1:]):
        assert g.keys() == c.keys() == w.keys()
        for k in w:
            hold(g[k], c[k], w[k], k)


def test_full_depth_counts_49_sites(trunk, monkeypatch):
    """49 ``bn_train`` calls a full-depth train-mode forward (4 with a
    downsample branch's norm), which on the CPU launch nothing; counted
    through a wrapper that passes each call on, the same features bit for
    bit."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 64, 64, 3), dtype=np.float32))
    ck.reset_launches()
    want, _ = resnet.apply_truncated_train(trunk, x, 8)
    assert ck.LAUNCHES["bn_train"] == 0
    calls = []

    bn_train = ck.bn_train

    def counted(*a, **k):
        calls.append(k.get("p_other") is not None)
        return bn_train(*a, **k)

    monkeypatch.setattr(ck, "bn_train", counted)
    got, _ = resnet.apply_truncated_train(trunk, x, 8)
    assert torch.equal(got, want)
    assert len(calls) == FULL_DEPTH_SITES == 49 and sum(calls) == DOWNSAMPLE_BLOCKS


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


def trunk_sites():
    """(kind, C, H) of every distinct site of ResNet-50's train-mode trunk
    at 224 px: the stem's norm and ReLU, then each stage's."""
    sites = [("relu", 64, 112)]
    h = 56
    for si, (_, planes) in enumerate(resnet.STAGES):
        h_in, h = h, h if si == 0 else h // 2
        sites += [("relu", planes, h_in), ("relu", planes, h),
                  ("downsample", planes * resnet.EXPANSION, h),
                  ("identity", planes * resnet.EXPANSION, h)]
    return sorted(set(sites), key=sites.index)


def hold_to_chain_on_card(got, pair, tol, what):
    """:func:`hold_to_chain` against a :func:`reference_pair`: y and the
    running statistics against the reference's own run, at most 1e-5 of
    the outputs on the other side of the ReLU from it, and every gradient
    against the reference's under got's ReLU mask."""
    want, masked = pair
    assert_near(got[0], want[0], tol, f"{what} y")
    for i in (1, 2):
        if want[i] is not None:
            for k in ("mean", "var"):
                assert_near(got[i][k], want[i][k], F32_TOL, f"{what} running {k}")
    flips = int(((got[0].float() > 0) != (want[0].float() > 0)).sum())
    assert flips <= 1e-5 * got[0].numel(), f"{what}: {flips} ReLUs differ"
    for i, (g, w) in enumerate(zip(got[3], masked[3], strict=True)):
        assert_near(g, w, 2 * tol, f"{what} gradient {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernels_match_the_chain_at_trunk_sites_on_card(dtype, cuda_device):
    """Every site shape of the trunk at batch 2: the kernels (forward 2 or
    3 launches, backward 2) against the chain on the card in float64 (the
    truth the float32 chain strays from on large reductions; its gradients
    under the kernels' ReLU mask), to F32_TOL in float32 and BF16_TOL in
    bf16; a second call bit-identical."""
    for i, (kind, c, h) in enumerate(trunk_sites()):
        x, p, other, p_other, dy = site_inputs(kind, (2, c, h, h), dtype, 40 + i, cuda_device)
        ck.reset_launches()
        got = run_site(ck.bn_train, kind, x, p, other, p_other, dy)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["bn_train"] == (3 if kind == "downsample" else 2)
        assert ck.LAUNCHES["bn_train_backward"] == 2
        again = run_site(ck.bn_train, kind, x, p, other, p_other, dy)
        assert torch.equal(again[0], got[0])
        assert all(torch.equal(a, g) for a, g in zip(again[3], got[3], strict=True))
        f64 = (lambda d: None if d is None else {k: v.double() for k, v in d.items()})
        pair = reference_pair(ck.bn_train_plain, kind, x.double(), f64(p),
                              None if other is None else other.double(), f64(p_other), dy.double(),
                              got[0])
        hold_to_chain_on_card(got, pair, F32_TOL if dtype == torch.float32 else BF16_TOL,
                              f"{kind} [2, {c}, {h}, {h}] {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_steps_match_their_plain_versions_on_card(kind, dtype, cuda_device):
    """Each step against its plain version on the same inputs: the sums to
    1e-12 (float64 in another order), the passes within a rounding; and the
    route with a one-rank stand-in mesh bit for bit the unsplit route."""
    x, p, other, p_other, dy = site_inputs(kind, (3, 32, 9, 9), dtype, 8, cuda_device)
    cpu = [None if t is None else t.cpu() for t in (x, other, dy)]
    part = ck._bn_stats(x)
    want = ck.bn_train_stats_plain(cpu[0])
    assert torch.allclose(part.sum(0).cpu(), want[0], rtol=1e-12, atol=1e-9)
    a = run_site(split(StandInRanks(1).shard(0, 3)), kind, x, p, other, p_other, dy)
    b = run_site(ck.bn_train, kind, x, p, other, p_other, dy)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(g, w) for g, w in zip(a[3], b[3], strict=True))
    tocpu = (lambda d: None if d is None else {k: v.cpu() for k, v in d.items()})
    c = reference_pair(split(None), kind, cpu[0], tocpu(p), cpu[1], tocpu(p_other), cpu[2], b[0])
    tol = 1e-6 if dtype == torch.float32 else BF16_TOL
    hold_to_chain_on_card(tuple(t.cpu() if isinstance(t, torch.Tensor) else t for t in b[:1])
                          + (tocpu(b[1]), tocpu(b[2]), [g.cpu() for g in b[3]]), c, tol,
                          f"{kind} steps {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in FITS if c != "fits"])
def test_kernels_refuse_what_they_cannot_read_on_card(case, cuda_device):
    """On the card the route raises on tensors the kernels do not take: it
    never falls back to the chain."""
    x, p, other, _, _ = site_inputs("identity", (2, 8, 7, 5), torch.float32, 0, cuda_device)
    x, other, vecs, running = FITS[case](x, other, [p["scale"], p["bias"]], [p["mean"], p["var"]])
    q = {"scale": vecs[0], "bias": vecs[1], "mean": running[0], "var": running[1]}
    with pytest.raises(ValueError, match="contiguous NCHW float32 or bf16 CUDA"):
        ck.bn_train(x, q, True, other)


@pytest.mark.cuda
def test_trunk_forward_and_backward_count_their_launches_on_card(trunk, cuda_device, monkeypatch):
    """A full-depth train-mode forward and backward at batch 4, 128 px, in
    float32: every site runs the kernels (102 forward launches: 2 a site,
    1 more for each downsample norm; 98 backward), none the chain; against
    the chain run in float64 (cuDNN's deterministic algorithms, TF32 off),
    the worst gap of the features, of a running statistic and of a weight's
    gradient (as a share of its norm) is at most twice the float32 chain's.
    (A deep trunk at this batch reduces 64 values a channel in layer4, so
    the float32 chain itself lands ~1e-3 to 1e-2 from float64.)"""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    params = to_device(trunk, cuda_device)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 128, 128, 3), dtype=np.float32))
    x = x.to(cuda_device)
    chain = ck._chain_norm
    monkeypatch.setattr(ck, "_chain_norm", lambda *a, **k: pytest.fail("the chain ran"))
    ck.reset_launches()
    got = trunk_run(resnet.apply_truncated_train, params, x, 8)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["bn_train"] == 2 * FULL_DEPTH_SITES + DOWNSAMPLE_BLOCKS == 102
    assert ck.LAUNCHES["bn_train_backward"] == 2 * FULL_DEPTH_SITES == 98
    monkeypatch.setattr(ck, "_chain_norm", chain)
    f32 = trunk_run(eager_trunk_train, params, x, 8)
    f64 = trunk_run(eager_trunk_train, cast_tree(params, torch.float64), x.double(), 8)

    def worst(run):
        gaps = [float((run[0].double() - f64[0]).norm() / f64[0].norm())]
        for part in (1, 2):
            gaps.append(max(float((run[part][k].double() - w).norm() / w.norm().clamp_min(1e-30))
                            for k, w in f64[part].items()))
        return gaps

    for what, g, c in zip(("features", "running statistics", "gradients"), worst(got), worst(f32)):
        assert g <= 2 * c + 1e-6, f"{what}: kernels {g:.3e} from float64, chain {c:.3e}"

