"""Launch plans of the port's redesigned kernels, on the CPU.

- K5 (``csrc/gram_proj.cu``): :func:`gram_proj_plan` covers every output
  tile once, cuts K into whole 64-deep tiles that cover it exactly, forms
  clusters that divide the grid, and keeps every cluster resident at once
  where it says so, at the main shape and at every PMG fixture's shape.
- K4 (``csrc/head.cu``, launch 2): :func:`head_share_plan`'s column shares
  are multiples of 8 that cover each layer matrix once and fit a block's
  227 KB of shared memory, for the shipped spec and the PMG fixtures' widths;
  :func:`pack_head_shares` packs them so that the shares, read back block
  by block and assembled by column, give the fold's own matrices and
  ``fused_head_plain``'s logits bit for bit.

The kernels themselves run on the card only (``chip_smoke.py``,
``tests/test_torch_kernels.py::test_kernel_matches_plain_on_card``).
"""

import json
import os

import numpy as np
import pytest
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import checkpoint
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PMG_FIXTURES = ["pmg_shipped", "pmg_deep_plan", "pmg_no_transformer", "pmg_tiny_instance_se"]
H100_SMS = 132


def _spec(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    return pmg.build_spec(meta["tasks"], meta["hparams"])


def _k5_shapes():
    """(M, K, N) of the main shape and of each PMG fixture's bf16 batch path
    at batch 2 and 256: M = B * Np, K = gc * gc, N = d_model."""
    shapes = [(2304, 9216, 192)]
    for name in PMG_FIXTURES:
        sp = _spec(name)
        for b in (2, 256):
            shapes.append((b * sp.patch_div ** 2, sp.gram_channels ** 2, sp.d_model))
    return shapes


@pytest.mark.parametrize("m,k,n", _k5_shapes())
def test_gram_proj_plan_covers_the_product(m, k, n):
    plan = ck.gram_proj_plan(m, n, k, H100_SMS)
    # every output tile once: the tiles reach past M and N, and none lies beyond
    tile_m = ck.GRAM_PROJ_TILE_M
    assert plan.tile_n in (64, 128, 192, 256) and plan.tile_n >= min(n, 256)
    assert (plan.m_tiles - 1) * tile_m < m <= plan.m_tiles * tile_m
    assert (plan.n_tiles - 1) * plan.tile_n < n <= plan.n_tiles * plan.tile_n
    # K slices: whole 64-deep tiles, in order, none empty, covering K exactly
    assert (plan.k_tiles - 1) * 64 < k <= plan.k_tiles * 64
    slices = [plan.k_slice(s) for s in range(plan.splits)]
    assert slices[0][0] == 0 and slices[-1][1] == plan.k_tiles
    assert all(a < b for a, b in slices)
    assert all(slices[i][1] == slices[i + 1][0] for i in range(plan.splits - 1))
    assert max(b - a for a, b in slices) - min(b - a for a, b in slices) <= 1
    # clusters along K that divide the grid, within the portable size
    assert 1 <= plan.splits <= 8
    assert all(g % c == 0 for g, c in zip(plan.grid, plan.cluster))
    clusters = plan.m_tiles * plan.n_tiles
    if plan.one_wave:
        assert np.prod(plan.grid) <= H100_SMS
        assert clusters <= (H100_SMS // 16) * (16 // plan.splits)
    if (m, k, n) == (2304, 9216, 192):
        assert plan.one_wave and plan.splits > 1


def _head_dims(name):
    sp = _spec(name)
    layers = sp.transformer_layers if sp.has_transformer else 0
    return (sp.patch_div ** 2, sp.d_model, 2 * sp.d_model if layers else 0, sp.transformer_heads,
            layers, len(sp.tasks), sp.tasks.max_classes)


@pytest.mark.parametrize("name", PMG_FIXTURES)
@pytest.mark.parametrize("cluster", [None, 16])
def test_head_share_plan_covers_each_matrix_and_fits(name, cluster):
    np_, d, ff, heads, layers, ntask, kmax = _head_dims(name)
    plan = ck.head_share_plan(np_, d, ff, heads, layers, ntask, kmax, cluster)
    cs = plan.cluster
    assert cs == cluster if cluster else cs in (8, 16)
    if cluster is None and cs == 16:  # the plan takes 8 blocks wherever they fit
        with pytest.raises(ValueError, match="the limit is 232448"):
            ck.head_share_plan(np_, d, ff, heads, layers, ntask, kmax, 8)
    for bounds, width in ((plan.bd, d), (plan.bf, ff)):
        assert len(bounds) == cs + 1 and bounds[0] == 0 and bounds[-1] == width
        shares = np.diff(bounds)
        assert (shares >= 0).all() and (shares % 8 == 0).all()
    regions = np.diff(plan.off)
    want = [layers * (4 * d * (plan.bd[r + 1] - plan.bd[r]) + d * (plan.bf[r + 1] - plan.bf[r])
                      + ff * (plan.bd[r + 1] - plan.bd[r])) for r in range(cs)]
    assert regions.tolist() == want and plan.w_cap == max(want)
    assert plan.off[-1] == layers * (4 * d * d + 2 * d * ff)  # each weight once
    assert plan.t_cap * cs >= ntask > (plan.t_cap - 1) * cs
    assert plan.smem <= 227 * 1024


def test_head_share_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="the limit is 232448"):
        ck.head_share_plan(9, 512, 1024, 8, 4, 12, 8)


def _unpack(packed, plan, n_layers, d, ff):
    """Read the packed shares back block by block and assemble each layer
    matrix by column."""
    mats = [{key: torch.zeros((ff if key == "f2" else d, ff if key == "f1" else d),
                              dtype=torch.bfloat16) for key in ("q", "k", "v", "o", "f1", "f2")}
            for _ in range(n_layers)]
    for r in range(plan.cluster):
        pos = plan.off[r]
        for li in range(n_layers):
            for key in ("q", "k", "v", "o", "f1", "f2"):
                lo, hi = (plan.bf if key == "f1" else plan.bd)[r:r + 2]
                rows = ff if key == "f2" else d
                n = rows * (hi - lo)
                mats[li][key][:, lo:hi] = packed[pos:pos + n].reshape(rows, hi - lo)
                pos += n
        assert pos == plan.off[r + 1]
    return mats


@pytest.mark.parametrize("name", ["pmg_shipped", "pmg_deep_plan", "pmg_tiny_instance_se"])
@pytest.mark.parametrize("cluster", [None, 16])
def test_packed_head_shares_walk_equals_plain(name, cluster):
    spec = _spec(name)
    params = checkpoint.load_torch_checkpoint("pmg", os.path.join(FIXTURES, f"{name}.pth"), spec)
    fold = pmg.fold_head_weights(params, spec, "bf16")
    layers = fold["transformer"]
    d, ff = spec.d_model, layers[0]["ffn1"]["w"].shape[1]
    plan = ck.head_share_plan(spec.patch_div ** 2, d, ff, spec.transformer_heads, len(layers),
                              len(spec.tasks), spec.tasks.max_classes, cluster)
    packed = ck.pack_head_shares(layers, plan)
    assert packed.dtype == torch.bfloat16 and packed.numel() == plan.off[-1]
    mats = _unpack(packed, plan, len(layers), d, ff)
    walked = []
    for lp, m in zip(layers, mats):
        for (grp, leaf), key in zip(ck._LAYER_MATRICES, ("q", "k", "v", "o", "f1", "f2")):
            assert torch.equal(m[key], lp[grp][leaf])
        walked.append({**lp, "attn": {**lp["attn"], "wq": m["q"], "wk": m["k"], "wv": m["v"],
                                      "wo": m["o"]},
                       "ffn1": {**lp["ffn1"], "w": m["f1"]}, "ffn2": {**lp["ffn2"], "w": m["f2"]}})
    tokens = torch.from_numpy(np.random.RandomState(5).randn(
        2, spec.patch_div ** 2, spec.gram_channels ** 2).astype(np.float32))
    want = ck.fused_head_plain(tokens, fold, spec)
    got = ck.fused_head_plain(tokens, dict(fold, transformer=walked), spec)
    assert torch.equal(got, want)
