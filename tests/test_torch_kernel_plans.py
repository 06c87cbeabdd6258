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
- K1 (``csrc/patch_gram.cu``): :func:`patch_gram_plan`'s persistent grid
  walks every (image, patch, band) once and fits the block's shared memory,
  at the main shape, at batch 1 and at each PMG fixture's map; the
  upper-triangle-plus-mirror tile walk (:func:`patch_gram_tiles`) writes
  each of the C x C outputs once.
- K3 (``csrc/trunk_gram.cu``): :func:`trunk_gram_plan`'s pixel shares cover
  each patch once, replicate-padded pixels included, on at most 8 blocks
  whose shared memory fits; :func:`pack_trunk_gram_weights` lays the fold
  out as the kernel reads it; and the split, emulated block by block on the
  CPU, gives ``fused_trunk_gram_plain``'s Gram bit for bit.
- K2 (``csrc/stem.cu``): :func:`stem_plan`'s persistent grid walks every
  tile of whole output rows once, covers each output row once and fits
  the block's shared memory, at the main shape, at batch 1, at each PMG
  fixture's stem and at chip_smoke.py's two ragged shapes;
  :func:`stem_weight_split` splits a float32 weight into three bf16 parts
  that sum to it exactly; and the tile product, emulated on the staged
  bytes in :func:`stem_k_order`'s permuted, zero-padded K order (a pad
  column reads whatever byte lies there), equals the plain GEMM in
  float64.

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
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.gram import split_patches
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import leaky_relu
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import s2d_pack

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


# ---------------------------------------------------------------------------
# K1 (csrc/patch_gram.cu): persistent grid and the upper-triangle tile walk
# ---------------------------------------------------------------------------


def _gram_map_shape(name, size=224):
    """[H, W, C] of the map a PMG fixture's spec hands to K1 at ``size`` px."""
    sp = _spec(name)
    side = size
    for b in sp.plan:
        side = (side + 2 * b.pad - b.kernel) // b.stride + 1
    return side, side, sp.gram_channels, sp.patch_div


def _k1_shapes():
    """(B, H, W, C, div): the main shape, batch 1, and each PMG fixture's
    map at batch 2 and 256."""
    shapes = [(256, 14, 14, 96, 3), (1, 14, 14, 96, 3)]
    for name in PMG_FIXTURES:
        h, w, c, div = _gram_map_shape(name)
        shapes += [(2, h, w, c, div), (256, h, w, c, div)]
    return shapes


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("b,h,w,c,div", _k1_shapes())
def test_patch_gram_plan_walks_every_item_once(b, h, w, c, div, bf16):
    plan = ck.patch_gram_plan(b, h, w, c, div, H100_SMS, bf16)
    assert plan.units == b * div * div * plan.bands
    assert (plan.bands - 1) * plan.band < c <= plan.bands * plan.band
    # block k takes units k, k + grid, ...: every (image, patch, band) once
    seen = np.zeros(plan.units, np.int64)
    for k in range(plan.grid):
        seen[k::plan.grid] += 1
    assert (seen == 1).all()
    per_sm = 3 if bf16 else 2  # the kernel's launch bounds
    assert 1 <= plan.grid <= min(plan.units, per_sm * H100_SMS)
    assert plan.smem <= 227 * 1024
    if plan.grid > H100_SMS:  # n blocks an SM, each with its 1 KB reserve
        assert -(-plan.grid // H100_SMS) * (plan.smem + 1024) <= 228 * 1024
    # stages of whole 16-pixel k-steps that cover the patch
    area = plan.ph * plan.pw
    assert plan.kc % 16 == 0 and (plan.chunks - 1) * plan.kc < area <= plan.chunks * plan.kc
    if (b, h, w, c, div) == (256, 14, 14, 96, 3):
        assert plan.bands == 1 and plan.chunks == 1 and plan.grid == per_sm * H100_SMS


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("c", [96, 32, 12, 18])
def test_patch_gram_mirror_walk_writes_each_output_once(c, bf16):
    edge, tiles = ck.patch_gram_tiles(c, bf16)
    plan = ck.patch_gram_plan(2, 14, 14, c, 3, H100_SMS, bf16)
    assert plan.bands == 1 and len(tiles) == plan.n_tiles
    writes = np.zeros((c, c), np.int64)
    for ti, tj in tiles:
        assert tj >= ti
        for x in range(edge):
            for y in range(edge):
                i, j = ti * edge + x, tj * edge + y
                if i < c and j < c:
                    writes[i, j] += 1
                    if ti != tj:  # the mirror tile
                        writes[j, i] += 1
    assert (writes == 1).all()


def test_patch_gram_plan_refuses_a_width_it_cannot_hold():
    with pytest.raises(ValueError, match="too wide"):
        ck.patch_gram_plan(2, 14, 14, 5000, 3, H100_SMS)


# ---------------------------------------------------------------------------
# K3 (csrc/trunk_gram.cu): one cluster per patch, pixel and row shares
# ---------------------------------------------------------------------------

RAGGED_TRUNK = dict(ndf=16, patch_size=64, patch_div=3, gram_channels=32, d_model=64,
                    transformer_layers=0, use_token_attention=False)  # chip_smoke.py [6]


def _trunk_cases():
    """(label, spec, H, W): the shipped spec, the ragged spec of
    chip_smoke.py [6], and each PMG fixture spec the fused kernel takes."""
    cases = [("ragged 112x120", pmg.build_spec({"a": ["x", "y"]}, RAGGED_TRUNK), 112, 120)]
    for name in PMG_FIXTURES:
        sp = _spec(name)
        if ck.supports_fused_trunk_gram(sp):
            cases.append((name, sp, 224, 224))
    return cases


TRUNK_CASES = _trunk_cases()


def test_trunk_cases_hold_the_shipped_spec():
    assert {label for label, *_ in TRUNK_CASES} >= {"pmg_shipped", "pmg_no_transformer",
                                                     "ragged 112x120"}


@pytest.mark.parametrize("label,spec,h,w", TRUNK_CASES, ids=[c[0] for c in TRUNK_CASES])
def test_trunk_gram_plan_shares_cover_each_patch_once(label, spec, h, w):
    plan = ck.trunk_gram_plan(spec, h, w)
    K, div = spec.plan[0].kernel * spec.plan[1].kernel, spec.patch_div
    assert (plan.hf, plan.wf) == (h // K, w // K)
    area = plan.ph * plan.pw
    assert 1 <= plan.cluster <= 8 and plan.smem <= 227 * 1024
    for bounds, n in ((plan.pix, area), (plan.rows, spec.gram_channels)):
        assert len(bounds) == plan.cluster + 1 and bounds[0] == 0 and bounds[-1] == n
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
    shares = np.diff(plan.pix)
    assert shares.min() >= 1 and shares.max() == -(-area // 8)  # the fewest pixels a block
    assert plan.cluster == -(-area // shares.max())  # on the fewest blocks
    # the blocks' pixels, clamped to the final grid, are the replicate-padded
    # patches of the plain version, pixel for pixel
    index = torch.arange(plan.hf * plan.wf, dtype=torch.float32).reshape(1, plan.hf, plan.wf, 1)
    want, want_area = split_patches(index, div)
    assert want_area == area
    for p in range(div * div):
        pr, pc = divmod(p, div)
        got = []
        for r in range(plan.cluster):
            for q in range(plan.pix[r], plan.pix[r + 1]):
                fy = min(pr * plan.ph + q // plan.pw, plan.hf - 1)
                fx = min(pc * plan.pw + q % plan.pw, plan.wf - 1)
                got.append(fy * plan.wf + fx)
        assert got == want[0, p, :, 0].long().tolist()


def _trunk_fold(spec, seed=0):
    rng = np.random.RandomState(seed)
    params = {"trunk": [], "chan_proj": {
        "w": torch.from_numpy(rng.randn(1, 1, spec.trunk_channels, spec.gram_channels).astype(np.float32)
                              * spec.trunk_channels ** -0.5),
        "b": torch.from_numpy(rng.randn(spec.gram_channels).astype(np.float32) * 0.1)}}
    for b in spec.plan:
        params["trunk"].append({
            "conv": {"w": torch.from_numpy(rng.randn(b.kernel, b.kernel, b.cin, b.cout).astype(np.float32)
                                           * (b.kernel * b.kernel * b.cin) ** -0.5)},
            "norm": {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
                "scale": rng.rand(b.cout) + 0.5, "bias": rng.randn(b.cout) * 0.1,
                "mean": rng.randn(b.cout) * 0.1, "var": rng.rand(b.cout) + 0.5}.items()}})
    return ck.fold_trunk_gram_weights(params, spec)


@pytest.mark.parametrize("label,spec,h,w", TRUNK_CASES, ids=[c[0] for c in TRUNK_CASES])
def test_packed_trunk_weights_hold_the_fold(label, spec, h, w):
    """The packed buffer, read back at the plan's offsets, is the fold's
    conv1 block, W2, W3 and Wcp bit for bit, with zeros in every pad."""
    weights = _trunk_fold(spec)
    plan = ck.trunk_gram_plan(spec, h, w)
    buf = ck.pack_trunk_gram_weights(weights, spec)
    assert buf.dtype == torch.uint8 and buf.numel() == plan.seg[-1]
    assert all(o % 16 == 0 for o in plan.seg)
    w0bd, b0, w2, b2, w3, b3, wcp, bcp = weights
    b0p, b1p, b2p = spec.plan
    k1, k2, cin, c0 = b0p.kernel, b1p.kernel, b0p.cin, b0p.cout
    K, cells = k1 * k2, k2 * k2
    kd0p, c0p, c1p, c2p, gcp = plan.widths
    conv1 = torch.stack([w0bd[(dy * K + dx) * cin + ci, :c0] for dy in range(k1) for dx in range(k1)
                         for ci in range(cin)])
    conv2 = torch.zeros((cells * c0p, b1p.cout), dtype=torch.bfloat16)
    conv2.view(cells, c0p, -1)[:, :c0] = w2.reshape(cells, c0, -1)
    for g, (wt, bias, rows, cols) in enumerate(((conv1, b0[:c0], kd0p, c0p), (conv2, b2, cells * c0p, c1p),
                                                (w3, b3, c1p, c2p), (wcp, bcp, c2p, gcp))):
        seg = buf[plan.seg[g]:plan.seg[g + 1]]
        wp = seg[:rows * (cols + 8) * 2].view(torch.bfloat16).reshape(rows, cols + 8)
        bp = seg[rows * (cols + 8) * 2:].view(torch.float32)
        want = torch.zeros((rows, cols + 8), dtype=torch.bfloat16)
        want[:wt.shape[0], :wt.shape[1]] = wt
        assert torch.equal(wp.view(torch.int16), want.view(torch.int16))
        assert bp.numel() == cols and torch.equal(bp[:bias.numel()], bias)
        assert not bp[bias.numel():].any()


def _emulate_trunk_gram(x8, weights, spec, plan):
    """K3's split on the CPU: each block of each patch's cluster runs the
    plain arithmetic on its own pixels, zero rows padding them to 16 as the
    kernel's GEMM tiles do; z is gathered in pixel order and the Gram taken
    as the plain version takes it."""
    w0, b0, w2, b2, w3, b3, wcp, bcp = weights
    K, div = spec.plan[0].kernel * spec.plan[1].kernel, spec.patch_div
    z16 = s2d_pack(x8, K)[:, :plan.hf, :plan.wf]
    zall = torch.zeros((x8.shape[0], div * div, plan.ph * plan.pw, spec.gram_channels))
    for b in range(x8.shape[0]):
        for p in range(div * div):
            pr, pc = divmod(p, div)
            for r in range(plan.cluster):
                pix = list(range(plan.pix[r], plan.pix[r + 1]))
                rows = torch.zeros((-(-len(pix) // 16) * 16, z16.shape[-1]), dtype=z16.dtype)
                rows[:len(pix)] = torch.stack([z16[b, min(pr * plan.ph + q // plan.pw, plan.hf - 1),
                                                   min(pc * plan.pw + q % plan.pw, plan.wf - 1)]
                                               for q in pix])
                a = ck._bf16_round(leaky_relu(torch.matmul(rows.to(torch.float32), w0.float()) + b0))
                bb = ck._bf16_round(leaky_relu(torch.matmul(a, w2.float()) + b2))
                c = ck._bf16_round(leaky_relu(torch.matmul(bb, w3.float()) + b3))
                zall[b, p, plan.pix[r]:plan.pix[r + 1]] = (torch.matmul(c, wcp.float()) + bcp)[:len(pix)]
    g = torch.einsum("bpnc,bpnd->bpcd", zall, zall) * (1.0 / float(plan.ph * plan.pw))
    return g.reshape(x8.shape[0], div * div, -1)


@pytest.mark.parametrize("label,spec,h,w", [c for c in TRUNK_CASES if c[0] != "pmg_no_transformer"],
                         ids=[c[0] for c in TRUNK_CASES if c[0] != "pmg_no_transformer"])
def test_trunk_gram_split_emulation_equals_plain(label, spec, h, w):
    weights = _trunk_fold(spec, seed=1)
    x8 = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (1, h, w, 3), np.uint8))
    plan = ck.trunk_gram_plan(spec, h, w)
    got = _emulate_trunk_gram(x8, weights, spec, plan)
    assert torch.equal(got, ck.fused_trunk_gram_plain(x8, weights, spec))


# ---------------------------------------------------------------------------
# K2 (csrc/stem.cu): persistent tiles of whole output rows, the weight
# split, the permuted K order
# ---------------------------------------------------------------------------

STEM_RAGGED = [(2, 30, 30, 3, 4, 16), (2, 32, 32, 3, 4, 12)]  # chip_smoke.py [2]


def _stem_shapes():
    """(B, H, W, cin, k, cout): the main shape, batch 1 (the camera
    route), each PMG fixture's stem at 224 px at batch 2 and 256, and the
    ragged shapes."""
    shapes = [(256, 224, 224, 3, 4, 32), (1, 224, 224, 3, 4, 32)]
    for name in PMG_FIXTURES:
        b0 = _spec(name).plan[0]
        shapes += [(b, 224, 224, b0.cin, b0.kernel, b0.cout) for b in (2, 256)]
    return shapes + STEM_RAGGED


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("b,h,w,cin,k,cout", _stem_shapes())
def test_stem_plan_covers_every_row_once_and_fits(b, h, w, cin, k, cout, bf16):
    plan = ck.stem_plan(b, h, w, cin, k, cout, H100_SMS, True, bf16)
    nrows = b * (h // k)
    assert plan.rows in (4, 2, 1) and plan.tiles == -(-nrows // plan.rows)
    # block g takes tiles g, g + grid, ...: every tile once, every output row once
    rows = np.zeros(nrows, np.int64)
    for g in range(plan.grid):
        for tile in range(g, plan.tiles, plan.grid):
            rows[tile * plan.rows:min((tile + 1) * plan.rows, nrows)] += 1
    assert (rows == 1).all()
    assert 1 <= plan.grid <= min(plan.tiles, 3 * H100_SMS)
    assert plan.stages in (2, 3) and plan.smem <= 227 * 1024
    assert plan.stage_bytes % 128 == 0 and plan.stage_bytes >= plan.rows * k * w * cin + 16
    assert -(-plan.grid // H100_SMS) * (plan.smem + 1024) <= 228 * 1024
    assert plan.chunks * 32 >= cout and 4 % plan.chunks == 0
    assert plan.bulk == ((k * w * cin) % 16 == 0 and (h * w * cin) % 16 == 0)
    assert plan.tma == (cout in (32, 64, 128))  # whole 32-channel boxes
    if b == 1:  # the camera route's batch 1 spreads over one SM per output row
        assert plan.grid == h // k >= 56
    if (b, h, w, cin, k, cout) == (256, 224, 224, 3, 4, 32):
        # three blocks an SM, each a ring of three 4-row tiles
        assert plan.bulk and plan.tma and plan.rows == 4 and plan.stages == 3
        assert plan.grid == 3 * H100_SMS
        assert plan.path == "bulk loads, tensor stores"


def test_stem_plan_names_the_paths_where_bulk_and_tensor_rules_fail():
    assert ck.stem_plan(*STEM_RAGGED[0], H100_SMS).path == "plain loads, direct stores"  # 360-byte runs
    assert ck.stem_plan(*STEM_RAGGED[1], H100_SMS).path == "bulk loads, direct stores"  # 12 channels
    assert not ck.stem_plan(256, 224, 224, 3, 4, 32, H100_SMS, aligned=False).bulk


@pytest.mark.parametrize("k,cin,cout", [(4, 4, 32), (8, 3, 32), (4, 3, 129)])
def test_stem_plan_refuses_what_the_kernel_does_not_take(k, cin, cout):
    with pytest.raises(ValueError, match="the kernel takes"):
        ck.stem_plan(2, 64, 64, cin, k, cout, H100_SMS)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4])
def test_stem_weight_split_is_exact(scale):
    w = torch.from_numpy(np.random.RandomState(4).randn(48, 32).astype(np.float32) * scale)
    hi, mid, lo = ck.stem_weight_split(w)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), w.double())
    assert (mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all()
    # a bf16-valued weight (the bf16 mode's, which takes hi alone) is all hi
    hi, mid, lo = ck.stem_weight_split(w.to(torch.bfloat16).float())
    assert torch.equal(hi, w.to(torch.bfloat16)) and not mid.any() and not lo.any()


def _emulate_stem_product(x8, w2d, k, plan):
    """K2's products on the CPU in float64: each tile's output rows staged
    as the kernel stages them (each row's k input rows as one run, 16 bytes
    of slack after the last, filled with 0xA5), each pixel's A row read at
    the kernel's offsets in :func:`stem_k_order`, B the weight's split
    parts in the same order with zero rows, summed over the three parts."""
    b, h, w, cin = x8.shape
    hp, wp = h // k, w // k
    order = ck.stem_k_order(k, cin)
    rows_idx = torch.tensor([r if r >= 0 else 0 for _, _, r in order])
    live = torch.tensor([r >= 0 for _, _, r in order], dtype=torch.float64)
    parts = ck.stem_weight_split(w2d)
    bmat = sum(p.double()[rows_idx] for p in parts) * live[:, None]
    flat = x8.reshape(b * h, w * cin)
    out = torch.zeros((b * hp * wp, w2d.shape[1]), dtype=torch.float64)
    nrows = b * hp
    for tile in range(plan.tiles):
        r0 = tile * plan.rows
        runs = [flat[(rr // hp) * h + (rr % hp) * k:(rr // hp) * h + (rr % hp) * k + k].reshape(-1)
                for rr in range(r0, min(r0 + plan.rows, nrows))]
        stage = torch.cat(runs + [torch.full((16,), 0xA5, dtype=torch.uint8)]).double()
        npx = len(runs) * wp
        pixoff = torch.tensor([(p // wp) * k * w * cin + (p % wp) * k * cin for p in range(npx)])
        offs = torch.tensor([dy * w * cin + j for dy, j, _ in order])
        a = stage[pixoff[:, None] + offs[None, :]]
        out[r0 * wp:r0 * wp + npx] = a @ bmat
    return out.reshape(b, hp, wp, -1)


@pytest.mark.parametrize("b,h,w,cin,k,cout", [(2, 224, 224, 3, 4, 32), (2, 64, 64, 3, 4, 64)]
                         + STEM_RAGGED + [(2, 14, 13, 3, 3, 8), (3, 12, 12, 4, 2, 16)])
def test_stem_k_order_emulation_equals_plain(b, h, w, cin, k, cout):
    rng = np.random.RandomState(b * 100 + cout)
    x8 = torch.from_numpy(rng.randint(0, 256, (b, h, w, cin), np.uint8))
    w2d = torch.from_numpy(rng.randn(k * k * cin, cout).astype(np.float32) * 0.01)
    plan = ck.stem_plan(b, h, w, cin, k, cout, H100_SMS)
    order = ck.stem_k_order(k, cin)
    assert len(order) == 16 * 3  # three k-steps
    assert sorted(r for _, _, r in order if r >= 0) == list(range(k * k * cin))  # each row once
    got = _emulate_stem_product(x8, w2d, k, plan)
    want = torch.matmul(s2d_pack(x8, k).double(), w2d.double())
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)
    # and the plain version, the same sum in float32
    one = torch.ones(cout)
    plain = ck.stem_plain(x8, w2d, one, torch.zeros(cout), k, leaky=False)
    torch.testing.assert_close(plain.double(), want, atol=1e-5, rtol=1e-5)
