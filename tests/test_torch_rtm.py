"""The port's RTM family on the CPU: the ResNet trunk, the model, its
checkpoint leg, the camera fold and its int8 kernel's plain version (K6),
``StreamPredictor`` and ``Engine`` on RTM, and the golden walk, each against
the JAX package on the same numpy inputs and parameters (``params_from_jax``).

K6 itself runs only on a CUDA card: the ``cuda``-marked test holds it
against its plain version there and skips elsewhere.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

import wadt  # noqa: F401
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    enable_parity_precision,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import checkpoint as tckpt
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import resnet as tresnet
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import rtm as trtm
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import goldens as tgoldens
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream as tstream
from _torch_threads import one_torch_thread  # noqa: F401

TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
SMALL = dict(truncate_layer=5, attn_token_dim=32)  # tests/test_explain_stream.py:378
RTM_FIXTURES = ["rtm_trunc5_attn", "rtm_trunc5_default_dim", "rtm_trunc6_gap"]
FIXTURE_TOL = 2e-4  # tests/test_parity.py:27
ROUTES = ["generic", "folded", "folded_q8"]

enable_parity_precision()


def _model(hp=SMALL, seed=3, tasks=TASKS):
    """The same random RTM in both packages, with non-trivial BN statistics."""
    import jax

    from wadt.models import rtm as jrtm

    jspec = jrtm.build_spec(tasks, hp)
    jparams = jrtm.init(jax.random.PRNGKey(seed), jspec)
    rng = np.random.RandomState(5)

    def perturb(bn):
        c = bn["mean"].shape[0]
        bn["mean"] = rng.randn(c).astype(np.float32) * 0.1
        bn["var"] = rng.rand(c).astype(np.float32) + 0.5

    bb = jparams["backbone"]
    perturb(bb["bn1"])
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        for block in bb[stage]:
            for k in ("bn1", "bn2", "bn3"):
                perturb(block[k])
            if "downsample" in block:
                perturb(block["downsample"]["bn"])
    tspec = trtm.build_spec(tasks, hp)
    return jspec, jparams, tspec, tckpt.params_from_jax(jparams, tspec)


@pytest.fixture(scope="module")
def model():
    return _model()


def _frames(n, size=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), np.uint8)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_trees_equal(a, b, atol=0.0):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
        y = np.asarray(y.numpy() if isinstance(y, torch.Tensor) else y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_allclose(x, y, atol=atol, rtol=0, err_msg=str(path))


def _fixture(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    spec = trtm.build_spec(meta["tasks"], meta["hparams"])
    return meta, data, spec


def _nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))))


# -- ResNet trunk ----------------------------------------------------------------


@pytest.mark.parametrize("truncate", [5, 6])
def test_resnet_apply_truncated_matches_jax(model, truncate):
    import jax.numpy as jnp

    from wadt.models import resnet as jresnet

    _, jparams, _, tparams = model
    x = np.random.RandomState(truncate).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jresnet.apply_truncated(jparams["backbone"], jnp.asarray(x), truncate))
    got = tresnet.apply_truncated(tparams["backbone"], torch.from_numpy(x), truncate)
    assert got.shape == want.shape == (2, 16 // (2 ** (truncate - 5)), 16 // (2 ** (truncate - 5)),
                                       tresnet.stage_out_channels(truncate))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_resnet_stem_split_and_pool_match_jax(model):
    import jax.numpy as jnp

    from wadt.models import resnet as jresnet

    _, jparams, _, tparams = model
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    ja = jresnet.stem_conv(jparams["backbone"], jnp.asarray(x))
    ta = tresnet.stem_conv(tparams["backbone"], torch.from_numpy(x))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=1e-5)
    want = jresnet.apply_truncated_from_stem(jparams["backbone"], ja, 5)
    got = tresnet.apply_truncated_from_stem(tparams["backbone"], ta, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    pooled = tresnet.max_pool_3x3_s2(ta)
    np.testing.assert_array_equal(
        pooled.numpy(), np.asarray(jresnet.max_pool_3x3_s2(jnp.asarray(ta.numpy()))))
    assert [tresnet.stage_out_channels(n) for n in range(0, 11)] == \
        [jresnet.stage_out_channels(n) for n in range(0, 11)]


@pytest.mark.parametrize("hp", [SMALL, {}, dict(truncate_layer=6, use_attention=False,
                                                  cls_hidden_dims=[16, 8], cls_num_layers=2)],
                         ids=["small", "headline", "gap_mlp"])
def test_init_tree_matches_jax_layout(hp):
    """Same tree, shapes and dtypes as the JAX init; values inside torch's
    default kaiming-uniform bound."""
    import jax

    from wadt.models import rtm as jrtm

    tasks = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
    jp = jax.eval_shape(lambda k: jrtm.init(k, jrtm.build_spec(tasks, hp)), jax.random.PRNGKey(0))
    tp = trtm.init(torch.Generator().manual_seed(0), trtm.build_spec(tasks, hp))
    jl, tl = list(_leaves(jp)), list(_leaves(tp))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32, path
    w = tp["backbone"]["layer1"][0]["conv2"]["w"]
    assert 0 < float(w.abs().max()) <= 1.0 / np.sqrt(9 * 64)
    again = trtm.init(torch.Generator().manual_seed(0), trtm.build_spec(tasks, hp))
    _assert_trees_equal(tp, again)


def test_spec_matches_jax():
    from wadt.models import rtm as jrtm

    assert trtm.DEFAULTS == jrtm.DEFAULTS
    for hp in (SMALL, {}, dict(truncate_layer=3, use_attention=False, cls_hidden_dims=[8],
                               cls_num_layers=1, unrelated=1)):
        t, j = trtm.build_spec(TASKS, hp), jrtm.build_spec(TASKS, hp)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.num_features, t.token_dim, t.mlp_dims) == (j.num_features, j.token_dim, j.mlp_dims)


# -- attention and the model ---------------------------------------------------


def test_rtm_task_attention_matches_jax(model):
    import jax.numpy as jnp

    from wadt.ops.attention import rtm_task_attention as jattn

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.attention import (
        rtm_task_attention,
    )

    _, jparams, _, tparams = model
    tokens = np.random.RandomState(2).randn(2, 9, 256).astype(np.float32)
    want = np.asarray(jattn(jnp.asarray(tokens), jparams["attn"]))
    got = rtm_task_attention(torch.from_numpy(tokens), tparams["attn"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", RTM_FIXTURES)
def test_rtm_apply_matches_golden_fixture(name):
    _, data, spec = _fixture(name)
    params = tckpt.load_torch_checkpoint("rtm", os.path.join(FIXTURES, f"{name}.pth"), spec)
    with torch.inference_mode():
        logits, aux = trtm.apply(params, _nhwc(data["input"]), spec, capture=("features",))
    assert aux["features"].shape[-1] == spec.num_features
    for i, task in enumerate(spec.tasks.names):
        want = data[f"logits/{task}"]
        np.testing.assert_allclose(logits[:, i, : want.shape[1]].numpy(), want,
                                   atol=FIXTURE_TOL, rtol=FIXTURE_TOL, err_msg=f"{name}/{task}")


def test_rtm_embeddings_match_fixture():
    """The taps of tests/test_parity.py:73-84 on rtm_trunc5_attn."""
    _, data, spec = _fixture("rtm_trunc5_attn")
    params = tckpt.load_torch_checkpoint("rtm", os.path.join(FIXTURES, "rtm_trunc5_attn.pth"), spec)
    with torch.inference_mode():
        _, aux = trtm.apply(params, _nhwc(data["input"]), spec,
                            capture=("shared_embedding", "task_embeddings"))
    np.testing.assert_allclose(aux["shared_embedding"].numpy(), data["shared_embedding"],
                               atol=FIXTURE_TOL, rtol=FIXTURE_TOL)
    for i, task in enumerate(spec.tasks.names):
        np.testing.assert_allclose(aux["task_embeddings"][:, i].numpy(), data[f"task_emb/{task}"],
                                   atol=FIXTURE_TOL, rtol=FIXTURE_TOL)


def test_head_apply_matches_jax(model):
    import jax.numpy as jnp

    from wadt.models import rtm as jrtm

    jspec, jparams, tspec, tparams = model
    feats = np.random.RandomState(3).randn(2, 4, 4, 256).astype(np.float32)
    want, jaux = jrtm.head_apply(jparams, jnp.asarray(feats), jspec, capture=("task_embeddings",))
    got, taux = trtm.head_apply(tparams, torch.from_numpy(feats), tspec, capture=("task_embeddings",))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(taux["task_embeddings"].numpy(), np.asarray(jaux["task_embeddings"]),
                               atol=1e-5, rtol=1e-5)


# -- checkpoint leg --------------------------------------------------------------


def _rename_backbone(state, schema):
    """truncated_encoder.<seq>.rest -> backbone.<root>.rest or raw <root>.rest."""
    out = {}
    for k, v in state.items():
        if k.startswith("truncated_encoder."):
            seq, _, tail = k[len("truncated_encoder."):].partition(".")
            root = tckpt._SEQ_TO_NAME[int(seq)]
            k = f"backbone.{root}.{tail}" if schema == "backbone" else f"{root}.{tail}"
        out[k] = v
    return out


@pytest.mark.parametrize("schema", ["backbone", "raw"])
@pytest.mark.parametrize("name", ["rtm_trunc5_attn", "rtm_trunc6_gap"])
def test_checkpoint_key_schemas_load_to_the_same_tree(name, schema):
    _, _, spec = _fixture(name)
    state = tckpt.load_state_dict(os.path.join(FIXTURES, f"{name}.pth"))
    renamed = _rename_backbone(state, schema)
    assert not any(k.startswith("truncated_encoder.") for k in renamed)
    assert tckpt.sniff_family(renamed) == "rtm"
    _assert_trees_equal(tckpt.convert("rtm", state, spec), tckpt.convert("rtm", renamed, spec))


@pytest.mark.parametrize("name", RTM_FIXTURES)
def test_convert_rtm_matches_jax(name):
    from wadt.engine import checkpoint as jckpt
    from wadt.models import rtm as jrtm

    meta, _, spec = _fixture(name)
    state = tckpt.load_state_dict(os.path.join(FIXTURES, f"{name}.pth"))
    want = jckpt.convert_rtm(state, jrtm.build_spec(meta["tasks"], meta["hparams"]))
    _assert_trees_equal(tckpt.convert_rtm(state, spec), want)


def test_flat_classifier_and_partial_copy():
    from wadt.engine import checkpoint as jckpt
    from wadt.models import rtm as jrtm

    meta, _, spec = _fixture("rtm_trunc5_default_dim")
    state = tckpt.load_state_dict(os.path.join(FIXTURES, "rtm_trunc5_default_dim.pth"))
    flat = {k.replace(".0.weight", ".weight").replace(".0.bias", ".bias")
            if k.startswith("classifiers.") else k: v for k, v in state.items()}
    assert "classifiers.classifier_Visibility.weight" in flat
    _assert_trees_equal(tckpt.convert_rtm(flat, spec), tckpt.convert_rtm(state, spec))
    # a registry with one class fewer for "Visibility": the overlap is copied
    tasks = dict(meta["tasks"], Visibility=meta["tasks"]["Visibility"][:3])
    small = trtm.build_spec(tasks, meta["hparams"])
    got = tckpt.convert_rtm(state, small)
    want = jckpt.convert_rtm(state, jrtm.build_spec(tasks, meta["hparams"]))
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(got["final"]["w"][1, :, :3].numpy(),
                                  state["classifiers.classifier_Visibility.0.weight"][:3].T)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.convert_rtm(state, small, partial_copy=False)


def test_wrong_family_names_the_schema():
    _, _, spec = _fixture("rtm_trunc5_attn")
    with pytest.raises(ValueError, match="schema matches PMG"):
        tckpt.load_torch_checkpoint("rtm", os.path.join(FIXTURES, "pmg_shipped.pth"), spec)


# -- camera fold -------------------------------------------------------------------


def test_pack_stem_weights_bit_exact(model):
    import jax.numpy as jnp

    from wadt.models import rtm as jrtm

    _, jparams, _, tparams = model
    want = np.asarray(jrtm.pack_stem_weights(jnp.asarray(jparams["backbone"]["conv1"]["w"])))
    got = trtm.pack_stem_weights(tparams["backbone"]["conv1"]["w"])
    assert got.shape == (4, 4, 12, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="ResNet stem conv expected"):
        trtm.pack_stem_weights(torch.zeros(3, 3, 3, 8))


def _q8_close(got8, want8, w, scale):
    """int8 values equal, or off by one only where |w/scale| lies within
    1e-4 of a .5 boundary (the fold's float32 sums differ in order)."""
    diff = np.abs(got8.astype(np.int32) - want8.astype(np.int32))
    assert diff.max() <= 1
    v = np.abs(np.asarray(w, np.float64) / np.asarray(scale, np.float64)[:, None, :])
    near = np.abs(v - np.floor(v) - 0.5) < 1e-4
    assert not (diff.astype(bool) & ~near).any()


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "q8"])
def test_fold_stream_weights_matches_jax(quantize):
    from wadt.models import rtm as jrtm

    hp = dict(SMALL, cls_hidden_dims=[16], cls_num_layers=1)
    jspec, jparams, tspec, tparams = _model(hp)
    jf = jrtm.fold_stream_weights(jparams, jspec, quantize_fold=quantize)
    tf = trtm.fold_stream_weights(tparams, tspec, quantize_fold=quantize)
    assert sorted(jf) == sorted(tf)
    np.testing.assert_allclose(tf["attn_pq"].numpy(), np.asarray(jf["attn_pq"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tf["stem_w"].numpy(), np.asarray(jf["stem_w"]))
    if not quantize:
        np.testing.assert_allclose(tf["attn_fold"].numpy(), np.asarray(jf["attn_fold"]),
                                   atol=1e-5, rtol=1e-5)
        return
    assert "attn_fold" not in tf and "mlp" not in tf
    np.testing.assert_allclose(tf["attn_fold_scale"].numpy(), np.asarray(jf["attn_fold_scale"]),
                               atol=1e-6, rtol=0)
    assert tf["attn_fold_q8"].dtype == torch.int8 and tf["attn_fold_q8"].is_contiguous()
    jfold = np.einsum("tcd,tde->tce", np.asarray(jparams["attn"]["proj_w"], np.float64),
                      np.asarray(jparams["attn"]["out_w"], np.float64))
    _q8_close(tf["attn_fold_q8"].numpy(), np.asarray(jf["attn_fold_q8"]), jfold,
              np.asarray(jf["attn_fold_scale"]))
    (tl,), (jl,) = tf["mlp_q8"], jf["mlp_q8"]
    np.testing.assert_array_equal(tl["w8"].numpy(), np.asarray(jl["w8"]))
    np.testing.assert_array_equal(tl["scale"].numpy(), np.asarray(jl["scale"]))
    with pytest.raises(ValueError, match="use_attention"):
        trtm.fold_stream_weights(tparams, dataclasses.replace(tspec, use_attention=False))


@pytest.mark.parametrize("pack_stem", [True, False], ids=["packed_stem", "raw_stem"])
def test_apply_stream_matches_jax(model, pack_stem):
    import jax.numpy as jnp

    from wadt.models import rtm as jrtm

    jspec, jparams, tspec, _ = model
    x = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    jf = jrtm.fold_stream_weights(jparams, jspec, pack_stem=pack_stem)
    assert ("stem_w" in jf) == pack_stem
    want = np.asarray(jrtm.apply_stream(jf, jnp.asarray(x), jspec))
    got = trtm.apply_stream(tckpt.params_from_jax(jf, tspec), torch.from_numpy(x), tspec)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_params_from_jax_takes_the_fold_trees(model):
    from wadt.models import rtm as jrtm

    jspec, jparams, tspec, _ = model
    for quantize in (False, True):
        jf = jrtm.fold_stream_weights(jparams, jspec, quantize_fold=quantize)
        tf = tckpt.params_from_jax(jf, tspec)
        _assert_trees_equal(tf, jax_tree_to_numpy(jf))
    with pytest.raises(ValueError, match="do not match"):
        tckpt.params_from_jax({"backbone": jparams["backbone"]}, tspec)


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


# -- K6: the int8 matvec's plain version ------------------------------------------------


def _int8_case(t, c, d, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, t, c).astype(np.float32)
    w8 = rng.randint(-127, 128, (t, c, d)).astype(np.int8)
    scale = (rng.rand(t, d).astype(np.float32) + 0.5) * 0.01
    return x, w8, scale


@pytest.mark.parametrize("t,c,d", [(3, 256, 64), (3, 256, 32), (4, 128, 256)])
def test_dequant_matvec_plain_matches_pallas_kernel(t, c, d):
    """The TPU kernel body, run in interpret mode with the script's own
    BlockSpecs at a small T, C, D."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from tools.exp_rtm_int8_stream import _dequant_matvec_kernel

    x, w8, scale = _int8_case(t, c, d)
    want = pl.pallas_call(
        _dequant_matvec_kernel,
        grid=(t,),
        in_specs=[
            pl.BlockSpec((t, c), lambda i: (0, 0)),
            pl.BlockSpec((c, d), lambda i: (i, 0)),
            pl.BlockSpec((t, d), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((t, d), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((t, d), jnp.float32),
        interpret=True,
    )(jnp.asarray(x[0]), jnp.asarray(w8.reshape(t * c, d)), jnp.asarray(scale))
    got = ck.dequant_matvec_plain(torch.from_numpy(x), torch.from_numpy(w8), torch.from_numpy(scale))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    ref = np.einsum("btc,tcd->btd", x.astype(np.float64),
                    w8.astype(np.float64) * scale.astype(np.float64)[:, None, :])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_dequant_matvec_checks_and_routes():
    x, w8, scale = (torch.from_numpy(a) for a in _int8_case(2, 16, 8))
    ck.reset_launches()
    got = ck.dequant_matvec(x, w8, scale)
    assert ck.LAUNCHES["dequant_matvec"] == 0
    torch.testing.assert_close(got, ck.dequant_matvec_plain(x, w8, scale), atol=0, rtol=0)
    with pytest.raises(ValueError, match="not supported"):
        ck.dequant_matvec(x.to("meta"), w8.to("meta"), scale.to("meta"))


# -- camera path -------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_stream_matches_jax(model, route):
    from wadt.models import rtm as jrtm
    from wadt.workloads.stream import StreamPredictor as JStream

    jspec, jparams, tspec, tparams = model
    if route == "generic":
        params = tparams
    else:
        params = tckpt.params_from_jax(
            jrtm.fold_stream_weights(jparams, jspec, quantize_fold=route == "folded_q8"), tspec)
    jp = JStream("rtm", jspec, jparams, use_kalman=True, trunk_kernel=route)
    tp = tstream.StreamPredictor("rtm", tspec, params, use_kalman=True, trunk_kernel=route,
                                 device="cpu")
    assert tp.route == route
    for i, frame in enumerate(_frames(3)):
        np.testing.assert_allclose(tp(frame), np.asarray(jp(frame)), atol=1e-5, rtol=1e-5,
                                   err_msg=f"{route} frame {i}")


def test_stream_routes_agree_within_fold_bounds(model):
    """The bounds of tests/test_explain_stream.py:386-396, on the port."""
    _, _, tspec, tparams = model
    frame = np.random.RandomState(2).randint(0, 256, (64, 64, 3), np.uint8)
    preds = {r: tstream.StreamPredictor("rtm", tspec, tparams, trunk_kernel=r, device="cpu")
             for r in ROUTES}
    pg, pf, pq = (preds[r](frame) for r in ROUTES)
    np.testing.assert_allclose(pf, pg, atol=5e-5, rtol=1e-4)
    np.testing.assert_array_equal(pf.argmax(-1), pg.argmax(-1))
    np.testing.assert_allclose(pq, pg, atol=0.02)
    np.testing.assert_array_equal(pq.argmax(-1), pg.argmax(-1))
    q8 = preds["folded_q8"].params
    assert q8["attn_fold_q8"].dtype == torch.int8 and "attn_fold" not in q8


def test_stream_auto_route_and_bad_choices(model):
    _, _, tspec, tparams = model
    assert tstream.StreamPredictor("rtm", tspec, tparams, device="cpu").route == "folded_q8"
    gap_spec = dataclasses.replace(tspec, use_attention=False)
    gap = {k: v for k, v in tparams.items() if k != "attn"}
    assert tstream.StreamPredictor("rtm", gap_spec, gap, device="cpu").route == "generic"
    with pytest.raises(ValueError, match="use_attention"):
        tstream.StreamPredictor("rtm", gap_spec, gap, trunk_kernel="folded", device="cpu")
    with pytest.raises(ValueError, match="not a RTM route"):
        tstream.StreamPredictor("rtm", tspec, tparams, trunk_kernel="fused", device="cpu")
    with pytest.raises(ValueError, match="head_fold applies only"):
        tstream.StreamPredictor("rtm", tspec, tparams, head_fold="fused_q8", device="cpu")
    f32 = trtm.fold_stream_weights(tparams, tspec)
    with pytest.raises(ValueError, match="does not fit"):
        tstream.StreamPredictor("rtm", tspec, f32, trunk_kernel="folded_q8", device="cpu")
    with pytest.raises(ValueError, match="not a PMG route"):
        from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
        pspec = pmg.build_spec(TASKS, {})
        tstream.StreamPredictor("pmg", pspec, {}, trunk_kernel="folded", device="cpu")


def test_entry_points_default_to_the_card(model, monkeypatch):
    _, _, tspec, tparams = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine("rtm", tspec, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamPredictor("rtm", tspec, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgoldens.rtm_stream_fixture_parity(FIXTURES)


# -- Engine and the golden walk ------------------------------------------------------


def test_engine_matches_jax_engine_on_fixture():
    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from wadt.engine import checkpoint as jckpt
    from wadt.engine.executor import Engine as JEngine
    from wadt.models import rtm as jrtm

    meta, _, _ = _fixture("rtm_trunc5_attn")
    path = os.path.join(FIXTURES, "rtm_trunc5_attn.pth")
    jspec = jrtm.build_spec(meta["tasks"], meta["hparams"])
    frames = _frames(3, 224, seed=4)
    want = JEngine("rtm", jspec, jckpt.load_torch_checkpoint("rtm", path, jspec),
                   batch_size=2).run(frames)
    eng = port.load_engine("rtm", path, meta["tasks"], meta["hparams"], batch_size=2,
                           capture=("features", "shared_embedding", "task_embeddings"),
                           device="cpu")
    got = eng.run(frames)
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got["preds"], np.asarray(want["preds"]))
    res = eng.step(frames[:2])
    assert res["features"].shape == (2, 56, 56, 256)
    assert res["shared_embedding"].shape == (2, 256)
    assert res["task_embeddings"].shape == (2, 3, 256)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "q8"])
def test_golden_walk_matches_jax(quantize):
    import jax.numpy as jnp

    from wadt.utils.goldens import rtm_stream_fixture_parity as jwalk

    got = tgoldens.rtm_stream_fixture_parity(FIXTURES, quantize_fold=quantize, device="cpu")
    want = jwalk(FIXTURES, jnp.float32, quantize_fold=quantize)
    assert [(n, a) for n, a, _ in got] == [(n, a) for n, a, _ in want]
    assert [n for n, _, _ in got] == ["rtm_trunc5_attn", "rtm_trunc5_default_dim"]
    assert all(a for _, a, _ in got)
    np.testing.assert_allclose([d for *_, d in got], [d for *_, d in want], atol=1e-4)
    assert max(d for *_, d in got) < (FIXTURE_TOL if not quantize else 0.05)


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,d", [(1, 12, 2048, 2048), (2, 3, 256, 32), (5, 3, 40, 24)])
def test_dequant_matvec_kernel_matches_plain_on_card(cuda_device, b, t, c, d):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(cuda_device)
    w8 = torch.from_numpy(rng.randint(-127, 128, (t, c, d)).astype(np.int8)).to(cuda_device)
    scale = torch.from_numpy(rng.rand(t, d).astype(np.float32) * 0.01).to(cuda_device)
    ck.reset_launches()
    got = ck.dequant_matvec(x, w8, scale)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["dequant_matvec"] == 1
    want = ck.dequant_matvec_plain(x, w8, scale)
    tol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
