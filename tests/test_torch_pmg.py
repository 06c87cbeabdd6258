"""The port's PMG model on the CPU: golden fixtures, and the same params fed
to both packages (``params_from_jax``) through ``apply`` and ``apply_packed``."""

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
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import get_family
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg as tpmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models.trunk import trunk_plan
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
    normalize_uint8,
    s2d_pack,
)
from _torch_threads import one_torch_thread  # noqa: F401

# f32 CPU torch vs the frozen f32 reference logits (tests/test_parity.py:27)
ATOL = RTOL = 2e-4
PMG_FIXTURES = ["pmg_shipped", "pmg_deep_plan", "pmg_no_transformer", "pmg_tiny_instance_se"]

enable_parity_precision()


@pytest.mark.parametrize("name", PMG_FIXTURES)
def test_fixture_logits_match_reference(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    mod = get_family("pmg")
    spec = mod.build_spec(meta["tasks"], meta["hparams"])
    params = tckpt.load_torch_checkpoint("pmg", os.path.join(FIXTURES, f"{name}.pth"), spec)
    x = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1)))
    logits, aux = mod.apply(params, x, spec, capture=("features", "tokens", "pooled"))
    for i, task in enumerate(spec.tasks.names):
        want = data[f"logits/{task}"]
        np.testing.assert_allclose(
            logits[:, i, : want.shape[1]].numpy(), want, atol=ATOL, rtol=RTOL, err_msg=task
        )
    assert aux["features"].shape[-1] == spec.trunk_channels
    assert aux["pooled"].shape == (2, len(spec.tasks), spec.d_model)


SMALL = {
    "batch": dict(ndf=8, patch_size=64, patch_div=3, gram_channels=16, d_model=32,
                  transformer_layers=1, transformer_heads=2, norm="batch"),
    "instance_se": dict(ndf=8, patch_size=16, patch_div=2, gram_channels=8, d_model=16,
                        transformer_layers=1, transformer_heads=2, norm="instance",
                        use_channel_attention=True),
    "group_no_tx": dict(ndf=32, patch_size=64, patch_div=2, gram_channels=8, d_model=16,
                        transformer_layers=0, use_token_attention=False, norm="group"),
}
TASKS = {"a": ["x", "y", "z"], "b": ["p", "q"]}


def _jax_and_port(case):
    import jax

    from wadt.models import pmg as jpmg

    jspec = jpmg.build_spec(TASKS, SMALL[case])
    jparams = jpmg.init(jax.random.PRNGKey(3), jspec)
    if jspec.norm == "batch":  # non-trivial running stats
        rng = np.random.RandomState(5)
        for blk in jparams["trunk"]:
            c = blk["norm"]["mean"].shape[0]
            blk["norm"]["mean"] = rng.randn(c).astype(np.float32) * 0.1
            blk["norm"]["var"] = rng.rand(c).astype(np.float32) + 0.5
    tspec = tpmg.build_spec(TASKS, SMALL[case])
    return jpmg, jspec, jparams, tspec, tckpt.params_from_jax(jparams, tspec)


@pytest.mark.parametrize("case", sorted(SMALL))
@pytest.mark.parametrize("layout", ["packed", "raw"])
def test_apply_packed_matches_jax(case, layout):
    import jax.numpy as jnp

    from wadt.ops.preprocess import s2d_pack_uint8

    jpmg, jspec, jparams, tspec, tparams = _jax_and_port(case)
    k = jspec.plan[0].kernel
    u8 = np.random.RandomState(11).randint(0, 256, (2, 64, 64, 3), np.uint8)
    z8 = s2d_pack_uint8(u8, k)
    want, _ = jpmg.apply_packed(jparams, jnp.asarray(z8), jspec)
    got, _ = tpmg.apply_packed(tparams, torch.from_numpy(z8 if layout == "packed" else u8), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(SMALL))
def test_apply_and_gram_reentry_match_jax(case):
    import jax.numpy as jnp

    from wadt.ops.gram import patch_gram_tokens as jgram_tokens
    from wadt.ops.nn import conv2d as jconv2d
    from wadt.ops.preprocess import normalize_uint8 as jnormalize

    jpmg, jspec, jparams, tspec, tparams = _jax_and_port(case)
    u8 = np.random.RandomState(12).randint(0, 256, (2, 64, 64, 3), np.uint8)
    want, jaux = jpmg.apply(jparams, jnormalize(jnp.asarray(u8)), jspec,
                            capture=("features", "tokens", "pooled"))
    got, taux = tpmg.apply(tparams, normalize_uint8(torch.from_numpy(u8)), tspec,
                           capture=("features", "tokens", "pooled"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    for tap in ("features", "tokens", "pooled"):
        np.testing.assert_allclose(taux[tap].numpy(), np.asarray(jaux[tap]),
                                   atol=ATOL, rtol=RTOL, err_msg=tap)
    feats = jaux["features"]
    if jspec.use_channel_attention:
        return  # head_from_gram_tokens re-enters after SE + chan_proj
    grams = jgram_tokens(jconv2d(feats, jparams["chan_proj"]), jspec.patch_div)
    np.testing.assert_allclose(
        tpmg.head_from_gram_tokens(tparams, torch.from_numpy(np.asarray(grams)), tspec).numpy(),
        np.asarray(jpmg.head_from_gram_tokens(jparams, grams, jspec)),
        atol=ATOL, rtol=RTOL,
    )


def test_apply_packed_equals_apply_at_shipped_width():
    """The stem fold is exact at the shipped width: uint8 stem path vs the
    float path on the same params."""
    import jax

    from wadt.models import pmg as jpmg

    hp = dict(ndf=32, patch_size=64, patch_div=3, gram_channels=96, d_model=192,
              transformer_layers=2, transformer_heads=4)
    spec = tpmg.build_spec(TASKS, hp)
    params = tckpt.params_from_jax(jpmg.init(jax.random.PRNGKey(0), jpmg.build_spec(TASKS, hp)), spec)
    u8 = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 224, 224, 3), np.uint8))
    want, _ = tpmg.apply(params, normalize_uint8(u8), spec)
    got, _ = tpmg.apply_packed(params, s2d_pack(u8, 4).contiguous(), spec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


def test_params_from_jax_rejects_mismatched_tree():
    jpmg, jspec, jparams, tspec, _ = _jax_and_port("batch")
    bad = dict(jparams)
    del bad["transformer"]
    with pytest.raises(ValueError, match="do not match"):
        tckpt.params_from_jax(bad, tspec)


@pytest.mark.parametrize("k,stride,pad", [(4, 4, 0), (1, 1, 0), (4, 2, 1), (3, 1, 1)])
def test_conv2d_matches_jax(k, stride, pad):
    """Non-overlapping convs take the s2d + matmul route, others F.conv2d."""
    import jax.numpy as jnp

    from wadt.ops.nn import conv2d as jconv2d

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import conv2d

    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, 18, 17, 8).astype(np.float32)
    p = {"w": rng.randn(k, k, 8, 12).astype(np.float32) * 0.1,
         "b": rng.randn(12).astype(np.float32)}
    want = jconv2d(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()}, stride, pad)
    got = conv2d(torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()}, stride, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("args", [
    (32, 64, 4, 4, 0, 1, 0),
    (8, 256, 4, 4, 0, 1, 0),
    (16, 16, 4, 4, 0, 1, 0),
    (64, 70, 4, 2, 1, 4, 1),
    (600, 1000, 4, 2, 1, 4, 1),
    (32, 4, 4, 4, 0, 1, 0),
])
def test_trunk_plan_equal(args):
    from wadt.models.trunk import trunk_plan as jtrunk_plan

    got, want = trunk_plan(*args), jtrunk_plan(*args)
    assert got == want
    assert [b._asdict() for b in got] == [b._asdict() for b in want]


def test_spec_defaults_match_jax():
    import dataclasses

    from wadt.models import pmg as jpmg

    assert tpmg.DEFAULTS == jpmg.DEFAULTS
    hp = {"ndf": 32, "patch_size": 64, "patch_div": 3, "gram_channels": 96, "d_model": 192,
          "transformer_layers": 2, "transformer_heads": 4, "unrelated": 1}
    t, j = tpmg.build_spec(TASKS, hp), jpmg.build_spec(TASKS, hp)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.plan == j.plan
    assert tpmg.supports_packed_input(t) == jpmg.supports_packed_input(j)


def test_wrong_family_checkpoint_names_the_family():
    """A PM checkpoint loaded as PMG names PM; PM is a ported family now."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm as tpm

    with open(os.path.join(FIXTURES, "pm_small.json")) as f:
        meta = json.load(f)
    spec = tpmg.build_spec(meta["tasks"], {})
    with pytest.raises(ValueError, match="schema matches PM"):
        tckpt.load_torch_checkpoint("pmg", os.path.join(FIXTURES, "pm_small.pth"), spec)
    assert get_family("pm") is tpm
    with pytest.raises(ValueError, match="unknown model family"):
        get_family("vit")


def test_preprocess_matches_jax():
    from PIL import Image

    from wadt.ops import preprocess as jpre

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        preprocess as tpre,
    )

    rng = np.random.RandomState(4)
    for size in [(300, 260), (256, 400), (224, 224)]:
        img = Image.fromarray(rng.randint(0, 256, size + (3,), np.uint8))
        np.testing.assert_array_equal(tpre.load_image_uint8(img), jpre.load_image_uint8(img))
    u8 = rng.randint(0, 256, (2, 9, 9, 3), np.uint8)
    np.testing.assert_allclose(tpre.normalize_uint8(torch.from_numpy(u8)).numpy(),
                               np.asarray(jpre.normalize_uint8(u8)), atol=1e-6, rtol=1e-6)
    for k in (2, 4):
        packed = tpre.s2d_pack(torch.from_numpy(u8), k).numpy()
        np.testing.assert_array_equal(packed, jpre.s2d_pack_uint8(u8, k))
        np.testing.assert_array_equal(tpre.s2d_unpack(torch.from_numpy(packed), k).numpy(),
                                      jpre.s2d_unpack_uint8(packed, k))
    for a, b in zip(tpre.packed_affine(4), jpre.packed_affine(4)):
        np.testing.assert_array_equal(a, b)


def test_load_state_dict_unwraps_containers(tmp_path):
    """{'model': ...} containers and DataParallel ``module.`` prefixes."""
    state = torch.load(os.path.join(FIXTURES, "pmg_shipped.pth"), map_location="cpu")
    wrapped = {"model": {"module." + k: v for k, v in state.items()}, "epoch": 3}
    torch.save(wrapped, tmp_path / "wrapped.pth")
    np.savez(tmp_path / "plain.npz", **{k: v.numpy() for k, v in state.items()})
    plain = tckpt.load_state_dict(os.path.join(FIXTURES, "pmg_shipped.pth"))
    for other in (tckpt.load_state_dict(str(tmp_path / "wrapped.pth")),
                  tckpt.load_state_dict(str(tmp_path / "plain.npz"))):
        assert sorted(other) == sorted(plain)
        for k in plain:
            np.testing.assert_array_equal(other[k], plain[k])
    assert tckpt.sniff_family(wrapped["model"]) == "pmg"
