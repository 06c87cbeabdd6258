"""The port's explainability workload on the CPU (``…_torch/workloads/explain.py``)
against the JAX package's: the nine golden Grad-CAMs through ``gradcam_split``,
the ``Explainer`` on the same params (``params_from_jax``) for PMG, PM and
RTM (both targets), integrated gradients by both quadratures, the target
rule, and the host rendering byte for byte."""

import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES

import wadt  # noqa: F401
from wadt.models import pm as jpm
from wadt.models import pmg as jpmg
from wadt.models import rtm as jrtm
from wadt.workloads import explain as jex

import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    IGNORE_INDEX,
    enable_parity_precision,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.checkpoint import (
    params_from_jax,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
    pm,
    pmg,
    rtm,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models.trunk import (
    apply_trunk,
    apply_trunk_from_last_conv,
    trunk_last_conv,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
    cuda_kernels as ck,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import cast_tree
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
    explain as tex,
)
from _torch_threads import one_torch_thread  # noqa: F401

enable_parity_precision()

# the JAX package's bound for the golden CAMs (tests/test_parity.py:146)
GOLDEN_TOL = 5e-3
# port against the JAX Explainer on the same params: float32 on both sides,
# the sums in other orders
CAM_ATOL = 1e-4
LOGIT_ATOL = 1e-5
IG_REL = 1e-4  # times max|attr|

GOLDEN = ["pm_ablate", "pm_batchnorm_sigmoid", "pm_deep_plan", "pm_no_se", "pm_small",
          "pmg_tiny_instance_se", "rtm_trunc5_attn", "rtm_trunc5_default_dim", "rtm_trunc6_gap"]

TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
# the tiny PMG spec of tests/test_explain_stream.py:12-16
PMG_TINY = dict(ndf=8, patch_size=64, patch_div=2, gram_channels=16, d_model=32,
                transformer_layers=1, transformer_heads=2, norm="batch")
CASES = {
    "pmg": ("pmg", jpmg, pmg, PMG_TINY, "stem_conv"),
    # batch norm: the default instance norm makes every CAM at its input 0
    # (see test_golden_cam_through_gradcam_split)
    "pm": ("pm", jpm, pm, dict(ndf=8, patch_size=16, norm="batch"), "stem_conv"),
    "rtm_stem_conv": ("rtm", jrtm, rtm, dict(truncate_layer=5, attn_token_dim=32), "stem_conv"),
    "rtm_backbone_out": ("rtm", jrtm, rtm, dict(truncate_layer=5, attn_token_dim=32),
                         "backbone_out"),
}


def _fixture_engine(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        meta = json.load(f)
    eng = port.load_engine(meta["family"], os.path.join(FIXTURES, f"{name}.pth"), meta["tasks"],
                           meta["hparams"], batch_size=2, device="cpu")
    return meta, np.load(os.path.join(FIXTURES, f"{name}.npz")), eng


def _golden_raw_cam(name, dtype):
    """The fixture's Grad-CAM before the min-max: the raw CAM [B, h, w] of
    the fixture's normalized input through the port's split at its
    target, on the params of a loaded engine cast to ``dtype``."""
    meta, data, eng = _fixture_engine(name)
    x = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dtype)
    params = cast_tree(eng.params, dtype)
    ti = eng.spec.tasks.names.index(str(data["gradcam/task"]))
    cls = torch.from_numpy(data["gradcam/classes"].astype(np.int64))
    target_feats, head_from = tex.gradcam_split(meta["family"], eng.spec)
    feats = target_feats(params, x).detach().requires_grad_(True)
    lg = head_from(params, feats)
    (grads,) = torch.autograd.grad(lg[:, ti, :].gather(1, cls[:, None]).sum(), feats)
    w = grads.mean(dim=(1, 2), keepdim=True)
    return torch.relu((feats * w).sum(-1)).detach(), data["gradcam/cam"]


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_cam_through_gradcam_split(name):
    """The reference's Grad-CAM (pytorch_grad_cam on the last top-level
    Conv2d) through the port's split.

    Where the reference's CAM carries a signal (its min-max reached 1) the
    port's must match it at the JAX package's 5e-3.  Where it does not, the
    target is the input of an instance norm, whose input gradient has zero
    spatial mean in every channel: the channel weights, and so the CAM, are
    exactly 0, and the fixture holds float32 rounding noise divided by the
    1e-7 floor (up to 6.6e-3 in pm_ablate).  There the port's raw CAM must be
    as empty: below the floor in float32, and zero to 1e-14 in float64."""
    cam, want = _golden_raw_cam(name, torch.float32)
    lo, hi = cam.amin(dim=(1, 2), keepdim=True), cam.amax(dim=(1, 2), keepdim=True)
    if want.max() == 1.0:
        got = ((cam - lo) / torch.clamp(hi - lo, min=1e-7)).numpy()
        np.testing.assert_allclose(got, want, atol=GOLDEN_TOL, rtol=GOLDEN_TOL)
    else:
        assert float((hi - lo).max()) < 1e-7
        cam64, _ = _golden_raw_cam(name, torch.float64)
        assert float(cam64.abs().max()) < 1e-14


def _pair(case, seed=0):
    family, jmod, tmod, hp, target = CASES[case]
    import jax

    jspec = jmod.build_spec(TASKS, hp)
    jparams = jmod.init(jax.random.PRNGKey(seed), jspec)
    tspec = tmod.build_spec(TASKS, hp)
    return (jex.Explainer(family, jspec, jparams, rtm_target=target),
            tex.Explainer(family, tspec, params_from_jax(jparams, tspec), rtm_target=target,
                          device="cpu"))


@pytest.fixture(scope="module")
def pairs():
    return {case: _pair(case) for case in CASES}


def _images(n=3, seed=0, size=64):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), np.uint8)


@pytest.mark.parametrize("case", list(CASES))
def test_gradcam_matches_jax_explainer(pairs, case):
    jx, tx = pairs[case]
    imgs = _images()
    cls = np.array([0, 1, 2], np.int32)
    jcam, jlog = jx.gradcam(imgs, "A", cls)
    tcam, tlog = tx.gradcam(imgs, "A", cls)
    assert tcam.shape == jcam.shape and tlog.shape == jlog.shape
    np.testing.assert_allclose(tcam, jcam, atol=CAM_ATOL, rtol=0)
    np.testing.assert_allclose(tlog, jlog, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tx.logits(imgs), jx.logits(imgs), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("method", ["gausslegendre", "riemann_right"])
@pytest.mark.parametrize("case", ["pmg", "pm"])
def test_integrated_gradients_match_jax_explainer(pairs, case, method):
    jx, tx = pairs[case]
    imgs = _images(2, seed=1)
    cls = np.array([2, 0], np.int32)
    want = jx.integrated_gradients(imgs, "A", cls, steps=6, method=method)
    got = tx.integrated_gradients(imgs, "A", cls, steps=6, method=method)
    assert got.shape == want.shape == (2, 64, 64, 3)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=IG_REL * scale, rtol=0)


@pytest.mark.parametrize("method", ["gausslegendre", "riemann_right"])
def test_rtm_integrated_gradients_match_jax_gradients(pairs, method):
    """RTM's integrated gradients against the JAX model's input gradients on
    the same normalized input, summed by the JAX Explainer's formula.

    Not against the JAX Explainer itself: inside its jit XLA fuses the
    uint8 normalize into one multiply-add, which moves a third of the input
    values by one float32 ulp from the unfused normalize of both packages,
    and at two of the six Gauss-Legendre nodes (alpha 0.169 and 0.831) this
    RTM's float32 gradient switches by 2.4-3.1 % of its max under such a
    change (both packages alike, against float64)."""
    import jax
    import jax.numpy as jnp

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        normalize_uint8,
    )

    jx, tx = pairs["rtm_stem_conv"]
    imgs = _images(2, seed=1)
    cls = np.array([2, 0], np.int32)
    steps = 6
    got = tx.integrated_gradients(imgs, "A", cls, steps=steps, method=method)
    x = normalize_uint8(torch.from_numpy(imgs)).numpy()

    def target(z):
        lg, _ = jrtm.apply(jx.params, z, jx.spec)
        return jnp.sum(jnp.take_along_axis(lg[:, 0, :], jnp.asarray(cls)[:, None], axis=-1))

    if method == "gausslegendre":
        nodes, weights = np.polynomial.legendre.leggauss(steps)
        alphas, wts = ((nodes + 1.0) / 2.0).astype(np.float32), (weights / 2.0).astype(np.float32)
    else:
        alphas = np.arange(1, steps + 1, dtype=np.float32) / steps
        wts = np.full((steps,), 1.0 / steps, np.float32)
    grad = jax.jit(jax.grad(target))
    total = np.zeros_like(x)
    for alpha, w in zip(alphas, wts):
        total = total + w * np.asarray(grad(jnp.asarray(alpha * x)))
    want = x * total
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=IG_REL * scale, rtol=0)


def test_integrated_gradients_completeness(pairs):
    """Completeness at 128 steps: the attributions sum to f(x) - f(0), within
    the JAX package's own bounds (tests/test_explain_stream.py:68)."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        normalize_uint8,
    )

    _, tx = pairs["pmg"]
    imgs = _images(2, seed=1)
    cls = np.array([0, 1], np.int32)
    attr = tx.integrated_gradients(imgs, "A", cls, steps=128)
    x = normalize_uint8(torch.from_numpy(imgs))
    with torch.no_grad():
        fx = pmg.apply(tx.params, x, tx.spec)[0][:, 0].numpy()[np.arange(2), cls]
        f0 = pmg.apply(tx.params, torch.zeros_like(x), tx.spec)[0][:, 0].numpy()[np.arange(2), cls]
    np.testing.assert_allclose(attr.reshape(2, -1).sum(-1), fx - f0, rtol=0.08, atol=0.05)


def test_resolve_targets_rule(pairs):
    jx, tx = pairs["pmg"]
    logits = np.random.RandomState(4).randn(4, 2, 3).astype(np.float32)
    logits[:, 1, 2] = 100.0  # a padded slot of task B: never an argmax
    labels = np.array([[1, IGNORE_INDEX], [IGNORE_INDEX, 0], [2, -1], [-1, 1]], np.int64)
    for task in ("A", "B"):
        ti = ("A", "B").index(task)
        k = TASKS[task].__len__()
        am = logits[:, ti, :k].argmax(-1)
        for default_argmax in (True, False):
            fallback = am if default_argmax else np.zeros(4, np.int64)
            got = tx.resolve_targets(task, labels, logits, default_argmax)
            lab = labels[:, ti]
            want = np.where((lab != IGNORE_INDEX) & (lab >= 0), lab, fallback)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, jx.resolve_targets(task, labels, logits,
                                                                  default_argmax))
        np.testing.assert_array_equal(tx.resolve_targets(task, None, logits), am)
        np.testing.assert_array_equal(tx.resolve_targets(task, None, logits, False), 0)


def test_trunk_split_equals_the_trunk():
    """trunk_last_conv then apply_trunk_from_last_conv is the trunk."""
    spec = pmg.build_spec(TASKS, PMG_TINY)
    params = pmg.init(torch.Generator().manual_seed(1), spec)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32))
    z = trunk_last_conv(params["trunk"], x, spec.plan, spec.norm)
    assert z.shape[-1] == spec.trunk_channels
    got = apply_trunk_from_last_conv(params["trunk"], z, spec.plan, spec.norm)
    torch.testing.assert_close(got, apply_trunk(params["trunk"], x, spec.plan, spec.norm),
                               atol=0, rtol=0)


def test_explainer_takes_inference_tensors_and_engine_params():
    """Params made under ``torch.inference_mode`` (which autograd cannot save)
    and an engine's params after a run both explain as fresh params do."""
    meta, data, eng = _fixture_engine("pmg_tiny_instance_se")
    imgs = _images(2, seed=3, size=96)
    eng.run(imgs)
    cls = np.array([0, 1], np.int32)
    task = eng.spec.tasks.names[0]
    want = tex.Explainer("pmg", eng.spec, eng.params, device="cpu").gradcam(imgs, task, cls)
    with torch.inference_mode():
        frozen = {k: v for k, v in eng.params.items()}
        frozen["chan_proj"] = {"w": eng.params["chan_proj"]["w"] * 1.0}
        assert frozen["chan_proj"]["w"].is_inference()
    got = tex.Explainer("pmg", eng.spec, frozen, device="cpu").gradcam(imgs, task, cls)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_explainer_wants_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = pmg.build_spec(TASKS, PMG_TINY)
    params = pmg.init(torch.Generator().manual_seed(0), spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.Explainer("pmg", spec, params)


def test_bf16_explainer_names_its_roadmap_item():
    """The JAX Explainer's bf16 mode meets float32 params in its first
    convolution and raises a TypeError there; the port refuses it by name."""
    spec = pmg.build_spec(TASKS, PMG_TINY)
    params = pmg.init(torch.Generator().manual_seed(0), spec)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A35"):
        tex.Explainer("pmg", spec, params, dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("cmap", ["hot", "jet"])
def test_overlay_and_colormap_bytes_equal_jax(cmap):
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (96, 80, 3), np.uint8)
    cam = rng.rand(7, 6).astype(np.float32)
    np.testing.assert_array_equal(tex.apply_colormap(cam, cmap), jex.apply_colormap(cam, cmap))
    for alpha in (0.45, 0.5):
        np.testing.assert_array_equal(tex.overlay_cam(img, cam, cmap, alpha),
                                      jex.overlay_cam(img, cam, cmap, alpha))


def test_ig_heatmap_equals_jax():
    attr = np.random.RandomState(6).randn(32, 24, 3).astype(np.float32)
    np.testing.assert_array_equal(tex.ig_heatmap(attr), jex.ig_heatmap(attr))
    zero = np.zeros((4, 4, 3), np.float32)
    np.testing.assert_array_equal(tex.ig_heatmap(zero), jex.ig_heatmap(zero))


def test_save_gradcam_batch_names_and_images(pairs, tmp_path):
    jx, tx = pairs["pmg"]
    imgs = _images(3, seed=7)
    labels = np.array([[1, 0], [IGNORE_INDEX, 1], [2, IGNORE_INDEX]], np.int64)
    jex.save_gradcam_batch(jx, imgs, labels, "A", str(tmp_path / "j"), batch_idx=2)
    tex.save_gradcam_batch(tx, imgs, labels, "A", str(tmp_path / "t"), batch_idx=2)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert len(names) == 3 and all(n.startswith("gradcam_b0002_i") for n in names)
    assert "gradcam_b0000_i000_task-A_class-1-a1.png".replace("b0000", "b0002") in names
    import cv2

    for n in names:
        a, b = cv2.imread(str(tmp_path / "t" / n)), cv2.imread(str(tmp_path / "j" / n))
        assert a.shape == (64, 128, 3)
        # the CAMs agree within CAM_ATOL, so an overlay byte moves by at most one
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.cuda
def test_explainer_on_card_matches_cpu_through_k1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode (run chip_smoke.py there)")
    _, tx = _pair("pmg")
    imgs = _images(4, seed=8)
    cls = np.array([0, 1, 2, 0], np.int32)
    card = tex.Explainer("pmg", tx.spec, tx.params)
    ck.reset_launches()
    cam, logits = card.gradcam(imgs, "A", cls)
    assert ck.LAUNCHES["patch_gram"] >= 1
    want_cam, want_logits = tx.gradcam(imgs, "A", cls)
    np.testing.assert_allclose(cam, want_cam, atol=1e-3, rtol=0)
    np.testing.assert_allclose(logits, want_logits, atol=1e-4 * np.abs(want_logits).max(), rtol=0)
