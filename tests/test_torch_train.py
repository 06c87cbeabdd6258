"""The port's training path on the CPU against the JAX package's: batch norm
in train mode, every family's ``apply_train``, the masked loss with class
weights and focal modulation, the decay mask, three ``make_train_step``
steps per family (with gradient accumulation, class weights, focal loss and
a frozen encoder), a bf16 step, the random parts (augmentation, dropout),
native train-state checkpoints, and ``fit`` with resume.  The inputs are
numpy-seeded; both packages start from the same params, carried across by
``params_from_jax`` and ``train_state_from_jax``.  Dropout and augmentation
draw from different generators in the two packages, so the parity tests
run without them and the random parts are held to properties.
"""

import json
import os

import numpy as np
import pytest
import torch

import wadt  # noqa: F401
from tools.make_synth_dataset import make as make_synth
from wadt.config import IGNORE_INDEX

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import (
    fit as port_fit,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
    checkpoint as tck,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    class_mask,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
    pm as tpm,
    pmg as tpmg,
    rtm as trtm,
    trunk as ttrunk,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
    attention as tattn,
    norms as tnorms,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.augment import (
    DEFAULT_AUGMENT,
    augment_batch,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
    train as ttrain,
)
from _torch_threads import one_torch_thread  # noqa: F401

TINY = dict(ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
            transformer_layers=1, transformer_heads=2, norm="batch")
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
FAMILIES = {
    "pmg": (tpmg, TINY),
    "pm": (tpm, dict(ndf=8, patch_size=16)),  # PM's own norm, instance
    "rtm": (trtm, dict(truncate_layer=5, attn_token_dim=16)),  # through layer1
}
LR = 3e-4


def _np_tree(tree):
    return ttrain._map_tree(lambda _, t: t.detach().numpy(), tree)


def _jax_tree(tree):
    import jax.numpy as jnp

    return ttrain._map_tree(lambda _, t: jnp.asarray(t.detach().numpy()), tree)


def _port_init(family, hp=None, seed=0):
    """(spec, seeded params); an RTM tree keeps only the backbone stages its
    truncation runs (layer2-4 would only add untouched weights)."""
    mod, default_hp = FAMILIES[family]
    spec = mod.build_spec(TASKS, default_hp if hp is None else hp)
    params = mod.init(torch.Generator().manual_seed(seed), spec)
    if family == "rtm":
        for stage in ("layer2", "layer3", "layer4"):
            del params["backbone"][stage]
    return spec, params


def _jax_spec(family, hp=None):
    return _jax_module(family).build_spec(TASKS, FAMILIES[family][1] if hp is None else hp)


def _batch(seed, n=8, size=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, size, size, 3).astype(np.float32)
    y = np.stack([rng.randint(0, 3, n), rng.randint(0, 2, n)], axis=1).astype(np.int32)
    y[0, 1] = IGNORE_INDEX
    return x, y


def _jax_module(family):
    from wadt.models import pm, pmg, rtm

    return {"pmg": pmg, "pm": pm, "rtm": rtm}[family]


def _max(t):
    return float(t.max()) if t.numel() else 0.0


def _stats(tree):
    return {k: v for k, v in ttrain.leaf_dict(tree).items() if k.endswith(("/mean", "/var"))}


# ---------------------------------------------------------------------------
# Batch norm in train mode, and every family's apply_train
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["batch", "instance", "group"])
def test_trunk_train_matches_jax(norm):
    """batch_norm_train and apply_trunk_train: y within 1e-5, the running
    statistics within 1e-6 (train equals eval for instance and group norm)."""
    from wadt.models import trunk as jtrunk
    from wadt.ops.norms import batch_norm_train as jbn_train

    spec, params = _port_init("pmg", {**TINY, "ndf": 32, "norm": norm})
    rng = np.random.RandomState(3)
    for p in params["trunk"]:
        if norm == "batch":  # running statistics away from their init
            p["norm"]["mean"] = torch.from_numpy(rng.randn(p["norm"]["mean"].shape[0]).astype(np.float32))
            p["norm"]["var"] = torch.from_numpy(rng.rand(p["norm"]["var"].shape[0]).astype(np.float32) + 0.5)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    got, new = ttrunk.apply_trunk_train(params["trunk"], torch.from_numpy(x), spec.plan, norm)
    want, jnew = jtrunk.apply_trunk_train(_jax_tree(params["trunk"]), x, spec.plan, norm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    want_stats = {k: np.asarray(v) for k, v in _stats(ttrain._map_tree(lambda _, t: t, jnew)).items()}
    got_stats = _stats(new)
    assert set(got_stats) == set(want_stats) and (len(got_stats) > 0) == (norm == "batch")
    for k, v in got_stats.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k], atol=1e-6, rtol=1e-6)
    h = rng.randn(4, 6, 6, 16).astype(np.float32)
    p = {k: torch.from_numpy(rng.rand(16).astype(np.float32) + 0.5) for k in ("scale", "bias")}
    for a, b in zip(tnorms.batch_norm_train(torch.from_numpy(h), p),
                    jbn_train(h, {k: v.numpy() for k, v in p.items()})):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", ["pmg", "pm", "rtm"])
def test_apply_train_matches_jax(family):
    """apply_train without dropout: logits within 1e-5, the running
    statistics' update within 1e-6 (PM's instance norm has none)."""
    import jax

    hp = {**FAMILIES[family][1], "norm": "batch"} if family == "pm" else None
    spec, params = _port_init(family, hp)
    jspec = _jax_spec(family, hp)
    x, _ = _batch(5)
    got, upd = FAMILIES[family][0].apply_train(params, torch.from_numpy(x), spec, dropout_rate=0.0)
    want, jupd = jax.jit(lambda p, xx: _jax_module(family).apply_train(
        p, xx, jspec, rng=None, dropout_rate=0.0))(_jax_tree(params), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    root = "backbone" if family == "rtm" else "trunk"
    got_stats = _stats(upd[root])
    want_stats = _stats(ttrain._map_tree(lambda _, t: torch.tensor(np.asarray(t)),
                                         jax.device_get(jupd[root])))
    assert set(got_stats) == set(want_stats) and got_stats
    for k, v in got_stats.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# The loss, the class weights and the decay mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights,gamma", [(True, None), (False, 2.0), (True, 2.0), (False, None)],
                         ids=["weights", "focal", "weights_focal", "plain"])
def test_masked_cross_entropy_ex_matches_jax(weights, gamma):
    import jax.numpy as jnp

    from wadt.parallel.train import masked_cross_entropy_ex as jce

    rng = np.random.RandomState(0)
    logits = rng.randn(6, 2, 3).astype(np.float32) * 3
    labels = np.array([[0, 1], [2, 0], [1, IGNORE_INDEX], [0, 0], [IGNORE_INDEX, 1], [2, 1]], np.int32)
    mask = class_mask(tpmg.build_spec(TASKS, TINY).tasks)
    cw = np.array([[0.5, 2.0, 1.0], [1.5, 0.3, 0.0]], np.float32) if weights else None
    got, cnt = ttrain.masked_cross_entropy_ex(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask),
        None if cw is None else torch.from_numpy(cw), gamma)
    want, wcnt = jce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
                     None if cw is None else jnp.asarray(cw), gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


def test_masked_loss_keeps_the_padded_classes_float32():
    """bf16 logits: the padded classes still get float32's minimum, and the
    loss equals the float32 loss of the same (rounded) logits."""
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(4, 2, 3).astype(np.float32)).to(torch.bfloat16)
    labels = torch.from_numpy(np.array([[0, 1], [2, 0], [1, 1], [0, 0]], np.int32))
    mask = torch.from_numpy(class_mask(tpmg.build_spec(TASKS, TINY).tasks))
    a, _ = ttrain.masked_cross_entropy_ex(logits, labels, mask)
    b, _ = ttrain.masked_cross_entropy_ex(logits.float(), labels, mask)
    assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("mode,cap", [("median", 3.0), ("median", 10.0), ("mean", 10.0)])
def test_compute_class_weights_equals_jax(mode, cap):
    from wadt.parallel.train import compute_class_weights as jcw

    rng = np.random.RandomState(2)
    labels = np.stack([rng.choice(4, 50, p=[0.7, 0.2, 0.1, 0.0]), rng.randint(0, 2, 50)], 1)
    labels[rng.rand(*labels.shape) < 0.1] = IGNORE_INDEX
    np.testing.assert_array_equal(ttrain.compute_class_weights(labels, (4, 2), mode, cap),
                                  jcw(labels, (4, 2), mode, cap))


@pytest.mark.parametrize("family", ["pmg", "pm", "rtm"])
def test_decay_mask_same_leaves_as_jax(family):
    import jax

    from wadt.parallel.train import _decay_mask as jmask

    spec, params = _port_init(family, {**FAMILIES[family][1], "norm": "batch"}
                              if family == "pm" else None)
    want = jax.tree_util.tree_map_with_path(
        lambda path, v: (tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path), v),
        jmask(_np_tree(params)))
    want = dict(jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple)))
    got = {tuple(k.split("/")): v for k, v in ttrain.leaf_dict(ttrain._decay_mask(params)).items()}
    want = {tuple(str(p) for p in k): v for k, v in want.items()}
    assert got == want
    assert not all(got.values())  # the batch-norm statistics are not decayed
    trainable = ttrain.OptState(ttrain.make_optimizer(), ttrain.trainable_params(params, "cpu")).paths
    assert sorted(trainable) == sorted("/".join(k) for k, v in got.items() if v)


# ---------------------------------------------------------------------------
# make_train_step against the JAX package's
# ---------------------------------------------------------------------------

# (family, accum_steps, make_train_step kwargs)
STEP_CASES = {
    "pmg": ("pmg", 1, {}),
    "pmg_accum2_weights_focal_frozen": (
        "pmg", 2, dict(class_weights=np.array([[1.0, 2.0, 0.5], [0.3, 1.5, 0.0]], np.float32),
                       use_focal=True, freeze_encoder=True)),
    "pm": ("pm", 1, {}),
    "rtm": ("rtm", 1, {}),
}
STEPS = 3
# the stem children of RTM's backbone; its bottleneck blocks in train mode
# are held to JAX by test_apply_train_matches_jax
RTM_STEP_HPARAMS = dict(truncate_layer=4, attn_token_dim=16)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    """Three float32 steps (dropout 0, no augmentation), each from the JAX
    package's state of the moment carried across by ``train_state_from_jax``
    (so rounding differences do not compound through Adam from step to
    step): the loss within 1e-5 relative; the moments and the accumulated
    mean, statistics of the gradients, within 1e-4 x their leaf's max (the
    gradients' bound on the card, phase [20] of chip_smoke.py; a leaf of
    gradient noise to 1e-6 x the largest moment); the running statistics
    within 1e-5; the params within 1e-5.  Adam divides each element's
    gradient by its own magnitude: where an update's gradient is at rounding
    noise (below 1e-4 x the step's largest gradient; the attention key bias
    and a bias before a norm have exact gradient 0, the softmax and the norm
    being shift-invariant) two float32 implementations move it by amounts
    up to lr apart, so those elements are held to 2 x lr."""
    import jax
    import jax.numpy as jnp

    from wadt.parallel import train as jtrain

    family, accum, kw = STEP_CASES[case]
    hp = RTM_STEP_HPARAMS if family == "rtm" else None
    spec, params = _port_init(family, hp)
    jopt = jtrain.make_optimizer(accum_steps=accum)
    jparams = _jax_tree(params)
    jstate = jtrain.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    _, jstep = jtrain.make_train_step(family, _jax_spec(family, hp), jopt, dropout_rate=0.0, **kw)
    topt = ttrain.make_optimizer(accum_steps=accum)
    _, step = ttrain.make_train_step(family, spec, topt, dropout_rate=0.0, device="cpu", **kw)
    for i in range(STEPS):
        state = tck.train_state_from_jax(jstate, spec, topt)
        before = {p: t.detach().clone() for p, t in ttrain.leaf_dict(state.params).items()}
        x, y = _batch(10 + i)
        jstate, jloss = jstep(jstate, x, y)
        state, loss = step(state, x, y)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert state.step == int(jstate.step) == i + 1
        want = tck.train_state_from_jax(jstate, spec, topt)
        got_opt, want_opt = ttrain.leaf_dict(state.opt_state.tree()), ttrain.leaf_dict(
            want.opt_state.tree())
        assert set(got_opt) == set(want_opt)
        for p, w in want_opt.items():
            part = p.split("/")[0]
            if part == p:  # the update count and the mini-step
                assert float(got_opt[p]) == float(w), p
                continue
            # a leaf of gradient noise is held to float32's noise floor:
            # 1e-6 x the largest moment (squared for the second moment)
            top = max(float(v.abs().max()) for k, v in want_opt.items() if k.startswith(part + "/"))
            floor = (1e-12 if part == "exp_avg_sq" else 1e-6) * top
            tol = max(1e-4 * float(w.abs().max()), floor)
            np.testing.assert_allclose(got_opt[p].numpy(), w.numpy(), atol=tol, rtol=0, err_msg=p)
        ost = state.opt_state
        updated = (i + 1) % accum == 0
        top = max(float(t.grad.abs().max()) for t in ost.leaves)
        grads = dict(zip(ost.paths, ost.leaves))
        params_now = ttrain.leaf_dict(state.params)
        for p, w in ttrain.leaf_dict(want.params).items():
            got = params_now[p].detach()
            if p.endswith(("/mean", "/var")):
                np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5, rtol=1e-5, err_msg=p)
                continue
            err = (got - w.detach()).abs()
            noisy = grads[p].grad.abs() <= 1e-4 * top if updated else torch.zeros_like(err, dtype=bool)
            assert _max(err[~noisy]) <= 1e-5, p
            assert _max(err[noisy]) <= 2 * LR, p
            if not updated or (kw.get("freeze_encoder") and p.startswith("trunk/")):
                assert torch.equal(got, before[p]), p  # no update, or a frozen encoder


def test_train_state_from_jax_carries_the_optax_state():
    """After two JAX steps, the port's state holds optax's moments, count and
    step (and MultiSteps' running mean and mini-step), leaf for leaf."""
    import jax

    from wadt.parallel import train as jtrain

    spec, params = _port_init("pmg")
    jopt = jtrain.make_optimizer(accum_steps=3)
    jparams = _jax_tree(params)
    jstate = jtrain.TrainState(jparams, jopt.init(jparams), jax.numpy.zeros((), jax.numpy.int32))
    _, jstep = jtrain.make_train_step("pmg", _jax_spec("pmg"), jopt, dropout_rate=0.0)
    for i in range(4):  # one update, then one mini-step accumulated
        jstate, _ = jstep(jstate, *_batch(20 + i))
    state = tck.train_state_from_jax(jstate, spec, ttrain.make_optimizer(accum_steps=3))
    tree = state.opt_state.tree()
    adam = jstate.opt_state.inner_opt_state[0]
    assert float(tree["count"]) == int(adam.count) == 1 and int(tree["mini_step"]) == 1
    for name, jt in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu), ("acc", jstate.opt_state.acc_grads)):
        want = ttrain.leaf_dict(tck.params_from_jax(jax.device_get(jt), spec))
        for p, v in tree[name].items():
            np.testing.assert_array_equal(v.numpy(), want[p].numpy())
    assert state.step == 4
    with pytest.raises(ValueError, match="MultiSteps"):
        tck.train_state_from_jax(jstate, spec, ttrain.make_optimizer())


# ---------------------------------------------------------------------------
# bf16 on the CPU, and the random parts
# ---------------------------------------------------------------------------


def test_bf16_step_on_cpu():
    """compute_dtype=bf16 (which the JAX package cannot execute on the CPU):
    master params, running statistics and optimizer state stay float32, the
    loss falls over 8 steps, and the first step's loss is within 2e-2 of
    the float32 step's."""
    spec, params = _port_init("pmg")
    x, y = _batch(30)
    losses = {}
    for label, cdt in (("float32", None), ("bf16", torch.bfloat16)):
        _, step = ttrain.make_train_step("pmg", spec, dropout_rate=0.0, compute_dtype=cdt, device="cpu")
        tp = ttrain.trainable_params(params, "cpu")
        state = ttrain.TrainState(tp, ttrain.make_optimizer().init(tp), 0)
        losses[label] = []
        for _ in range(8 if cdt else 1):
            state, loss = step(state, x, y)
            losses[label].append(float(loss))
    ost = state.opt_state
    assert all(t.dtype == torch.float32 for t in ttrain.leaf_dict(state.params).values())
    assert all(v.dtype == torch.float32 for k in ("exp_avg", "exp_avg_sq")
               for v in ost.tree()[k].values())
    assert all(t.grad.dtype == torch.float32 for t in ost.leaves)
    assert losses["bf16"][-1] < losses["bf16"][0]
    assert abs(losses["bf16"][0] - losses["float32"][0]) <= 2e-2 * losses["float32"][0]


def test_augment_batch_properties():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(6, 16, 16, 3).astype(np.float32))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    assert torch.equal(augment_batch(gen(7), x), x)  # every knob off: identity
    a1 = augment_batch(gen(7), x, **DEFAULT_AUGMENT)
    assert torch.equal(a1, augment_batch(gen(7), x, **DEFAULT_AUGMENT))  # deterministic
    assert not torch.equal(a1, augment_batch(gen(8), x, **DEFAULT_AUGMENT))
    f = augment_batch(gen(7), x, flip=True)
    same = [torch.equal(f[i], x[i]) for i in range(6)]
    assert all(s or torch.equal(f[i], x[i].flip(1)) for i, s in enumerate(same))
    assert any(same) and not all(same)
    t = augment_batch(gen(7), x, translate=3)
    padded = np.pad(x.numpy(), ((0, 0), (3, 3), (3, 3), (0, 0)), mode="edge")
    for i in range(6):
        assert any(np.array_equal(t[i].numpy(), padded[i, oy: oy + 16, ox: ox + 16])
                   for oy in range(7) for ox in range(7)), i
    c = augment_batch(gen(7), x, contrast=0.2)
    np.testing.assert_allclose(c.mean(dim=(1, 2, 3)).numpy(), x.mean(dim=(1, 2, 3)).numpy(), atol=1e-6)
    ratio = (c - c.mean(dim=(1, 2, 3), keepdim=True)) / (x - x.mean(dim=(1, 2, 3), keepdim=True))
    assert float(ratio.min()) >= 0.8 - 1e-4 and float(ratio.max()) <= 1.2 + 1e-4
    b = augment_batch(gen(7), x, brightness=0.2) - x
    assert float(b.abs().max()) <= 0.2 + 1e-6 and not torch.equal(b, torch.zeros_like(b))
    assert torch.allclose(b, b[:, :1, :1, :1].expand_as(b), atol=1e-6)  # one offset per image
    # the train step: a seeded, step-keyed augmentation; {} is the default
    # recipe and a non-dict truthy value a TypeError
    spec, _ = _port_init("pmg")
    with pytest.raises(TypeError, match="augment must be"):
        ttrain.make_train_step("pmg", spec, augment=1, device="cpu")
    init, step = ttrain.make_train_step("pmg", spec, bn_train=False, dropout_rate=0.0, augment={},
                                        device="cpu")
    _, plain = ttrain.make_train_step("pmg", spec, bn_train=False, dropout_rate=0.0, device="cpu")
    xb, yb = _batch(31)
    snap = ttrain.snapshot(init(0).params)

    def fresh(step_no=0):
        tp = ttrain.trainable_params(snap, "cpu")
        return ttrain.TrainState(tp, ttrain.make_optimizer().init(tp), step_no)

    la, lb, lp, l1 = (float(fn(fresh(n), xb, yb)[1]) for fn, n in ((step, 0), (step, 0), (plain, 0),
                                                                    (step, 1)))
    assert la == lb  # the same step: the same draws
    assert lp != la and l1 != la  # it perturbs the inputs, and another step draws anew


def test_dropout_properties():
    x = torch.ones(200, 500)
    assert tattn.dropout(x, 0.1, None) is x and tattn.dropout(x, 0.0, torch.Generator()) is x
    y = tattn.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(y, tattn.dropout(x, 0.25, torch.Generator().manual_seed(0)))
    # PMG's apply_train: no generator or rate 0 is the eval forward; two
    # generators draw different masks
    spec, params = _port_init("pmg", {**TINY, "norm": "instance"})
    xb = torch.from_numpy(_batch(32, n=4)[0])
    ev, _ = tpmg.apply(params, xb, spec)
    for gen, rate in ((None, 0.1), (torch.Generator().manual_seed(1), 0.0)):
        got, _ = tpmg.apply_train(params, xb, spec, generator=gen, dropout_rate=rate)
        torch.testing.assert_close(got, ev, atol=1e-5, rtol=1e-5)
    a, _ = tpmg.apply_train(params, xb, spec, generator=torch.Generator().manual_seed(1))
    b, _ = tpmg.apply_train(params, xb, spec, generator=torch.Generator().manual_seed(2))
    assert not torch.allclose(a, b)


# ---------------------------------------------------------------------------
# Checkpoints of a train state, the step's guards, and fit
# ---------------------------------------------------------------------------


def test_native_train_state_roundtrip(tmp_path):
    spec, _ = _port_init("pmg")
    init, step = ttrain.make_train_step("pmg", spec, ttrain.make_optimizer(accum_steps=2),
                                        dropout_rate=0.0, device="cpu")
    state = init(0)
    for i in range(3):
        state, _ = step(state, *_batch(40 + i))
    tck.save_native(state, str(tmp_path / "s"))
    back = tck.load_native(str(tmp_path / "s"), like=init(1))
    assert back.step == 3 and back.opt_state.mini_step == 1
    for a, b in ((ttrain.leaf_dict(state.params), ttrain.leaf_dict(back.params)),
                 (ttrain.leaf_dict(state.opt_state.tree()), ttrain.leaf_dict(back.opt_state.tree()))):
        assert set(a) == set(b) and all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
    assert all(t.requires_grad for t in back.opt_state.leaves)
    # the same steps from each state give the same params
    s1, _ = step(state, *_batch(50))
    s2, _ = step(back, *_batch(50))
    assert all(torch.equal(a, b) for a, b in zip(s1.opt_state.leaves, s2.opt_state.leaves))
    with pytest.raises(ValueError, match="holds train_state"):
        tck.load_native(str(tmp_path / "s"), like=state.params)
    with pytest.raises(ValueError, match="does not match"):
        tck.load_native(str(tmp_path / "s"), like=ttrain.make_train_step(
            "pmg", tpmg.build_spec(TASKS, {**TINY, "d_model": 48}), device="cpu")[0](0))


def test_train_step_guards(monkeypatch):
    spec, _ = _port_init("pmg")
    with pytest.raises(TypeError, match="make_mesh"):
        ttrain.make_train_step("pmg", spec, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.make_train_step("pmg", spec)  # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fit("pmg", spec, "unused.json", TASKS, "unused")


def test_cached_train_step_reuses_the_step():
    spec, _ = _port_init("pmg")
    a = ttrain.cached_train_step("pmg", spec, dropout_rate=0.0, device="cpu")
    assert ttrain.cached_train_step("pmg", spec, dropout_rate=0.0, device="cpu") is a
    assert ttrain.cached_train_step("pmg", spec, dropout_rate=0.5, device="cpu")[2] is not a[2]
    cw = np.ones((2, 3), np.float32)
    e = ttrain.cached_train_step("pmg", spec, class_weights=cw, device="cpu")
    assert ttrain.cached_train_step("pmg", spec, class_weights=cw.copy(), device="cpu") is e
    assert ttrain.cached_train_step("pmg", spec, class_weights=cw * 2, device="cpu") is not e
    assert len(ttrain._STEP_CACHE) <= ttrain._STEP_CACHE_MAX


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = make_synth(str(tmp_path_factory.mktemp("train") / "synth"), n_per_class=3, size=64)
    with open(os.path.join(root, "tasks.json")) as f:
        tasks = json.load(f)
    return root, tpmg.build_spec(tasks, TINY)


def _fit(synth, out, **opts):
    root, spec = synth
    return port_fit("pmg", spec, os.path.join(root, "dataset.json"), os.path.join(root, "tasks.json"),
                    str(out), {"batch_size": 4, "val_split": 0.25, "num_workers": 2, **opts},
                    device="cpu")


def test_fit_writes_the_jax_artifacts(synth, tmp_path):
    """fit writes the JAX package's artifacts with its keys; the .pth loads
    back through the converter; the loss falls."""
    from wadt.models import pmg as jpmg
    from wadt.workloads.train import DEFAULT_OPTIONS, _spec_hparams

    out = _fit(synth, tmp_path / "run", epochs=3, lr=3e-3, balance_loss=True, use_focal=True,
               bf16=True)
    files = set(os.listdir(tmp_path / "run"))
    assert {"best_model", "best_model.pth", "hyperparameters.json", "training_history.json",
            "last_state", "train_progress.json"} <= files
    side = json.load(open(tmp_path / "run" / "hyperparameters.json"))
    assert set(side) == {"model_path_best", "hparams", "train_options", "fitness_overall_f1"}
    assert set(side["train_options"]) == set(DEFAULT_OPTIONS)
    assert side["hparams"] == json.loads(json.dumps(_spec_hparams("pmg", jpmg.build_spec(
        json.load(open(os.path.join(synth[0], "tasks.json"))), TINY))))
    hist = json.load(open(tmp_path / "run" / "training_history.json"))
    assert [set(h) for h in hist] == [{"epoch", "train_loss", "val_overall_f1", "seconds"}] * 3
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    params = tck.load_torch_checkpoint("pmg", str(tmp_path / "run" / "best_model.pth"), synth[1])
    best = ttrain.leaf_dict(out["params"])
    assert all(torch.equal(v, best[k]) for k, v in ttrain.leaf_dict(params).items())
    native = tck.load_native(out["ckpt_dir"], like=out["params"])
    assert all(torch.equal(v, best[k]) for k, v in ttrain.leaf_dict(native).items())


def test_fit_resume_matches_straight_run(synth, tmp_path):
    """1 epoch, then a resume to 3, equals a straight 3-epoch run: loss
    rtol 1e-5 and params within 1e-6 (bit for bit on the CPU), with dropout
    and augmentation on (drawn from (seed, step))."""
    opts = dict(epochs=3, dropout_rate=0.1, augment=True, seed=3, accum_steps=2)
    a = _fit(synth, tmp_path / "a", **opts)
    _fit(synth, tmp_path / "b", **{**opts, "epochs": 1})
    b = _fit(synth, tmp_path / "b", **{**opts, "resume": True})
    assert [h["epoch"] for h in b["history"]] == [0, 1, 2]
    np.testing.assert_allclose([h["train_loss"] for h in a["history"]],
                               [h["train_loss"] for h in b["history"]], rtol=1e-5)
    pa, pb = ttrain.leaf_dict(a["params"]), ttrain.leaf_dict(b["params"])
    for k in pa:
        np.testing.assert_allclose(pa[k].numpy(), pb[k].numpy(), atol=1e-6)
