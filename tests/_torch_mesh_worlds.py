"""What each rank runs in ``tests/test_torch_parallel.py``'s process worlds.

Each world (2 ranks on a ``("data",)`` mesh, 4 ranks on a
``("data", "model")`` mesh of shape (2, 2)) is spawned once per test
module over gloo on the CPU, runs every scenario below, and returns numpy
results that the tests hold against the port's unsharded step, the
single-process engine and the JAX package.  This module imports no JAX:
the spawned ranks import it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    IGNORE_INDEX,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    Engine,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
    pm,
    pmg,
    rtm,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
    train as ttrain,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel.mesh import (
    make_mesh,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel.multihost import (
    host_local_batch,
)

TINY = dict(ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
            transformer_layers=1, transformer_heads=2, norm="batch")
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
CW = np.array([[1.0, 2.0, 0.5], [0.3, 1.5, 0.0]], np.float32)
STEPS = 3
BATCH = 8
MESHES = {"data2": (2, ("data",), (2,)), "mesh22": (4, ("data", "model"), (2, 2))}

# (family, make_train_step kwargs) of each sharded-vs-unsharded case
TRAIN_CASES = {
    "f32": ("pmg", dict(dropout_rate=0.0)),
    "augment_dropout": ("pmg", dict(dropout_rate=0.1, augment={"translate": 2})),
    "bf16": ("pmg", dict(compute_dtype=torch.bfloat16)),
    "weights_focal": ("pmg", dict(dropout_rate=0.0, class_weights=CW, use_focal=True)),
    "pm": ("pm", {}),
    "rtm": ("rtm", {}),
}
FAMILY_HP = {
    "pmg": (pmg, TINY),
    "pm": (pm, dict(ndf=8, patch_size=16, norm="batch")),
    "rtm": (rtm, dict(truncate_layer=5, attn_token_dim=16)),  # the stem and layer1
}


def spec_params(family: str = "pmg", seed: int = 0):
    """(spec, seeded full params); an RTM tree keeps only the backbone
    stages its truncation runs."""
    mod, hp = FAMILY_HP[family]
    spec = mod.build_spec(TASKS, hp)
    params = mod.init(torch.Generator().manual_seed(seed), spec)
    if family == "rtm":
        for stage in ("layer2", "layer3", "layer4"):
            del params["backbone"][stage]
    return spec, params


def batch(seed: int, n: int = BATCH):
    """A global batch; the first sample misses task A's label, so missing
    labels fall unevenly over the data ranks."""
    rng = np.random.RandomState(seed)
    images = rng.randn(n, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 2, (n, 2)).astype(np.int32)
    labels[0, 0] = IGNORE_INDEX
    return images, labels


def tree_np(tree):
    return ttrain._map_tree(lambda _, t: t.detach().cpu().numpy().copy(), tree)


def tree_torch(tree):
    return ttrain._map_tree(lambda _, a: torch.from_numpy(np.array(a)), tree)


def state_np(state, mesh=None):
    """A train state as numpy, whole (gathered over the mesh): params, the
    optimizer's tree and each leaf's last gradient (none before a step)."""
    ost = state.opt_state
    grads = {p: t.grad for p, t in zip(ost.paths, ost.leaves) if t.grad is not None}
    grads = ttrain._map_opt_tree(lambda t: mesh.gather(t, "model"), {"acc": grads}, mesh)["acc"]
    state = ttrain.gather_state(state, mesh)
    opt = state.opt_state.tree()
    return {"params": tree_np(state.params),
            "opt": {k: (tree_np(v) if isinstance(v, dict) else float(v)) for k, v in opt.items()},
            "grads": {p: g.numpy().copy() for p, g in grads.items()},
            "step": state.step}


def state_from_np(tree, optimizer, mesh=None):
    """This rank's part of a train state given as :func:`state_np` (the
    whole state)."""
    params = ttrain.trainable_params(tree_torch(tree["params"]), "cpu")
    opt = optimizer.init(params)
    opt.load_tree({k: (tree_torch(v) if isinstance(v, dict) else v)
                   for k, v in tree["opt"].items()})
    return ttrain.shard_state(ttrain.TrainState(params, opt, tree["step"]), mesh)


def fresh_state(params, optimizer, mesh=None):
    p = ttrain.trainable_params(ttrain.shard_params(params, mesh), "cpu")
    return ttrain.TrainState(p, optimizer.init(p), 0)


def _case_step(case: str, mesh=None):
    family, kw = TRAIN_CASES[case]
    spec, params = spec_params(family)
    opt = ttrain.make_optimizer()
    _, step = ttrain.make_train_step(family, spec, opt, mesh=mesh, device="cpu", **kw)
    return params, opt, step


def run_case(case: str, mesh=None, steps: int = STEPS):
    """``steps`` steps of a TRAIN_CASES case from the seeded init ->
    (losses, the whole state as numpy before each step and after the last)."""
    params, opt, step = _case_step(case, mesh)
    state = fresh_state(params, opt, mesh)
    losses, states = [], [state_np(state, mesh)]
    for i in range(steps):
        state, loss = step(state, *batch(10 + i))
        losses.append(float(loss))
        states.append(state_np(state, mesh))
    return losses, states


def steps_from(case: str, states, mesh=None):
    """One step of a case from each given whole state (the unsharded run's,
    so that rounding differences do not compound from step to step) ->
    [(loss, the whole state after it)]."""
    _, opt, step = _case_step(case, mesh)
    out = []
    for i, tree in enumerate(states):
        state, loss = step(state_from_np(tree, opt, mesh), *batch(10 + i))
        out.append((float(loss), state_np(state, mesh)))
    return out


def _world(rank: int, name: str, synth_root, jax_states, ref_states):
    world, axes, shape = MESHES[name]
    mesh = make_mesh(axes=axes, shape=shape)
    out = {"rank": rank, "coords": mesh.coords}

    # the sharded step against the unsharded one, every case: step by step
    # from the unsharded run's states, and 3 steps running free
    out["train"] = {c: steps_from(c, ref_states[c], mesh) for c in TRAIN_CASES}
    out["free"] = {c: run_case(c, mesh)[0] for c in TRAIN_CASES}

    # 8 steps on one batch: the loss falls; the task leaves are this rank's slices
    spec, params = spec_params()
    opt = ttrain.make_optimizer()
    _, step = ttrain.make_train_step("pmg", spec, opt, mesh=mesh, device="cpu")
    state = fresh_state(params, opt, mesh)
    images, labels = batch(0, 16)
    losses = []
    for _ in range(8):
        state, loss = step(state, images, labels)
        losses.append(float(loss))
    out["decrease"] = {"losses": losses, "step": state.step,
                       "local_shapes": {p: tuple(t.shape) for p, t in
                                        ttrain.leaf_dict(state.params).items()},
                       "moment_shapes": {p: tuple(t.shape) for p, t in
                                         state.opt_state.tree()["exp_avg"].items()}}
    # bf16: master params and optimizer state stay float32
    _, step16 = ttrain.make_train_step("pmg", spec, opt, mesh=mesh, device="cpu",
                                       compute_dtype=torch.bfloat16)
    state = fresh_state(params, opt, mesh)
    state, _ = step16(state, *batch(3))
    out["bf16_dtypes"] = sorted({str(t.dtype) for t in ttrain.leaf_dict(state.params).values()}
                                | {str(t.dtype) for k in ("exp_avg", "exp_avg_sq")
                                   for t in state.opt_state.tree()[k].values()})

    # one step from each of the JAX package's states, carried across
    if jax_states is not None:
        res = []
        _, step0 = ttrain.make_train_step("pmg", spec, opt, mesh=mesh, device="cpu",
                                          dropout_rate=0.0)
        for i, tree in enumerate(jax_states):
            state, loss = step0(state_from_np(tree, opt, mesh), *batch(20 + i))
            res.append((float(loss), state_np(state, mesh)))
        out["jax"] = res

    # the same step through host_local_batch: each rank hands over its rows only
    _, stepf = ttrain.make_train_step("pmg", spec, opt, mesh=mesh, device="cpu", dropout_rate=0.0)
    a, b = fresh_state(params, opt, mesh), fresh_state(params, opt, mesh)
    images, labels = batch(5)
    lo, hi = mesh.row_range(len(images))
    _, la = stepf(a, images, labels)
    _, lb = stepf(b, *host_local_batch(mesh, images[lo:hi], labels[lo:hi]))
    out["host_local"] = (float(la), float(lb), all(
        torch.equal(x, y) for x, y in zip(ttrain.leaf_dict(a.params).values(),
                                          ttrain.leaf_dict(b.params).values())))

    # uneven task split: 3 tasks over a 'model' axis of 2
    if mesh.axis_size("model") > 1:
        try:
            ttrain.make_train_step("pmg", pmg.build_spec(
                {**TASKS, "C": ["c0", "c1"]}, TINY), mesh=mesh, device="cpu")
            out["uneven"] = None
        except ValueError as e:
            out["uneven"] = str(e)

    # the engine over the mesh
    if mesh.axis_size("model") == 1:
        eng = Engine("pmg", spec, params, batch_size=16, mesh=mesh, device="cpu")
        rng = np.random.RandomState(1)
        imgs = rng.randint(0, 256, (37, 32, 32, 3), np.uint8)
        labs = batch(6, 37)[1]
        per = eng.run(imgs, labs, collect=("logits", "preds"))
        scan = eng.run(imgs[:32], collect=("logits",), scan_chunk=2)["logits"]
        stream, _ = eng.run_stream([(imgs[i: i + 16], None) for i in (0, 16)]
                                   + [(imgs[32:], None)], collect=("logits",), scan_chunk=2)
        out["engine"] = {"per_batch": per, "scan_chunk": scan, "run_stream": stream["logits"]}

    # fit over the mesh: a resume equals the straight run
    if synth_root is not None:
        from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads.train import (
            fit,
        )

        tspec = pmg.build_spec(json.load(open(os.path.join(
            synth_root, "tasks.json"))), TINY)
        opts = dict(batch_size=4, val_split=0.25, num_workers=1, dropout_rate=0.1, augment=True,
                    seed=3)
        run_dir = os.path.join(synth_root, "fit_" + name)
        args = (os.path.join(synth_root, "dataset.json"), os.path.join(synth_root, "tasks.json"))
        a = fit("pmg", tspec, *args, run_dir + "_a", {**opts, "epochs": 3}, mesh=mesh,
                device="cpu")
        fit("pmg", tspec, *args, run_dir + "_b", {**opts, "epochs": 1}, mesh=mesh, device="cpu")
        b = fit("pmg", tspec, *args, run_dir + "_b", {**opts, "epochs": 3, "resume": True},
                mesh=mesh, device="cpu")
        out["fit"] = {k: {"history": [(h["epoch"], h["train_loss"], h["val_overall_f1"])
                                      for h in r["history"]],
                          "best_f1": r["best_f1"], "params": tree_np(r["params"])}
                      for k, r in (("straight", a), ("resumed", b))}
        out["fit_files"] = sorted(os.listdir(run_dir + "_b"))

    # the CLI as torchrun starts it on each rank (last: it sets the environment)
    if synth_root is not None:
        out["cli"] = cli_inference(rank, mesh.size, synth_root)
    return out


def cli_args(synth_root: str, save_dir: str) -> list:
    """``weather-torch pmg --mode inference`` at TINY on the synthetic
    images, annotated copies saved."""
    hp = os.path.join(synth_root, "tiny_hparams.json")
    if not os.path.exists(hp):
        with open(hp + f".{os.getpid()}", "w") as f:
            json.dump({"hparams": TINY}, f)
        os.replace(hp + f".{os.getpid()}", hp)
    return ["pmg", "--mode", "inference", "--image_folder", os.path.join(synth_root, "images"),
            "--build_classifier", os.path.join(synth_root, "tasks.json"), "--config_path", hp,
            "--batch_size", "4", "--num_workers", "1", "--save_test_images",
            "--save_dir", save_dir, "--device", "cpu"]


def cli_inference(rank: int, world: int, synth_root: str) -> dict:
    """:func:`cli_args` with ``--data_parallel`` in this rank's environment
    as ``torchrun`` sets it (the process group is already up) -> the paths
    under ``--save_dir`` this rank opened for writing, once per opening (an
    audit hook sees every ``open``), and the results file as rank 0 left it."""
    import sys

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import (
        cli,
    )

    save_dir = os.path.join(synth_root, "cli_data_parallel")
    opened, watching = [], [True]

    def audit(event, args):
        if event != "open" or not watching[0] or not isinstance(args[0], str):
            return
        path, mode, flags = args
        writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                  else bool(flags & (os.O_WRONLY | os.O_RDWR)))
        if writes and os.path.abspath(path).startswith(save_dir + os.sep):
            opened.append(os.path.relpath(os.path.abspath(path), save_dir))

    sys.addaudithook(audit)  # a hook stays for the process's life: ``watching`` ends it
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    try:
        rc = cli.main(cli_args(synth_root, save_dir) + ["--data_parallel"])
    finally:
        watching[0] = False
    with open(os.path.join(save_dir, "inference_results.json")) as f:
        results = json.load(f)
    return {"rc": rc, "opened": opened, "results": results}
