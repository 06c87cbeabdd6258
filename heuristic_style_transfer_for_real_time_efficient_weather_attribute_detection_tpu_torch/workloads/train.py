"""Training loop (``fit``) on the reference's recorded training recipe.

Counterpart of the JAX package's ``workloads/train.py``: AdamW lr/weight
decay, batch size, epochs, gradient accumulation, class-weight balancing
(median mode, cap), focal loss, validation split, encoder freezing, train
-mode batch norm and dropout, bf16 mixed precision and augmentation on the
device, best-model selection by validation overall F1, and resume from the
last full train state.  It writes the JAX package's artifacts:
``best_model/`` (the port's native format), ``best_model.pth`` (the
reference's key schema), ``hyperparameters.json`` and
``training_history.json`` with the same keys, and, every ``save_every``
epochs, ``last_state/`` (params, optimizer state and step) and
``train_progress.json``.

Frames cross to the device as uint8 and are normalized there with the
host normalize's affine (the JAX package normalizes on the host).  It runs
on the CUDA card unless ``device="cpu"``, and over a ``parallel.mesh.Mesh``
(one process per device) where ``mesh`` is given.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import IGNORE_INDEX
from ..data.dataset import BatchLoader, MultiTaskDataset
from ..engine import checkpoint
from ..engine.executor import Engine
from ..models import get_family
from ..ops.preprocess import normalize_uint8
from ..parallel.multihost import host_local_batch
from ..parallel.train import (
    TrainState,
    cached_train_step,
    compute_class_weights,
    gather_params,
    gather_state,
    shard_params,
    shard_state,
    snapshot,
    train_device,
    trainable_params,
)
from ..utils.metrics import precision_recall_fscore

DEFAULT_OPTIONS: Dict[str, Any] = {
    "epochs": 10,
    "batch_size": 32,
    "lr": 3e-4,
    "weight_decay": 1e-4,
    "accum_steps": 1,
    "balance_loss": False,
    "use_focal": False,
    "focal_gamma": 2.0,
    "class_weight_mode": "median",
    "class_weight_cap": 10.0,
    "val_split": 0.2,
    "freeze_encoder": False,
    "seed": 0,
    "shuffle_each_epoch": True,
    "num_workers": 4,
    # the reference transformer trains with dropout 0.1; 0.0 is deterministic
    "dropout_rate": 0.1,
    # resume: the full TrainState (params, optimizer moments, step) is
    # saved every save_every epochs; resume=True continues from it
    "save_every": 1,
    "resume": False,
    # None = auto: decoded images cached in host memory when they fit the
    # budget, else decoded per batch every epoch
    "cache_in_memory": None,
    "cache_budget_bytes": 4 << 30,
    # bf16 forward/backward against float32 master weights
    "bf16": False,
    # augmentation on the device (True = ops.augment.DEFAULT_AUGMENT, or a
    # kwargs dict), drawn from (seed, step): resume replays it
    "augment": False,
}

# Validation engines shared across repeat fits with the same (family, spec,
# eval batch, device); the params are swapped per epoch.  fit() is a
# sequential API: the cache is not for concurrent fits.
_EVAL_ENGINE_CACHE: Dict[Any, Engine] = {}


def _val_overall_f1(engine: Engine, images, labels) -> float:
    """Mean over tasks with labels of the weighted F1 of the engine's preds."""
    res = engine.run(images, labels, collect=("preds",))
    f1s = []
    for ti in range(len(engine.tasks)):
        m = labels[:, ti] != IGNORE_INDEX
        if m.any():
            f1s.append(precision_recall_fscore(labels[m, ti], res["preds"][m, ti],
                                               average="weighted")[2])
    return float(np.mean(f1s)) if f1s else 0.0


def fit(
    family: str,
    spec,
    data_json: str,
    classes_json,
    save_dir: str,
    options: Optional[Dict[str, Any]] = None,
    init_params=None,
    mesh=None,
    device="cuda",
) -> Dict[str, Any]:
    """Train a model; returns {"params", "history", "best_f1", "ckpt_dir"}
    (the best params as CPU tensors).

    Artifacts under ``save_dir``: best_model/ (native), best_model.pth
    (reference-loadable), hyperparameters.json (reference sidecar schema),
    training_history.json; last_state/ and train_progress.json for resume.
    ``init_params`` (copied, never modified) replaces the seeded random init.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank calls ``fit`` alike)
    runs the sharded train step (``parallel.train.make_train_step``): each
    rank feeds its own rows of every batch (``batch_size`` must divide by
    the 'data' size) and holds its tasks' slice of the task-stacked
    leaves.  The per-epoch validation engine runs on the mesh too.  Rank 0
    writes every file, from the state gathered over the mesh; a resume
    loads the whole state and takes each rank's part.  Every rank returns
    the same result: the gathered best params, the global losses and F1s,
    and each epoch's seconds as the slowest rank's.
    """
    opts = {**DEFAULT_OPTIONS, **(options or {})}
    get_family(family)  # fail fast on an unknown family
    dev = train_device(device)
    os.makedirs(save_dir, exist_ok=True)

    ds = MultiTaskDataset(data_json, classes_json)
    n = len(ds)
    perm = np.random.RandomState(opts["seed"]).permutation(n)
    n_val = int(round(n * opts["val_split"]))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    if len(train_idx) == 0:
        raise ValueError("empty training split")

    img_bytes = ds.img_size * ds.img_size * 3
    cache = opts.get("cache_in_memory")
    if cache is None:
        cache = n * img_bytes <= opts.get("cache_budget_bytes", 4 << 30)
    all_labels = np.stack([lab for _, lab in ds.samples])
    cached_imgs = None
    decode_pool = None
    if cache:
        loader = BatchLoader(ds, batch_size=opts["batch_size"], num_workers=opts["num_workers"])
        cached_imgs = np.concatenate([imgs for imgs, _, _ in loader])
    else:
        from concurrent.futures import ThreadPoolExecutor

        decode_pool = ThreadPoolExecutor(max_workers=opts["num_workers"])
        # the resident validation set respects the memory budget too
        max_eval = max(1, opts["cache_budget_bytes"] // (4 * img_bytes))
        if n_val > max_eval:
            print(f"[fit] capping resident validation set {n_val} -> {max_eval} "
                  f"(streaming mode memory budget)")
            val_idx = val_idx[:max_eval]
            n_val = max_eval

    def fetch(idx: np.ndarray) -> np.ndarray:
        if cached_imgs is not None:
            return cached_imgs[idx]
        return np.stack(list(decode_pool.map(lambda i: ds.load(int(i))[0], idx)))

    def fetch_async(idx: np.ndarray):
        """Overlap the next batch's decode with the current step."""
        if cached_imgs is not None:
            return lambda: cached_imgs[idx]
        futs = [decode_pool.submit(lambda i=i: ds.load(int(i))[0]) for i in idx]
        return lambda: np.stack([f.result() for f in futs])

    class_weights = None
    if opts["balance_loss"]:
        class_weights = compute_class_weights(
            all_labels[train_idx], spec.tasks.num_classes,
            mode=opts["class_weight_mode"], cap=opts["class_weight_cap"],
        )

    optimizer, init_fn, step_fn = cached_train_step(
        family, spec, mesh=mesh,
        lr=opts["lr"], weight_decay=opts["weight_decay"], accum_steps=opts["accum_steps"],
        use_focal=opts["use_focal"], focal_gamma=opts["focal_gamma"],
        class_weights=class_weights, freeze_encoder=opts["freeze_encoder"],
        dropout_rate=opts["dropout_rate"], dropout_seed=opts["seed"] + 1234,
        compute_dtype=(torch.bfloat16 if opts["bf16"] else None),
        augment=opts["augment"], device=dev,
    )
    if init_params is None:
        state = init_fn(opts["seed"])
    else:
        params = trainable_params(shard_params(init_params, mesh), dev)
        state = TrainState(params, optimizer.init(params), 0)
    main = mesh is None or mesh.is_main  # the rank that writes

    bs = opts["batch_size"]
    rows = slice(*mesh.row_range(bs)) if mesh is not None else slice(None)
    history = []
    best_f1, best_params = -1.0, snapshot(gather_params(state.params, mesh))
    start_epoch = 0
    last_dir = os.path.join(save_dir, "last_state")
    best_dir = os.path.join(save_dir, "best_model")
    progress_path = os.path.join(save_dir, "train_progress.json")
    if opts["resume"] and os.path.exists(progress_path):
        with open(progress_path) as f:
            progress = json.load(f)
        state = shard_state(checkpoint.load_native(last_dir, like=gather_state(state, mesh)),
                            mesh)
        start_epoch = int(progress["next_epoch"])
        history = progress["history"]
        best_f1 = float(progress["best_f1"])
        if os.path.exists(best_dir):
            best_params = checkpoint.load_native(best_dir, like=best_params)
        print(f"[fit] resumed from epoch {start_epoch} (step {state.step}, best_f1 {best_f1:.4f})")

    eval_idx = val_idx if n_val else train_idx[: min(64, len(train_idx))]
    val_imgs, val_labels = fetch(eval_idx), all_labels[eval_idx]
    # one eval engine for all epochs and across repeat fits of the same
    # configuration; each epoch hands it a detached copy of the params
    try:
        eng_key = (family, spec, min(bs, 64), str(dev), None if mesh is None else id(mesh))
        hash(eng_key)
    except TypeError:  # unhashable custom spec: no caching
        eng_key = None
    eval_engine = _EVAL_ENGINE_CACHE.get(eng_key) if eng_key is not None else None
    if eval_engine is None:
        eval_engine = Engine(family, spec, snapshot(gather_params(state.params, mesh), dev),
                             batch_size=min(bs, 64), prob_threshold=0.0, mesh=mesh, device=dev)
        if eng_key is not None:
            if len(_EVAL_ENGINE_CACHE) >= 8:
                _EVAL_ENGINE_CACHE.pop(next(iter(_EVAL_ENGINE_CACHE)))
            _EVAL_ENGINE_CACHE[eng_key] = eval_engine

    for epoch in range(start_epoch, opts["epochs"]):
        # per-epoch seeded order: the same schedule across resumes
        epoch_rng = np.random.RandomState(opts["seed"] * 100003 + 17 + epoch)
        order = epoch_rng.permutation(train_idx) if opts["shuffle_each_epoch"] else train_idx
        if len(order) < bs:
            order = np.resize(order, bs)  # tile small datasets to one batch
        losses = []
        t0 = time.perf_counter()
        starts = list(range(0, len(order) - bs + 1, bs))
        pending = fetch_async(order[starts[0]: starts[0] + bs]) if starts else None
        for si, s in enumerate(starts):
            idx = order[s: s + bs]
            images = normalize_uint8(torch.from_numpy(pending()[rows]).to(dev))
            if si + 1 < len(starts):  # decode the next batch during this step
                nxt = starts[si + 1]
                pending = fetch_async(order[nxt: nxt + bs])
            labels = all_labels[idx][rows]
            if mesh is not None:  # this rank's rows of the global batch
                images, labels = host_local_batch(mesh, images, labels)
            state, loss = step_fn(state, images, labels)
            losses.append(float(loss))

        eval_engine.params = snapshot(gather_params(state.params, mesh), dev)
        val_f1 = _val_overall_f1(eval_engine, val_imgs, val_labels)
        seconds = time.perf_counter() - t0
        if mesh is not None:
            seconds = float(mesh.all_reduce(torch.tensor(seconds, device=dev), op="max"))
        entry = {
            "epoch": epoch,
            "train_loss": float(np.mean(losses)),
            "val_overall_f1": val_f1,
            "seconds": round(seconds, 3),
        }
        history.append(entry)
        print(f"[epoch {epoch}] loss={entry['train_loss']:.4f} val_f1={val_f1:.4f} "
              f"({entry['seconds']}s)")
        if val_f1 >= best_f1:
            best_f1, best_params = val_f1, snapshot(gather_params(state.params, mesh))
            if main:
                checkpoint.save_native(best_params, best_dir)
        if opts["save_every"] and (epoch + 1) % opts["save_every"] == 0:
            # the full TrainState: resuming reproduces the run, not a warm restart
            full = gather_state(state, mesh)
            if main:
                checkpoint.save_native(full, last_dir)
                with open(progress_path, "w") as f:
                    json.dump({"next_epoch": epoch + 1, "history": history, "best_f1": best_f1},
                              f, indent=2)

    if decode_pool is not None:
        decode_pool.shutdown()
    result = {"params": best_params, "history": history, "best_f1": best_f1,
              "ckpt_dir": best_dir}
    if not main:
        mesh.barrier()  # rank 0 has written everything
        return result
    checkpoint.save_native(best_params, best_dir)
    pth_path = os.path.join(save_dir, "best_model.pth")
    checkpoint.save_torch_checkpoint(family, best_params, spec, pth_path)
    sidecar = {
        "model_path_best": pth_path,
        "hparams": _spec_hparams(family, spec),
        "train_options": {k: opts[k] for k in DEFAULT_OPTIONS},
        "fitness_overall_f1": best_f1,
    }
    with open(os.path.join(save_dir, "hyperparameters.json"), "w") as f:
        json.dump(sidecar, f, indent=2)
    with open(os.path.join(save_dir, "training_history.json"), "w") as f:
        json.dump(history, f, indent=2)
    if mesh is not None:
        mesh.barrier()
    return result


def _spec_hparams(family: str, spec) -> Dict[str, Any]:
    """Spec -> the reference's sidecar hparams schema."""
    if family == "pmg":
        return {
            "ndf": spec.ndf, "norm": spec.norm, "patch_size": spec.patch_size,
            "patch_div": spec.patch_div, "gram_channels": spec.gram_channels,
            "d_model": spec.d_model,
            "transformer_layers": spec.transformer_layers,
            "transformer_heads": spec.transformer_heads,
            "use_token_attention": spec.use_token_attention,
            "use_channel_attention": spec.use_channel_attention,
            "num_classes_per_task": {
                t: k for t, k in zip(spec.tasks.names, spec.tasks.num_classes)
            },
        }
    if family == "pm":
        return {
            "ndf": spec.ndf, "norm": spec.norm, "patch_size": spec.patch_size,
            "attn_tau": spec.attn_tau, "attn_use_se": spec.attn_use_se,
            "attn_softmax_spatial": spec.attn_softmax_spatial,
            "ablate_attention": spec.ablate_attention,
        }
    return {
        "truncate_layer": spec.truncate_after_layer,
        "use_attention": spec.use_attention,
        "attn_token_dim": spec.attn_token_dim,
        "cls_hidden_dims": list(spec.cls_hidden_dims),
        "cls_num_layers": spec.cls_num_layers,
    }
