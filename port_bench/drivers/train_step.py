"""Driver ``train_step``: fine-tuning through the port's train step, fed as
``workloads/train.fit``'s inner loop feeds it.

Set-up builds one train state from the configuration's weights
(``engine.checkpoint.convert``, then ``parallel.train.trainable_params`` and
the optimizer's state, as ``fit(init_params=...)`` does) and one step
(``parallel.train.cached_train_step`` with fit's arguments), and drives the
first ``checked_steps`` steps through the window's own call on the first
batches of the seeded order.  The window goes on with that same state.
Each step is fit's: the uint8 batch gathered from the host pool
(``pool[idx]``, a fresh copy), copied to the card from pageable memory,
``ops.preprocess.normalize_uint8``, ``step_fn``, ``float(loss)``.

The check runs the plain reference through the same checked steps from the
same weights on the same batches and compares each step's loss, each
leaf's first gradient (the program's worked out from AdamW's first moment
after one step) and each leaf's change after the checked steps.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import faults
from ..reference.common import AdamW, Precision, leaf_norm, masked_loss, normalize
from ..weights import state as load_state
from ..yardstick import PEAK_FLOP_PER_S, stream_seed, worst_leaf_gap

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
BETA1 = 0.9  # AdamW's first-moment decay in the recipe
GRAD_FLOOR = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
_STATS = ("running_mean", "running_var")
# the faults a train cell can have, planted under the timed path
FAULTS = {"state_unchanged": faults.state_unchanged, "half_batch": faults.half_batch_train,
          "loss_altered": faults.loss_altered}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def frames(n: int, side: int, seed: int, device) -> np.ndarray:
    """``n`` seeded uint8 frames [n, side, side, 3] drawn on ``device`` in
    one call, kept on the host."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "frames"))
    return torch.randint(0, 256, (n, side, side, 3), generator=g, dtype=torch.uint8,
                         device=device).cpu().numpy()


class Feed:
    """The traffic: a host pool of seeded frames, seeded labels (uniform
    over each task's classes, an ``ignore_share`` of (image, task) pairs
    -100), and a seeded order (a new permutation of the pool each epoch,
    its whole batches in turn, as fit's epochs go)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.batch = int(traffic["batch"])
        self.pool = frames(int(traffic["pool"]), cfg["img_size"], seed, device)
        rng = np.random.default_rng(stream_seed(seed, "labels"))
        y = np.stack([rng.integers(0, len(c), len(self.pool)) for c in cfg["tasks"].values()], 1)
        y[rng.random(y.shape) < float(traffic["ignore_share"])] = -100
        self.labels = y.astype(np.int64)
        self.rng = np.random.default_rng(stream_seed(seed, "order"))
        self.order: List[int] = []

    def next(self) -> np.ndarray:
        if len(self.order) < self.batch:
            perm = self.rng.permutation(len(self.pool))
            self.order = list(perm[: len(perm) - len(perm) % self.batch])
        idx, self.order = np.asarray(self.order[: self.batch]), self.order[self.batch:]
        return idx


class Run:
    def __init__(self, ctx):
        from importlib import import_module

        ckpt = import_module(f"{PORT}.engine.checkpoint")
        train = import_module(f"{PORT}.parallel.train")
        self.normalize_uint8 = import_module(f"{PORT}.ops.preprocess").normalize_uint8
        self.ctx, cfg, tr = ctx, ctx.cfg, ctx.traffic
        self.dev, self.batch = ctx.device, int(tr["batch"])
        if cfg.get("parity_precision"):
            import_module(f"{PORT}.config").enable_parity_precision()
        self.feed = Feed(cfg, tr, ctx.seed, self.dev)
        spec = ctx.family.port_spec(cfg)
        # drawn on the device the reference draws on: a CPU and a CUDA
        # generator give different weights for one seed
        sd = load_state(cfg, ctx.root, ctx.seed, self.dev)
        params = ckpt.convert(cfg["family"], {k: v.cpu().numpy() for k, v in sd.items()}, spec)
        del sd
        optimizer, _, self.step_fn = train.cached_train_step(
            cfg["family"], spec, lr=float(tr["lr"]), weight_decay=float(tr["weight_decay"]),
            accum_steps=1, use_focal=False, focal_gamma=2.0, class_weights=None,
            freeze_encoder=False, dropout_rate=float(tr["dropout_rate"]),
            dropout_seed=stream_seed(ctx.seed, "dropout") % (1 << 31),
            compute_dtype=_DTYPES[tr["dtype"]], augment=bool(tr["augment"]), device=self.dev)
        p = train.trainable_params(params, self.dev)
        self.state = train.TrainState(p, optimizer.init(p), 0)
        self.attempted = self.failed = 0
        self.detail: dict = {}
        # the checked steps, the program's readings kept as norms by leaf
        p0 = {k: t.detach().clone() for k, t in _leaves(self.state.params)}
        self.checked, self.losses = [], []
        for s in range(int(tr["checked_steps"])):
            idx = self.feed.next()
            self.checked.append(idx)
            self.losses.append(self._step(idx))
            if s == 0:
                m = self.state.opt_state.tree()["exp_avg"]
                self.grads = {k: float(v.double().norm()) / (1 - BETA1) for k, v in m.items()}
        self.changes = {k: float((t.detach() - p0[k]).double().norm())
                        for k, t in _leaves(self.state.params)}
        del p0
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _step(self, idx: np.ndarray) -> float:
        sp = self.ctx.spans
        with sp("upload"):
            images = self.normalize_uint8(torch.from_numpy(self.feed.pool[idx]).to(self.dev))
        with sp("step_fn"):
            self.state, loss = self.step_fn(self.state, images, self.feed.labels[idx])
        with sp("loss_read"):
            return float(loss)

    def _one(self) -> None:
        loss = self._step(self.feed.next())
        self.attempted += self.batch
        if not np.isfinite(loss):
            self.failed += self.batch

    def window(self, seconds: float) -> float:
        """Images of the steps completed in ``seconds``, over all the time."""
        steps, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._one()
            steps += 1
        return steps * self.batch / (time.perf_counter() - t0)

    def traced(self) -> Dict[str, int]:
        n = int(self.ctx.traffic["traced_steps"])
        for _ in range(n):
            self._one()
        return {"steps": n}

    def annotate(self, tr) -> None:
        cfg, dtype = self.ctx.cfg, self.ctx.traffic["dtype"]
        tr.flops = 3 * self.ctx.family.forward_flops(cfg, self.batch) * tr.items["steps"]
        tr.peak_flop_per_s = PEAK_FLOP_PER_S[dtype]
        bound = getattr(self.ctx.family, "patch_gram_bound", None)
        if bound is not None:
            tr.extra["patch_gram_bound_s"] = bound(cfg, self.batch, dtype)

    def check(self) -> Dict[str, float]:
        """Free the program's state, then the reference through the checked
        steps; returns the gaps by name."""
        del self.state
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference_steps(self.ctx, self.feed, self.checked, Precision())
        return gaps(self.ctx.family.leaf_map(self.ctx.cfg), self.losses, self.grads,
                    self.changes, *ref, worst=self.detail)


def reference_steps(ctx, feed: Feed, checked, prec: Precision):
    """The reference's steps on the checked batches from the configuration's
    weights: (losses, first gradient by reference key, change by key after
    the last step)."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    sd = load_state(cfg, ctx.root, ctx.seed, dev)
    sd0 = {k: v.clone() for k, v in sd.items()}
    trained = [k for k in sd if not k.endswith(_STATS)]
    for k in trained:
        sd[k].requires_grad_(True)
    opt = AdamW([sd[k] for k in trained], lr=float(tr["lr"]),
                weight_decay=float(tr["weight_decay"]))
    tasks, losses, grads = list(cfg["tasks"]), [], {}
    with prec.flags():
        for s, idx in enumerate(checked):
            x = normalize(torch.from_numpy(feed.pool[idx]).to(dev))
            y = torch.from_numpy(feed.labels[idx]).to(dev)
            loss = masked_loss(ctx.ref.forward(sd, x, cfg, prec, train=True), y, tasks)
            loss.backward()
            losses.append(float(loss.detach()))
            if s == 0:
                grads = {k: sd[k].grad.detach().clone() for k in trained}
            opt.step()
    return losses, grads, {k: sd[k].detach() - sd0[k] for k in sd}


def _parts(tensors, parts):
    return [tensors[k] if rows is None else tensors[k][rows[0]:rows[1]] for k, rows in parts]


def gaps(leaf_map, losses, grads, changes, ref_losses, ref_grads, ref_changes,
         worst=None) -> Dict[str, float]:
    """``loss_gap_first``: the first step's relative gap of the loss, and
    ``loss_gap_later`` the largest of the later checked steps' (AdamW
    turns round-off in the first gradient into whole steps of the learning
    rate, so later losses drift further apart);
    ``grad_gap`` and ``change_gap``: the worst leaf's gap of norms
    (``yardstick.worst_leaf_gap``); ``worst``, when given, gets the worst
    leaves, the leaves left out and every leaf's gap, for the calibration.
    The change leaves out a trained leaf whose reference gradient is under
    ``GRAD_FLOOR`` of the median leaf's: AdamW moves it by round-off
    alone."""
    missing = (set(grads) | set(changes)) - set(leaf_map)
    if missing:
        raise KeyError(f"port leaves with no reference tensor: {sorted(missing)}")
    rg = {k: leaf_norm(_parts(ref_grads, leaf_map[k])) for k in grads}
    rc = {k: leaf_norm(_parts(ref_changes, leaf_map[k])) for k in changes}
    med = statistics.median(rg.values())
    keep = [k for k in changes if k not in rg or rg[k] >= GRAD_FLOOR * med]
    g, c = worst_leaf_gap(grads, rg, grads), worst_leaf_gap(changes, rc, keep)
    if worst is not None:
        mc = statistics.median(rc[k] for k in keep)
        worst.update(grad_gap=g[1], change_gap=c[1], left_out=sorted(set(changes) - set(keep)),
                     grad_leaves={k: abs(grads[k] - rg[k]) / max(rg[k], med) for k in grads},
                     change_leaves={k: abs(changes[k] - rc[k]) / max(rc[k], mc) for k in keep})
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    return {"loss_gap_first": loss[0], "loss_gap_later": max(loss[1:], default=0.0),
            "grad_gap": g[0], "change_gap": c[0]}


def control(ctx, precision: str):
    """(numbers, detail): the gaps of the reference computed at
    ``precision`` put in the program's place, on the batches a run of this
    seed checks, and the worst leaves (``gaps``)."""
    feed = Feed(ctx.cfg, ctx.traffic, ctx.seed, ctx.device)
    checked = [feed.next() for _ in range(int(ctx.traffic["checked_steps"]))]
    leaf_map = ctx.family.leaf_map(ctx.cfg)
    losses, g, c = reference_steps(ctx, feed, checked, Precision(precision))
    trained = {k for k, parts in leaf_map.items() if not parts[0][0].endswith(_STATS)}
    grads = {k: leaf_norm(_parts(g, leaf_map[k])) for k in trained}
    changes = {k: leaf_norm(_parts(c, leaf_map[k])) for k in leaf_map}
    detail: dict = {}
    numbers = gaps(leaf_map, losses, grads, changes,
                   *reference_steps(ctx, feed, checked, Precision()), worst=detail)
    return numbers, detail
