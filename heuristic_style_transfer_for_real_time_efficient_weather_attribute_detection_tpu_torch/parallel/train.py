"""Multi-task training step of the port, on one device or over a mesh.

Counterpart of the JAX package's ``parallel/train.py``: the train-mode
forward (batch norm on batch statistics with running-statistic updates,
the PMG transformer's dropout), the masked multi-task cross entropy with
class weights and focal modulation, and AdamW at optax's defaults (lr 3e-4,
weight decay 1e-4, betas (0.9, 0.999), eps 1e-8) with the decay mask and
optional gradient accumulation.  PyTorch's idiom inside: autograd,
``torch.optim.AdamW``, and generators on the device reseeded from
``(seed, step)`` every step, so a resumed run replays the straight run's
dropout masks and augmentations.

The state is updated in place: ``step_fn`` returns a new ``TrainState``
whose params and optimizer state are the objects it was given, one step
on (the JAX package returns new arrays; in place, the device holds one copy
of the params and moments).  After a step each trainable leaf's ``.grad``
holds the gradient that step computed (for ``accum_steps > 1``, at an
update, the mean it applied).  The batch-norm running statistics are not
trainable: they take no gradient, stay out of the optimizer (optax gives
them a zero update and no decay, the same result) and are copied in from
the train-mode forward.

``mesh`` (``parallel.mesh.make_mesh``, one process per device) is the JAX
package's data and task sharding.  Each rank takes its rows of the batch
over ``data``; the stacked per-task leaves (root keys ``queries``,
``heads``, ``attn``, ``final``, ``mlp``) are split over ``model``, each
rank holding, updating and computing only its tasks' slice, params and
AdamW moments alike; everything else is replicated.  The step computes
what the unsharded step computes on the global batch: batch norms take the
global batch's statistics, dropout and augmentation draw for the global
batch from the same ``(seed, step)`` generators and keep their own rows,
each task's masked mean divides by the global count (or class-weight sum)
of that task and the present-task count is global, and the gradients are
summed, over the whole world for replicated leaves and over ``data`` for
task-sharded ones.  Every rank returns the global loss.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import IGNORE_INDEX
from ..engine.executor import class_mask
from ..models import get_family
from ..utils import trace
from .mesh import Mesh, RowShard, batch_rows

_STATS_KEYS = {"mean", "var"}
# Param-tree ROOT keys whose subtrees are stacked per-task tensors with a
# leading task axis T (split over a mesh's 'model' axis): PMG's
# ``queries``/``heads``, PM's ``heads``, RTM's ``attn``/``mlp``/``final``.
# The match is on the first path component only: PMG's
# ``transformer/[i]/attn``, whose [d_model, d_model] weights carry no task
# axis, is replicated.
_TASK_AXIS_ROOTS = frozenset({"queries", "heads", "attn", "final", "mlp"})
_ENCODER_ROOTS = {"trunk", "backbone"}


def _named_leaves(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path of keys and list indices, leaf) of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, path + (i,))
    else:
        yield path, tree


def _map_tree(fn: Callable[[Tuple, Any], Any], tree: Any, path: Tuple = ()) -> Any:
    """The tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaf_dict(tree: Any) -> Dict[str, Any]:
    """{"trunk/0/conv/w": leaf, ...}: a tree's leaves by path."""
    return {"/".join(map(str, p)): v for p, v in _named_leaves(tree)}


def _decays(path: Tuple) -> bool:
    return not (set(path) & _STATS_KEYS)


def _decay_mask(params: Any) -> Any:
    """AdamW decays every leaf but the batch-norm running statistics (which
    take no gradient and must not decay toward 0)."""
    return _map_tree(lambda path, _: _decays(path), params)


def _trainable(path: Tuple, leaf: torch.Tensor) -> bool:
    """A leaf the optimizer updates: a float leaf the decay mask decays."""
    return leaf.is_floating_point() and _decays(path)


def trainable_params(params: Any, device) -> Any:
    """A copy of ``params`` on ``device`` for training: every leaf a new
    tensor, the trainable ones (float leaves but the running statistics)
    leaves of autograd that require grad."""
    return _map_tree(
        lambda path, t: t.detach().to(device, copy=True).requires_grad_(_trainable(path, t)),
        params)


def snapshot(params: Any, device="cpu") -> Any:
    """A detached copy of ``params`` on ``device`` (every leaf a new tensor,
    no gradient): what the train loop hands to an eval engine or saves."""
    return _map_tree(lambda _, t: t.detach().to(device, copy=True), params)


class TrainState(NamedTuple):
    params: Any  # param tree on the device; the trainable leaves require grad
    opt_state: "OptState"
    step: int  # mini-steps taken: every call of the step function


_BETAS, _EPS = (0.9, 0.999), 1e-8  # optax.adamw's defaults


class Optimizer(NamedTuple):
    """AdamW's learning rate and weight decay (betas and eps at optax's
    defaults) and the gradient accumulation of ``optax.MultiSteps``
    (``accum_steps`` mini-steps averaged per update)."""

    lr: float = 3e-4
    weight_decay: float = 1e-4
    accum_steps: int = 1

    def init(self, params: Any) -> "OptState":
        return OptState(self, params)


def make_optimizer(
    lr: float = 3e-4,
    weight_decay: float = 1e-4,
    accum_steps: int = 1,
    params_template=None,
) -> Optimizer:
    """The recorded reference recipe (AdamW lr 3e-4, weight decay 1e-4,
    ``accum_steps``).  ``params_template`` is accepted, as in the JAX
    package, and ignored: the decay mask depends only on tree paths."""
    del params_template
    return Optimizer(float(lr), float(weight_decay), int(accum_steps))


class OptState:
    """``torch.optim.AdamW`` over the trainable leaves of one param tree, the
    leaves the decay mask decays, all with weight decay.  The encoder's
    leaves (trunk/backbone) form a group of their own, so that a frozen
    encoder takes lr 0 and weight decay 0: a zero update, with moments that
    still decay on its zeroed gradients, as optax's do.  For
    ``accum_steps > 1``, ``acc`` holds the running mean of the mini-steps'
    gradients (``optax.MultiSteps``) and ``mini_step`` where the current
    update stands."""

    def __init__(self, optimizer: Optimizer, params: Any):
        self.optimizer = optimizer
        named = [(p, t) for p, t in _named_leaves(params) if _trainable(p, t)]
        self.paths = ["/".join(map(str, p)) for p, _ in named]
        self.leaves = [t for _, t in named]
        self.encoder = [bool(set(p) & _ENCODER_ROOTS) for p, _ in named]
        groups = []
        for enc in (True, False):
            group = [t for t, e in zip(self.leaves, self.encoder) if e == enc]
            if group:
                groups.append({"params": group, "encoder": enc})
        self.adamw = torch.optim.AdamW(groups, lr=optimizer.lr, betas=_BETAS, eps=_EPS,
                                       weight_decay=optimizer.weight_decay)
        for t in self.leaves:  # eager, so a fresh state saves and loads like any other
            self.adamw.state[t] = {"step": torch.tensor(0.0),
                                   "exp_avg": torch.zeros_like(t, requires_grad=False),
                                   "exp_avg_sq": torch.zeros_like(t, requires_grad=False)}
        self.acc = ([torch.zeros_like(t, requires_grad=False) for t in self.leaves]
                    if optimizer.accum_steps > 1 else None)
        self.mini_step = 0

    def update(self, freeze_encoder: bool = False) -> None:
        """Apply the gradients in the leaves' ``.grad`` (a leaf without one
        counts as zero, as in optax), zeroed for the encoder when it is
        frozen.  With accumulation, fold them into the running mean and
        update only on the last mini-step."""
        for t, enc in zip(self.leaves, self.encoder):
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            elif freeze_encoder and enc:
                t.grad.zero_()
        if self.acc is not None:
            n = self.mini_step
            with torch.no_grad():
                for a, t in zip(self.acc, self.leaves):
                    a.add_((t.grad - a) / (n + 1))
            self.mini_step = (n + 1) % self.optimizer.accum_steps
            if self.mini_step:
                return
            for a, t in zip(self.acc, self.leaves):
                t.grad.copy_(a)
                a.zero_()
        lr, wd = self.optimizer.lr, self.optimizer.weight_decay
        for group in self.adamw.param_groups:
            frozen = freeze_encoder and group["encoder"]
            group["lr"], group["weight_decay"] = (0.0, 0.0) if frozen else (lr, wd)
        self.adamw.step()

    def tree(self) -> Dict[str, Any]:
        """The state as a tree of tensors (for native checkpoints): AdamW's
        update count, its moments by leaf path, the mini-step and, with
        accumulation, the running mean of the gradients."""
        st = self.adamw.state
        out: Dict[str, Any] = {
            "count": st[self.leaves[0]]["step"].detach().clone(),
            "exp_avg": {p: st[t]["exp_avg"] for p, t in zip(self.paths, self.leaves)},
            "exp_avg_sq": {p: st[t]["exp_avg_sq"] for p, t in zip(self.paths, self.leaves)},
            "mini_step": torch.tensor(self.mini_step),
        }
        if self.acc is not None:
            out["acc"] = dict(zip(self.paths, self.acc))
        return out

    def load_tree(self, tree: Dict[str, Any]) -> None:
        """Take the state from a :meth:`tree` (of another device, or made by
        ``engine.checkpoint.train_state_from_jax``)."""
        with torch.no_grad():
            for p, t in zip(self.paths, self.leaves):
                st = self.adamw.state[t]
                st["step"] = torch.tensor(float(tree["count"]))
                st["exp_avg"].copy_(tree["exp_avg"][p])
                st["exp_avg_sq"].copy_(tree["exp_avg_sq"][p])
            if self.acc is not None:
                for p, a in zip(self.paths, self.acc):
                    a.copy_(tree["acc"][p])
        self.mini_step = int(tree["mini_step"])


def masked_cross_entropy_ex(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    focal_gamma: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE with optional per-class weights and focal modulation, in
    float32 (the padded classes are set to float32's minimum before the log
    softmax, whatever the logits' type).

    class_weights: [T, Kmax] (zero-padded); torch ``CrossEntropyLoss(weight)``
    semantics, the per-task mean divides by the sum of the selected weights.
    focal_gamma: each sample's NLL times (1 - p_target)^gamma.
    Returns (per-task loss [T], per-task count [T]).
    """
    num, den, count = _ce_parts(logits, labels, mask, class_weights, focal_gamma)
    return num / den.clamp(min=_den_floor(class_weights)), count


def _den_floor(class_weights) -> float:
    return 1 if class_weights is None else 1e-9


def _ce_parts(logits, labels, mask, class_weights=None, focal_gamma=None):
    """Per task: (the summed masked NLL, weighted where there are class
    weights; its denominator, the count of labels or the sum of their
    weights; the count of labels)."""
    neg = torch.finfo(torch.float32).min
    logp = torch.log_softmax(torch.where(mask, logits.float(), neg), dim=-1)
    valid = labels != IGNORE_INDEX
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if focal_gamma is not None:
        nll = nll * (1.0 - torch.exp(-nll)) ** focal_gamma
    count = valid.sum(dim=0)
    if class_weights is not None:
        cw = class_weights.expand(labels.shape[0], *class_weights.shape)
        w = torch.where(valid, torch.gather(cw, -1, safe[..., None])[..., 0], 0.0)
        return (torch.where(valid, nll, 0.0) * w).sum(dim=0), w.sum(dim=0), count
    return torch.where(valid, nll, 0.0).sum(dim=0), count, count


def compute_class_weights(labels, num_classes, mode: str = "median", cap: float = 10.0):
    """Per-task inverse-frequency class weights from the label matrix [N, T]
    (the recorded ``class_weight_mode: median`` / ``class_weight_cap: 10``
    options).  Returns a zero-padded [T, Kmax] float32 numpy array."""
    nt = len(num_classes)
    out = np.zeros((nt, max(num_classes)), np.float32)
    for ti in range(nt):
        col = labels[:, ti]
        col = col[col != IGNORE_INDEX]
        counts = np.bincount(col, minlength=num_classes[ti]).astype(np.float64)
        freq = np.maximum(counts, 1e-9)
        if mode == "median":
            ref = np.median(freq[counts > 0]) if (counts > 0).any() else 1.0
        else:  # "mean" / fallback
            ref = freq[counts > 0].mean() if (counts > 0).any() else 1.0
        w = np.clip(ref / freq, 0.0, cap)
        w[counts == 0] = 0.0
        out[ti, : num_classes[ti]] = w
    return out


def _merge_stats(current: Any, updated: Any) -> None:
    """Copy the running statistics of a train-mode forward's updated
    subtree into ``current`` in place (in current's dtype); every other leaf,
    the optimizer-updated weights, is left as it is."""
    cur = dict(_named_leaves(current))
    with torch.no_grad():
        for path, upd in _named_leaves(updated):
            if set(path) & _STATS_KEYS:
                cur[path].copy_(upd)


def _family_trains_bn(family: str, spec) -> bool:
    """PMG/PM carry batch norms only when spec.norm == 'batch'; RTM's ResNet
    backbone always does."""
    if family == "rtm":
        return True
    return getattr(spec, "norm", None) == "batch"


def _step_seed(seed: int, step: int) -> int:
    """The generator seed of one step: (seed, step) packed into 64 bits."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def train_device(device) -> torch.device:
    """``device`` as a torch.device; the CUDA card must be there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training: no CUDA device is available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev


def _shards_tasks(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and "model" in mesh.axis_names


def _is_task_leaf(path, mesh: Optional[Mesh]) -> bool:
    """True for a leaf of a task-stacked root when the mesh has a 'model'
    axis; ``path`` is a tuple of keys or a "/"-joined string."""
    if not _shards_tasks(mesh) or not path:
        return False
    root = path.split("/")[0] if isinstance(path, str) else path[0]
    return root in _TASK_AXIS_ROOTS


def task_range(mesh: Mesh, n_tasks: int) -> Tuple[int, int]:
    """This rank's tasks [lo, hi) of ``n_tasks`` split over 'model'.  As in
    the JAX package, whose sharding of the leading task axis needs it to
    divide by the axis's size, an uneven split raises ``ValueError``."""
    m = mesh.axis_size("model")
    if n_tasks % m:
        raise ValueError(f"the {n_tasks} tasks do not split evenly over the {m} ranks of the "
                         "mesh's 'model' axis: a task-stacked leaf's dimension 0 must divide by it")
    per = n_tasks // m
    lo = mesh.index("model") * per
    return lo, lo + per


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """Each leaf's layout over the mesh, as the JAX package's PartitionSpec
    tuple: ``("model", None, ...)`` for a leaf of a task-stacked root
    (``_TASK_AXIS_ROOTS``, matched on the first path component) when the
    mesh has a 'model' axis, its leading task axis split over it; ``()``
    (replicated) for every other leaf."""
    return _map_tree(lambda path, t: ("model",) + (None,) * (t.dim() - 1)
                     if _is_task_leaf(path, mesh) else (), params)


def shard_params(params: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's part of a full param tree: each task-stacked leaf's rows
    of this rank's tasks (a view), every other leaf as it is."""
    def one(path, t):
        if not _is_task_leaf(path, mesh):
            return t
        lo, hi = task_range(mesh, t.shape[0])
        return t[lo:hi]

    return _map_tree(one, params)


def gather_params(params: Any, mesh: Optional[Mesh]) -> Any:
    """The full param tree from every rank's part (a collective over each
    'model' group): task-stacked leaves gathered, detached; the others as
    they are."""
    return _map_tree(lambda path, t: mesh.gather(t.detach(), "model")
                     if _is_task_leaf(path, mesh) else t, params)


def _map_opt_tree(fn, tree: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """An optimizer state tree with ``fn`` applied to its task-stacked
    leaves (moments and accumulated gradients, keyed by leaf path)."""
    out = dict(tree)
    for key in ("exp_avg", "exp_avg_sq", "acc"):
        if key in tree:
            out[key] = {p: fn(t) if _is_task_leaf(p, mesh) else t for p, t in tree[key].items()}
    return out


def gather_state(state: TrainState, mesh: Optional[Mesh]) -> TrainState:
    """The full train state (what one device would hold) from every rank's
    part: params and optimizer state gathered over 'model', on the state's
    device.  A collective: every rank calls it."""
    if mesh is None:
        return state
    ost = state.opt_state
    params = trainable_params(gather_params(state.params, mesh), ost.leaves[0].device)
    full = ost.optimizer.init(params)
    full.load_tree(_map_opt_tree(lambda t: mesh.gather(t, "model"), ost.tree(), mesh))
    return TrainState(params, full, state.step)


def shard_state(state: TrainState, mesh: Optional[Mesh]) -> TrainState:
    """This rank's part of a full train state: its tasks' slices of the
    task-stacked params and of their optimizer state."""
    if mesh is None:
        return state
    ost = state.opt_state
    params = trainable_params(shard_params(state.params, mesh), ost.leaves[0].device)
    part = ost.optimizer.init(params)
    part.load_tree(_map_opt_tree(lambda t: t[slice(*task_range(mesh, t.shape[0]))],
                                 ost.tree(), mesh))
    return TrainState(params, part, state.step)


def _sum_grads(ost: "OptState", mesh: Mesh) -> None:
    """Sum the ranks' gradients in place, each leaf's ``.grad`` (zero where
    missing): over the whole world for replicated leaves, over the 'data'
    group for task-stacked ones (a rank's tasks are its own).  One
    all-reduce per group, on one flat buffer."""
    for t in ost.leaves:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    for task, axis in ((False, None), (True, "data")):
        grads = [t.grad for p, t in zip(ost.paths, ost.leaves) if _is_task_leaf(p, mesh) == task]
        if not grads:
            continue
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), axis)
        i = 0
        for g in grads:
            g.copy_(flat[i: i + g.numel()].view_as(g))
            i += g.numel()


def make_train_step(
    family: str,
    spec,
    optimizer: Optional[Optimizer] = None,
    mesh: Optional[Mesh] = None,
    *,
    use_focal: bool = False,
    focal_gamma: float = 2.0,
    class_weights=None,
    freeze_encoder: bool = False,
    bn_train: bool = True,
    dropout_rate: float = 0.1,
    dropout_seed: int = 1234,
    compute_dtype: Optional[torch.dtype] = None,
    augment=None,
    device="cuda",
) -> Tuple[Callable, Callable]:
    """Returns (init_fn(seed) -> TrainState, step_fn(state, images, labels)
    -> (state, loss)).

    images: normalized float NHWC [B, H, W, 3] (numpy or a tensor, moved to
    ``device``); labels: [B, T] int with IGNORE_INDEX for missing
    annotations.  ``bn_train``: batch norm on batch statistics with
    running-statistic updates (PMG/PM with norm 'batch'; RTM's backbone
    always); ``dropout_rate``: the PMG transformer's train-mode dropout,
    its masks drawn from a generator reseeded from (``dropout_seed``,
    step); ``freeze_encoder``: zero gradients and updates for the
    trunk/backbone.  ``augment`` (True for ``ops.augment.DEFAULT_AUGMENT``,
    or a kwargs dict for ``augment_batch``, {} meaning the default recipe)
    augments the batch on the device, drawn from (``dropout_seed ^ 0x5EED``,
    step).  ``compute_dtype=torch.bfloat16`` runs the forward and backward
    in bf16 on a cast of the float32 master params (gradients come back
    float32 through the cast; the optimizer state stays float32; the loss is
    reduced in float32; in batch-statistics mode the running statistics
    skip the cast, so their update runs in float32).  ``device`` defaults
    to the CUDA card and raises where there is none.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank builds the same step and
    calls it in step) shards the step as the module docstring says.  The
    batch is the global batch, of which the step takes this rank's rows, or
    this rank's rows marked by ``multihost.host_local_batch``; B must
    divide by the 'data' size and the task count by the 'model' size
    (``ValueError`` otherwise).  ``init_fn`` returns this rank's part of
    the state (``gather_state`` gives the whole).
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got {type(mesh).__name__}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None, float32 or bfloat16, got {compute_dtype}")
    dev = train_device(device)
    mod = get_family(family)
    mask = torch.as_tensor(class_mask(spec.tasks), device=dev)
    cw = None if class_weights is None else torch.as_tensor(
        np.asarray(class_weights, np.float32), device=dev)
    tasks = slice(None)
    if _shards_tasks(mesh):
        tasks = slice(*task_range(mesh, len(spec.tasks)))
        mask = mask[tasks]
        cw = None if cw is None else cw[tasks]
    gamma = focal_gamma if use_focal else None
    # PMG's transformer is the only dropout site; PM/RTM would otherwise be
    # forced into batch statistics against an explicit bn_train=False
    has_dropout_sites = family == "pmg" and getattr(spec, "has_transformer", False)
    stats_update_mode = bn_train and _family_trains_bn(family, spec)
    train_mode = hasattr(mod, "apply_train") and (
        stats_update_mode or (dropout_rate > 0 and has_dropout_sites))
    aug_kwargs = None
    if augment is not None and augment is not False:
        from ..ops.augment import DEFAULT_AUGMENT, augment_batch

        if augment is True:
            aug_kwargs = dict(DEFAULT_AUGMENT)
        elif isinstance(augment, dict):
            aug_kwargs = dict(augment) if augment else dict(DEFAULT_AUGMENT)
        else:
            raise TypeError(
                "augment must be True/False/None or a kwargs dict for "
                f"ops.augment.augment_batch, got {type(augment).__name__}"
            )
    mixed = compute_dtype is not None and compute_dtype != torch.float32
    drop_gen = torch.Generator(device=dev)
    aug_gen = torch.Generator(device=dev)
    opt = optimizer or make_optimizer()

    def _cast_compute(params):
        # in batch-statistics mode the forward never reads the running
        # statistics, so they stay float32 and their update runs in float32
        # instead of rounding momentum-0.1 steps away in bf16; otherwise
        # they feed the forward and cast with everything else
        def one(path, x):
            keep = stats_update_mode and set(path) & _STATS_KEYS
            return x if keep or not x.is_floating_point() else x.to(compute_dtype)

        return _map_tree(one, params)

    def loss_fn(params, images, labels, step_idx, shard):
        if mixed:
            params = _cast_compute(params)
            images = images.to(compute_dtype)
        stat_updates = None
        if train_mode:
            gen = None
            if dropout_rate > 0:
                gen = drop_gen.manual_seed(_step_seed(dropout_seed, step_idx))
            logits, stat_updates = mod.apply_train(params, images, spec, generator=gen,
                                                   dropout_rate=dropout_rate, shard=shard)
            if not stats_update_mode:
                stat_updates = None
        else:
            logits, _ = mod.apply(params, images, spec)
        num, den, counts = _ce_parts(logits, labels, mask, cw, gamma)
        if mesh is not None:
            # the global batch's denominators: a mean of the ranks' means
            # would weigh unevenly spread missing labels wrongly
            den, counts = mesh.all_reduce(den, "data"), mesh.all_reduce(counts, "data")
        per_task = num / den.clamp(min=_den_floor(cw))
        present = (counts > 0).float()
        n_present = present.sum() if mesh is None else mesh.all_reduce(present.sum(), "model")
        return (per_task * present).sum() / n_present.clamp(min=1.0), stat_updates

    def step(state: TrainState, images, labels) -> Tuple[TrainState, torch.Tensor]:
        with trace.span("train.step", device=dev):
            return _step(state, images, labels)

    def _step(state: TrainState, images, labels) -> Tuple[TrainState, torch.Tensor]:
        shard = None
        if mesh is not None:
            images, lo, total = batch_rows(mesh, images)
            labels, _, _ = batch_rows(mesh, labels)
            if mesh.axis_size("data") > 1:
                shard = RowShard(lo, total, mesh)
        x = torch.as_tensor(images, dtype=torch.float32, device=dev)
        y = torch.as_tensor(labels, device=dev)[:, tasks]
        if aug_kwargs is not None:
            x = augment_batch(aug_gen.manual_seed(_step_seed(dropout_seed ^ 0x5EED, state.step)),
                              x, shard=shard, **aug_kwargs)
        ost = state.opt_state
        for t in ost.leaves:
            t.grad = None
        with torch.enable_grad():
            with trace.span("train.forward", device=dev):
                loss, stat_updates = loss_fn(state.params, x, y, state.step, shard)
            with trace.span("train.backward", device=dev):
                loss.backward()
        if mesh is not None:
            with trace.span("train.allreduce"):
                _sum_grads(ost, mesh)
                loss = mesh.all_reduce(loss.detach())  # the ranks' parts sum to the global loss
        with trace.span("train.optimizer", device=dev):
            ost.update(freeze_encoder)
        if stat_updates is not None:
            # running statistics take no gradient: adopt the train-mode
            # forward's, keeping the optimizer-updated weights
            with trace.span("train.stats"):
                for root, upd in stat_updates.items():
                    _merge_stats(state.params[root], upd)
        return TrainState(state.params, ost, state.step + 1), loss.detach()

    def init_fn(seed=0) -> TrainState:
        g = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
        params = trainable_params(shard_params(mod.init(g, spec), mesh), dev)
        return TrainState(params, opt.init(params), 0)

    return init_fn, step


# ---------------------------------------------------------------------------
# Memoized step construction: callers that rebuild the step with the same
# configuration (fit() resuming a run, repeat fits in one process) get the
# one built before, with its class mask and weights already on the device.
_STEP_CACHE: dict = {}
_STEP_CACHE_MAX = 16


def _freeze_for_key(x):
    """Canonicalize a kwarg into something hashable, or raise TypeError."""
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze_for_key(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze_for_key(v) for v in x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):  # class_weights
        return (x.shape, str(x.dtype), x.tobytes())
    hash(x)
    return x


def cached_train_step(
    family: str,
    spec,
    *,
    lr: float = 3e-4,
    weight_decay: float = 1e-4,
    accum_steps: int = 1,
    mesh=None,
    **kwargs,
):
    """Memoized :func:`make_train_step` and its optimizer -> ``(optimizer,
    init_fn, step_fn)``.  Two calls with equal (family, spec, optimizer
    hyperparameters, kwargs) in one process return the same objects; an
    unhashable spec or kwarg builds afresh, uncached."""
    try:
        key = (family, spec, lr, weight_decay, accum_steps,
               None if mesh is None else id(mesh), _freeze_for_key(kwargs))
        hash(key)
    except TypeError:
        key = None
    if key is not None and key in _STEP_CACHE:
        return _STEP_CACHE[key]
    optimizer = make_optimizer(lr=lr, weight_decay=weight_decay, accum_steps=accum_steps)
    bundle = (optimizer,) + tuple(make_train_step(family, spec, optimizer, mesh=mesh, **kwargs))
    if key is not None:
        if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
            _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
        _STEP_CACHE[key] = bundle
    return bundle
