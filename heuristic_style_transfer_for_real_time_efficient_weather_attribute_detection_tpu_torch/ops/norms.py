"""Normalization layers (functional, NHWC), eps 1e-5 as in ``torch.nn``.

- ``batch_norm_infer``: running statistics (BatchNorm2d in eval mode).
- ``batch_norm_train``: batch statistics over N, H, W (train mode), with
  ``update_running_stats`` for the running statistics (both in
  ``train_batch_norm``), over the global batch of a mesh's data group.
- ``instance_norm``: per-sample, per-channel statistics over H, W (eval mode
  too: InstanceNorm2d keeps no running statistics by default).
- ``group_norm``: GroupNorm(32).
- ``layer_norm``: over the last dim (transformer norms).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

EPS = 1e-5


def batch_norm_affine(p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference batch norm as a per-channel affine ``x*scale + shift``."""
    inv = p["scale"] * torch.reciprocal(torch.sqrt(p["var"] + EPS))
    return inv, p["bias"] - p["mean"] * inv


def batch_norm_infer(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: [..., C]; p: {scale, bias, mean, var} each [C]."""
    scale, shift = batch_norm_affine(p)
    return x * scale + shift


def batch_norm_train(
    x: torch.Tensor, p: Dict[str, torch.Tensor], reduce_axes=(0, 1, 2), shard=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch statistics over ``reduce_axes`` (N, H, W of NHWC) -> (y,
    batch mean, batch variance).  The caller updates the running
    statistics (:func:`update_running_stats`).

    ``shard`` (a ``parallel.mesh.RowShard``: x holds this rank's rows of
    the global batch) takes the statistics over the global batch, as the
    JAX package's sharded step computes them: float32 sums over the data
    group's ranks, the mean first and then the squared deviations from it
    (the single-device ``var(correction=0)``), divided by the global count
    and rounded once to x's type.  The sums are differentiable, so the
    backward carries the other ranks' terms (SyncBatchNorm's backward)."""
    if shard is None:
        mean = x.mean(dim=reduce_axes)
        var = x.var(dim=reduce_axes, correction=0)
    else:
        n = _count(x, reduce_axes, shard)
        x32 = x.float()
        mean32 = shard.all_reduce(x32.sum(dim=reduce_axes)) / n
        shape = [1 if a in reduce_axes else s for a, s in enumerate(x.shape)]
        dev = (x32 - mean32.reshape(shape)).square().sum(dim=reduce_axes)
        mean, var = mean32.to(x.dtype), (shard.all_reduce(dev) / n).to(x.dtype)
    inv = p["scale"] * torch.reciprocal(torch.sqrt(var + EPS))
    return x * inv + (p["bias"] - mean * inv), mean, var


def _count(x: torch.Tensor, reduce_axes, shard=None) -> int:
    """Values each channel reduces: over the global batch with a shard."""
    n = 1
    for a in reduce_axes:
        n *= x.shape[a]
    return n if shard is None else n // x.shape[0] * shard.total


def train_batch_norm(
    x: torch.Tensor, p: Dict[str, torch.Tensor], shard=None, momentum: float = 0.1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode batch norm of NHWC x -> (y, the norm's params with new
    running statistics, their unbiased variance from the count of values
    each channel reduced: the global batch's with a ``shard``)."""
    axes = tuple(range(x.dim() - 1))
    y, mean, var = batch_norm_train(x, p, axes, shard)
    return y, update_running_stats(p, mean, var, _count(x, axes, shard), momentum)


def update_running_stats(
    p: Dict[str, torch.Tensor], mean: torch.Tensor, var: torch.Tensor, n: int,
    momentum: float = 0.1,
) -> Dict[str, torch.Tensor]:
    """The norm's params with running statistics moved toward a batch's, as
    torch's BatchNorm does in train mode: momentum 0.1 and the unbiased
    variance of the ``n`` values each channel reduced.  Scale and bias are
    the same tensors; the new statistics carry no gradient."""
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        return {**p, "mean": (1 - momentum) * p["mean"] + momentum * mean,
                "var": (1 - momentum) * p["var"] + momentum * unbiased}


def instance_norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: [B, H, W, C]; per-(sample, channel) stats over spatial dims."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), correction=0, keepdim=True)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + EPS))
    return y * p["scale"] + p["bias"]


def group_norm(
    x: torch.Tensor, p: Dict[str, torch.Tensor], num_groups: int = 32
) -> torch.Tensor:
    """x: [B, H, W, C]; stats per (sample, group) over H, W and the group's channels."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), correction=0, keepdim=True)
    y = ((xg - mean) * torch.reciprocal(torch.sqrt(var + EPS))).reshape(b, h, w, c)
    return y * p["scale"] + p["bias"]


def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Normalize over the trailing dim; p: {scale, bias} each [D]."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, correction=0, keepdim=True)
    return (x - mean) * torch.reciprocal(torch.sqrt(var + EPS)) * p["scale"] + p["bias"]


def apply_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    """Dispatch used by conv trunks; ``kind`` in {batch, instance, group}."""
    if kind == "batch":
        return batch_norm_infer(x, p)
    if kind == "instance":
        return instance_norm(x, p)
    if kind == "group":
        return group_norm(x, p)
    raise ValueError(f"unknown norm kind {kind!r}")
