"""t-SNE and trustworthiness in PyTorch, on the embeddings' device.

:func:`tsne` is scikit-learn 1.9's ``TSNE(method="exact", init="pca")``
with the options the JAX package's ``perform_tsne`` leaves at their
defaults (two components, Student-t with one degree of freedom, early
exaggeration 12, ``learning_rate="auto"``, ``max_iter`` 1000), step for
step:

1. squared euclidean distances, and each row's conditional P by a binary
   search on its precision until the row's entropy is within 1e-5 of
   log(perplexity) (at most 100 steps), then ``P = (P + P^T) / sum``,
   clamped below at the float64 epsilon;
2. the PCA init: the data's top two principal axes, each with the sign
   that ``svd_flip`` gives it (its largest-magnitude entry positive), the
   projection scaled so that its first column's std is 1e-4;
3. gradient descent with momentum and gains (+0.2 where the update and the
   gradient disagree in sign, x0.8 elsewhere, at least 0.01), learning rate
   max(N / 12 / 4, 50): 250 iterations on P x 12 with momentum 0.5, then up
   iteration 1000 on P with momentum 0.8, each phase with fresh gains and
   update; every 50 iterations the KL divergence is checked, and a phase
   ends after 250 iterations without a better one in the first, 300 in the
   second, or when the gradient's norm is at most 1e-7.

It returns the layout and the last KL divergence computed, as scikit-learn's
``kl_divergence_``.  The JAX package calls scikit-learn's default
Barnes-Hut method instead, an approximation of this gradient, so the two
layouts differ (ROADMAP.md section C).

Memory is O(N^2): a handful of N x N matrices in the compute type, 1.6 GB
each at N = 20,000 in float32, which the card holds.  The layout, its
gradient and the gains are float32, as scikit-learn keeps them; P, Q, the
distances and the sums are in the compute type: float32 on the card, the
input's floating type on the CPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS64 = float(torch.finfo(torch.float64).eps)  # scikit-learn's MACHINE_EPSILON
_EXAGGERATION = 12.0
_EXPLORATION_ITERS = 250
_MAX_ITER = 1000
_PATIENCE = 300  # n_iter_without_progress
_CHECK_EVERY = 50
_MIN_GAIN = 0.01
_MIN_GRAD_NORM = 1e-7
_ENTROPY_TOL = 1e-5
_SEARCH_STEPS = 100
_TRUST_NEIGHBORS = 5


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    if x.is_cuda or not x.is_floating_point() or x.dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return x.dtype


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N, N] squared euclidean distances, one coordinate at a
    time (no ``|a|^2 + |b|^2 - 2ab`` cancellation), 0 on the diagonal."""
    d2 = torch.zeros((x.shape[0], x.shape[0]), dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        d2.add_((x[:, k, None] - x[None, :, k]).square())
    return d2


def conditional_p(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Each row's Gaussian conditional P [N, N] over the other points, its
    precision found by binary search so that the row's entropy is within
    1e-5 of log(perplexity).  All rows search at once; a row stops moving
    once it is within the tolerance, as scikit-learn's per-row loop does."""
    n = d2.shape[0]
    dt = d2.dtype
    off = ~torch.eye(n, dtype=torch.bool, device=d2.device)
    target = math.log(perplexity)
    beta = torch.ones(n, dtype=torch.float64, device=d2.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=d2.device)
    p = torch.zeros_like(d2)
    for _ in range(_SEARCH_STEPS):
        pr = torch.where(off, torch.exp(-d2 * beta[:, None].to(dt)), 0.0)
        s = pr.sum(1)
        s = torch.where(s == 0, 1e-8, s)
        pr = pr / s[:, None]
        entropy = torch.log(s).double() + beta * (d2 * pr).sum(1).double()
        diff = entropy - target
        p = torch.where(active[:, None], pr, p)
        active = active & (diff.abs() > _ENTROPY_TOL)
        if not bool(active.any()):
            break
        up = active & (diff > 0)  # entropy too high: raise the precision
        down = active & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2, (beta + hi) / 2), beta)
        beta = torch.where(down, torch.where(torch.isinf(lo), beta / 2, (beta + lo) / 2), beta)
    return p


def joint_p(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetric joint P [N, N] of t-SNE: ``(P + P^T) / sum``, clamped
    below at the float64 epsilon off the diagonal, 0 on it."""
    p = conditional_p(squared_distances(x), perplexity)
    p = p + p.T
    p = torch.clamp(p / torch.clamp(p.sum(), min=_EPS64), min=_EPS64)
    return p.fill_diagonal_(0.0)


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """The PCA init, float32: the centered data on its top two principal
    axes, each axis signed so that its largest-magnitude entry is positive
    (scikit-learn's ``svd_flip``), scaled so that the first column's std is
    1e-4."""
    xc = x - x.mean(0)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    vt = vt[:2]
    signs = torch.sign(vt.gather(1, vt.abs().argmax(1, keepdim=True)))
    y = (xc @ (vt * signs).T).float()
    return y / y[:, 0].std(unbiased=False) * 1e-4


def _kl_and_grad(y: torch.Tensor, p: torch.Tensor, with_kl: bool):
    """The KL divergence of P and the Student-t Q of the float32 layout y
    (when ``with_kl``, else None), and its gradient [N, 2] rounded to
    float32.  Distances, Q and the sums are in P's type; the coordinate
    differences of the gradient in float32, as scikit-learn takes them."""
    num = 1.0 / (1.0 + squared_distances(y.to(p.dtype)))
    n = y.shape[0]
    q = torch.clamp(num / (num.sum() - n), min=_EPS64)
    kl = None
    if with_kl:
        kl = float((p * torch.log(torch.clamp(p, min=_EPS64) / q)).sum())
    w = (p - q) * num
    grad = torch.stack([(w * (y[:, k, None] - y[None, :, k]).to(w.dtype)).sum(1)
                        for k in range(y.shape[1])], dim=1)
    return kl, (grad.float() * 4.0)


def _descend(y, p, start: int, stop: int, momentum: float, lr: float, patience: int):
    """One phase of scikit-learn's ``_gradient_descent`` -> (y, last KL, last
    iteration).  The layout, the gradient and the gains are float32, the
    update in P's type, as scikit-learn keeps them."""
    update = torch.zeros_like(y, dtype=p.dtype)
    gains = torch.ones_like(y)
    kl = best = math.inf
    best_iter = i = start
    for i in range(start, stop):
        check = (i + 1) % _CHECK_EVERY == 0
        err, grad = _kl_and_grad(y, p, check or i == stop - 1)
        if err is not None:
            kl = err
        inc = update * grad < 0.0
        gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8), min=_MIN_GAIN)
        grad = grad * gains
        update = momentum * update - lr * grad.to(p.dtype)
        y = (y.to(p.dtype) + update).float()
        if check:
            if kl < best:
                best, best_iter = kl, i
            elif i - best_iter > patience:
                break
            if float(torch.linalg.vector_norm(grad)) <= _MIN_GRAD_NORM:
                break
    return y, kl, i


def tsne(x: torch.Tensor, perplexity: float = 30.0) -> Tuple[torch.Tensor, float]:
    """Exact t-SNE of x [N, D] (N >= 2, perplexity < N) -> (float32 layout
    [N, 2] on x's device, final KL divergence).  See the module docstring."""
    if x.ndim != 2:
        raise ValueError(f"tsne expects x [N, D], got {tuple(x.shape)}")
    n = x.shape[0]
    if n < 2 or perplexity >= n:
        raise ValueError(f"tsne needs N >= 2 and perplexity < N, got N = {n}, "
                         f"perplexity = {perplexity}")
    x = x.to(_compute_dtype(x))
    p = joint_p(x, perplexity)
    y = pca_init(x)
    lr = max(n / _EXAGGERATION / 4.0, 50.0)
    y, kl, it = _descend(y, p * _EXAGGERATION, 0, _EXPLORATION_ITERS, 0.5, lr,
                         _EXPLORATION_ITERS)
    y, kl, _ = _descend(y, p, it + 1, _MAX_ITER, 0.8, lr, _PATIENCE)
    return y, kl


def trustworthiness(x: torch.Tensor, y: torch.Tensor) -> float:
    """scikit-learn's ``trustworthiness`` (euclidean, ``n_neighbors`` 5): how
    far the 5 nearest neighbours of each point in the layout y rank among
    its neighbours in x, 1 when they are its nearest there too.  O(N^2)
    memory, on x's device."""
    n, k = x.shape[0], _TRUST_NEIGHBORS
    if k >= n / 2:
        raise ValueError(f"n_neighbors ({k}) should be less than n_samples / 2 ({n / 2})")
    dt = _compute_dtype(x)
    big = torch.finfo(dt).max
    dx = squared_distances(x.to(dt)).fill_diagonal_(big)
    rank_x = torch.empty((n, n), dtype=torch.long, device=x.device)
    order = torch.arange(1, n + 1, device=x.device).expand(n, n)
    rank_x.scatter_(1, torch.argsort(dx, dim=1, stable=True), order)
    dy = squared_distances(y.to(dt)).fill_diagonal_(big)
    nn_y = torch.argsort(dy, dim=1, stable=True)[:, :k]
    ranks = rank_x.gather(1, nn_y) - k
    t = float(ranks.clamp(min=0).sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))
