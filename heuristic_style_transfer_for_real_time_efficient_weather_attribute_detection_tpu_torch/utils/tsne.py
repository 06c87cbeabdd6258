"""t-SNE and trustworthiness in PyTorch, on the embeddings' device.

:func:`tsne` computes the objective that the JAX package's ``perform_tsne``
asks scikit-learn 1.9 for, ``TSNE(n_components=2, perplexity=...)`` with
its other options at their defaults: the Barnes-Hut method's sparse
nearest-neighbour P, with the repulsion summed exactly where Barnes-Hut
approximates it by a quadtree (its ``angle`` -> 0 limit:
``TSNE(angle=0.0)`` takes the same steps).  Step for step:

1. each point's k = min(N - 1, int(3 perplexity + 1)) nearest other points
   (:func:`knn`: exact squared euclidean distances over row chunks, the
   point itself left out by index as ``kneighbors_graph()`` leaves it out),
   their distances rounded to float32 as ``_joint_probabilities_nn`` rounds
   them;
2. each row's conditional P over its k neighbours by a float64 binary
   search on its precision until the row's entropy is within 1e-5 of
   log(perplexity) (at most 100 steps); then ``P = P + P^T`` on the union
   of the two patterns, divided by its sum (at least the float64 epsilon),
   absent pairs left absent, as :class:`JointP` (at most 2 N k entries);
3. the PCA init: the data's top two principal axes, each with the sign
   that ``svd_flip`` gives it (its largest-magnitude entry positive), the
   projection scaled so that its first column's std is 1e-4;
4. gradient descent with momentum and gains (+0.2 where the update and the
   gradient disagree in sign, x0.8 elsewhere, at least 0.01), learning rate
   max(N / 12 / 4, 50): 250 iterations on P x 12 with momentum 0.5, then up
   to iteration 1000 on P with momentum 0.8, each phase with fresh gains and
   update; every 50 iterations the KL divergence is checked, and a phase
   ends after 250 iterations without a better one in the first, 300 in the
   second, or when the gradient's norm is at most 1e-7.

The gradient is ``4 (sum_j p_ij q_ij (y_i - y_j) - sum_j q_ij^2 (y_i -
y_j) / Z)``, q_ij = 1 / (1 + |y_i - y_j|^2), Z = sum_{i != j} q_ij: the
first sum over P's entries (a gather, and each row's entries summed in
order by ``torch.segment_reduce``: no atomics, so a layout is the same
every run, as scikit-learn's is for one ``random_state``), the second and Z
over all pairs by ``ops.cuda_kernels.tsne_repulsion`` (the hand-written
kernel on the card, its plain version on the CPU).  The KL divergence is
summed over P's entries, as ``_kl_divergence_bh`` sums it.  It returns the
layout and the last KL divergence computed, as scikit-learn's
``kl_divergence_``.  Barnes-Hut's own approximation error (its default
angle 0.5) is the one difference left (ROADMAP.md section C).

Memory is O(N k): P's entries and a few [N, k] and [entries] tensors; the
distances of step 1 and the plain repulsion take [rows, N] blocks of at
most 2^25 elements.  The layout, its gradient and the gains are float32,
as scikit-learn keeps them; P, the attraction and the update are in the
compute type: float32 on the card, the input's floating type on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.cuda_kernels import tsne_repulsion

_EPS64 = float(torch.finfo(torch.float64).eps)  # scikit-learn's MACHINE_EPSILON
_TINY32 = float(torch.finfo(torch.float32).tiny)  # _barnes_hut_tsne's FLOAT32_TINY
_EXAGGERATION = 12.0
_EXPLORATION_ITERS = 250
_MAX_ITER = 1000
_PATIENCE = 300  # n_iter_without_progress
_CHECK_EVERY = 50
_MIN_GAIN = 0.01
_MIN_GRAD_NORM = 1e-7
_ENTROPY_TOL = 1e-5
_SEARCH_STEPS = 100
_SEARCH_EMPTY = 1e-8  # _binary_search_perplexity's EPSILON_DBL for a row whose P sums to 0
_TRUST_NEIGHBORS = 5
_CHUNK = 1 << 25  # elements of one [rows, N] block of distances


class JointP(NamedTuple):
    """The sparse symmetric joint P: ``P[rows[e], cols[e]] = vals[e]``,
    row-major, without the diagonal or zero entries (scipy's sum drops
    them); ``counts[i]``: row i's entries."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    counts: torch.Tensor

    def scaled(self, factor: float) -> "JointP":
        return self._replace(vals=self.vals * factor)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    if x.is_cuda or not x.is_floating_point() or x.dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return x.dtype


def squared_distances(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[M, D] and [N, D] (default: a) -> [M, N] squared euclidean distances,
    one coordinate at a time (no ``|a|^2 + |b|^2 - 2ab`` cancellation)."""
    b = a if b is None else b
    d2 = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    for k in range(a.shape[1]):
        d2.add_((a[:, k, None] - b[None, :, k]).square())
    return d2


def knn(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point's k nearest other points of x [N, D], exactly ->
    (squared euclidean distances [N, k] in x's type, indices [N, k] int64),
    nearest first.  The point itself is left out by index, as
    ``kneighbors_graph()`` leaves it out, so a duplicate at distance 0
    stays a neighbour.  Row chunks of [rows, N]: no [N, N] tensor."""
    n = x.shape[0]
    if not 0 < k < n:
        raise ValueError(f"knn needs 0 < k < N, got k = {k}, N = {n}")
    dist = torch.empty((n, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((n, k), dtype=torch.long, device=x.device)
    rows = max(1, _CHUNK // n)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        d2 = squared_distances(x[lo:hi], x)
        r = torch.arange(hi - lo, device=x.device)
        d2[r, r + lo] = math.inf
        dist[lo:hi], idx[lo:hi] = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return dist, idx


def conditional_p(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Each row's Gaussian conditional P over its neighbours' squared
    distances d2 [N, k] (float64), its precision found by binary search so
    that the row's entropy is within 1e-5 of log(perplexity).  All rows
    search at once; a row stops moving once it is within the tolerance, as
    ``_binary_search_perplexity``'s per-row loop does."""
    n = d2.shape[0]
    target = math.log(perplexity)
    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=d2.device)
    p = torch.zeros_like(d2)
    for _ in range(_SEARCH_STEPS):
        pr = torch.exp(-d2 * beta[:, None])
        s = pr.sum(1)
        s = torch.where(s == 0, _SEARCH_EMPTY, s)
        pr = pr / s[:, None]
        entropy = torch.log(s) + beta * (d2 * pr).sum(1)
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


def joint_p_nn(x: torch.Tensor, perplexity: float) -> JointP:
    """scikit-learn's ``_joint_probabilities_nn`` on x [N, D]'s k =
    min(N - 1, int(3 perplexity + 1)) nearest neighbours: the conditional P
    of each row, ``P + P^T`` on the union of the patterns, divided by its
    float64 sum (at least the float64 epsilon).  Values in x's compute
    type, on x's device."""
    n = x.shape[0]
    dt = _compute_dtype(x)
    k = min(n - 1, int(3.0 * perplexity + 1))
    d2, nbr = knn(x.to(dt), k)
    cond = conditional_p(d2.float().double(), perplexity).reshape(-1)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    cols = nbr.reshape(-1)
    # P + P^T: both directions of every neighbour pair, row-major; a pair in
    # both directions sums its two values (two terms: the same in any order)
    key, order = torch.sort(torch.cat([rows * n + cols, cols * n + rows]))
    key, where = torch.unique_consecutive(key, return_inverse=True)
    vals = torch.zeros(key.shape, dtype=cond.dtype, device=x.device)
    vals.index_add_(0, where, torch.cat([cond, cond])[order])
    keep = vals != 0
    key, vals = key[keep], vals[keep]
    vals = vals / vals.sum().clamp(min=_EPS64)
    rows = key // n
    return JointP(rows, key % n, vals.to(dt), torch.bincount(rows, minlength=n))


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


def _kl_and_grad(y: torch.Tensor, p: JointP, with_kl: bool):
    """The KL divergence of P and the Student-t Q of the float32 layout y
    over P's entries (when ``with_kl``, else None), and its gradient [N, 2]
    rounded to float32.  The attraction runs over P's entries in P's type;
    the repulsion and Z over all pairs (``tsne_repulsion``), Z summed in
    float64."""
    yc = y.to(p.vals.dtype)
    rep, z_rows = tsne_repulsion(yc)
    z = z_rows.sum(dtype=torch.float64)
    diff = yc[p.rows] - yc[p.cols]
    q = 1.0 / (1.0 + diff.square().sum(1))
    attract = torch.segment_reduce((p.vals * q)[:, None] * diff, "sum", lengths=p.counts, axis=0,
                                   unsafe=True)  # counts sum to the entries: no check, no sync
    grad = (attract - rep / z) * 4.0
    kl = None
    if with_kl:
        ratio = p.vals.clamp(min=_TINY32) / (q / z).clamp(min=_TINY32)
        kl = float((p.vals * torch.log(ratio)).sum(dtype=torch.float64))
    return kl, grad.float()


def _descend(y, p: JointP, start: int, stop: int, momentum: float, lr: float, patience: int):
    """One phase of scikit-learn's ``_gradient_descent`` -> (y, last KL, last
    iteration).  The layout, the gradient and the gains are float32, the
    update in P's type, as scikit-learn keeps them."""
    dt = p.vals.dtype
    update = torch.zeros_like(y, dtype=dt)
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
        update = momentum * update - lr * grad.to(dt)
        y = (y.to(dt) + update).float()
        if check:
            if kl < best:
                best, best_iter = kl, i
            elif i - best_iter > patience:
                break
            if float(torch.linalg.vector_norm(grad)) <= _MIN_GRAD_NORM:
                break
    return y, kl, i


def tsne(x: torch.Tensor, perplexity: float = 30.0) -> Tuple[torch.Tensor, float]:
    """t-SNE of x [N, D] (N >= 2, perplexity < N) -> (float32 layout [N, 2]
    on x's device, final KL divergence).  See the module docstring."""
    if x.ndim != 2:
        raise ValueError(f"tsne expects x [N, D], got {tuple(x.shape)}")
    n = x.shape[0]
    if n < 2 or perplexity >= n:
        raise ValueError(f"tsne needs N >= 2 and perplexity < N, got N = {n}, "
                         f"perplexity = {perplexity}")
    x = x.to(_compute_dtype(x))
    p = joint_p_nn(x, perplexity)
    y = pca_init(x)
    lr = max(n / _EXAGGERATION / 4.0, 50.0)
    y, kl, it = _descend(y, p.scaled(_EXAGGERATION), 0, _EXPLORATION_ITERS, 0.5, lr,
                         _EXPLORATION_ITERS)
    y, kl, _ = _descend(y, p, it + 1, _MAX_ITER, 0.8, lr, _PATIENCE)
    return y, kl


def trustworthiness(x: torch.Tensor, y: torch.Tensor) -> float:
    """scikit-learn's ``trustworthiness`` (euclidean, ``n_neighbors`` 5): how
    far the 5 nearest neighbours of each point in the layout y rank among
    its neighbours in x, 1 when they are its nearest there too.  O(N^2)
    memory, on x's device: for tests and checks on subsets."""
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
