"""HDBSCAN: core distances and the minimum spanning tree on the points'
device (float64), the tree's O(N) steps in numpy on the host.

:func:`hdbscan` computes what ``sklearn.cluster.HDBSCAN(min_cluster_size,
min_samples)`` computes with every other option at its default (euclidean
metric, alpha 1, excess-of-mass selection, ``allow_single_cluster=False``,
``cluster_selection_epsilon=0``), step for step as scikit-learn 1.9 does
it, so that the labels are scikit-learn's, label for label:

1. the core distance of each point: its distance to its ``min_samples``-th
   nearest neighbour, counting the point itself
   (``ops.cuda_kernels.hdbscan_core_distances``);
2. Prim's minimum spanning tree of the mutual reachability graph
   ``max(core_i, core_j, d_ij)``, grown from point 0 with one row of
   distances recomputed a step, with scikit-learn's choice among equal
   candidates (the lowest index) and its edge order
   (``ops.cuda_kernels.hdbscan_prim_mst``); every distance is summed in
   float64 in dimension order, as scikit-learn's ``mst_from_data_matrix``
   sums it, so the edges are its edges bit for bit, ties included;
3. the single-linkage tree of the edges sorted by weight (``np.argsort``,
   as scikit-learn sorts them), in scipy's format;
4. the tree condensed at ``min_cluster_size`` (a split whose sides both
   hold ``min_cluster_size`` points makes two clusters; smaller sides fall
   out as points at that lambda = 1 / distance), and each cluster's
   stability, the sum over its points and child clusters of (lambda at
   which they leave - lambda at which the cluster was born) x size;
5. excess of mass without the root: walking the clusters from the last
   born up, a cluster whose children's summed stability beats its own
   passes that sum up, else it is selected and its descendants are not;
6. labels: each point takes the number of the selected cluster it lies
   under, the selected clusters numbered in their sorted order; -1 (noise)
   elsewhere.

Steps 1 and 2 run where the points are: on the card the two kernels of
``csrc/hdbscan.cu``, on the CPU their plain versions.  Memory is O(N D):
no [N, N] distance matrix is built anywhere; time is O(N^2 D) on the
device and O(N) numpy work on the host after the edges come back.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_kernels as ck


def points(x, device="cuda") -> torch.Tensor:
    """x [N, D] (an array or a tensor) as a contiguous float32 or float64
    tensor on ``device`` (other types are widened to float64).  ``"cuda"``
    raises when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hdbscan: no CUDA device is available; pass device='cpu'")
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype not in (torch.float32, torch.float64):
        t = t.double()
    return t.to(dev).contiguous()


def core_distances(x: torch.Tensor, min_samples: int) -> torch.Tensor:
    """Each point's ``min_samples``-th smallest distance, its own 0 counted,
    -> float64 [N] on x's device."""
    return ck.hdbscan_core_distances(x, min_samples)


def mutual_reachability_mst(x: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Prim's MST of the mutual reachability graph -> [N - 1, 3] float64 rows
    of (node in the tree, node added, weight) on x's device, in the order
    scikit-learn's ``mst_from_data_matrix`` adds them."""
    return ck.hdbscan_prim_mst(x, core)


def linkage_tree(x: torch.Tensor, min_samples: int) -> np.ndarray:
    """The single-linkage tree of x's mutual reachability MST at
    ``min_samples``: core distances and MST on x's device, then the
    [N - 1, 3] edges on the host."""
    edges = mutual_reachability_mst(x, core_distances(x, min_samples))
    return single_linkage(edges.cpu().numpy())


def single_linkage(edges: np.ndarray) -> np.ndarray:
    """MST edges -> scipy-format linkage [N - 1, 4]: (left cluster, right
    cluster, distance, size), clusters numbered N, N + 1, ... as they form."""
    edges = edges[np.argsort(edges[:, 2])]
    n = edges.shape[0] + 1
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
    out = np.empty((n - 1, 4))

    def find(x: int) -> int:
        root = x
        while parent[root] != -1:
            root = parent[root]
        while parent[x] != -1 and parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, (a, b, dist) in enumerate(edges):
        left, right = find(int(a)), find(int(b))
        out[i] = (left, right, dist, size[left] + size[right])
        parent[left] = parent[right] = n + i
        size[n + i] = size[left] + size[right]
    return out


def _bfs(hierarchy: np.ndarray, root: int) -> List[int]:
    """Nodes under ``root`` in breadth-first order, left before right."""
    n = hierarchy.shape[0] + 1
    out, queue = [], [root]
    while queue:
        out.extend(queue)
        queue = [int(c) for x in queue if x >= n for c in hierarchy[x - n, :2]]
    return out


def condense_tree(hierarchy: np.ndarray, min_cluster_size: int) -> List[Tuple[int, int, float, int]]:
    """The condensed tree: rows (parent cluster, child cluster or point,
    lambda, size); clusters are numbered from N (the root) in the order
    scikit-learn's ``_condense_tree`` labels them."""
    n = hierarchy.shape[0] + 1
    root = 2 * (n - 1)
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    next_label = n + 1
    ignore = np.zeros(root + 1, bool)
    rows: List[Tuple[int, int, float, int]] = []

    def count(node: int) -> int:
        return int(hierarchy[node - n, 3]) if node >= n else 1

    def fall_out(parent: int, sub: int, lam: float) -> None:
        for s in _bfs(hierarchy, sub):
            if s < n:
                rows.append((parent, s, lam, 1))
            ignore[s] = True

    for node in _bfs(hierarchy, root):
        if ignore[node] or node < n:
            continue
        left, right, dist, _ = hierarchy[node - n]
        left, right = int(left), int(right)
        lam = 1.0 / dist if dist > 0.0 else np.inf
        lc, rc = count(left), count(right)
        if lc >= min_cluster_size and rc >= min_cluster_size:
            relabel[left] = next_label
            rows.append((int(relabel[node]), next_label, lam, lc))
            relabel[right] = next_label + 1
            rows.append((int(relabel[node]), next_label + 1, lam, rc))
            next_label += 2
        elif lc < min_cluster_size and rc < min_cluster_size:
            fall_out(int(relabel[node]), left, lam)
            fall_out(int(relabel[node]), right, lam)
        elif lc < min_cluster_size:
            relabel[right] = relabel[node]
            fall_out(int(relabel[node]), left, lam)
        else:
            relabel[left] = relabel[node]
            fall_out(int(relabel[node]), right, lam)
    return rows


def stabilities(rows) -> Dict[int, float]:
    """{cluster: stability}: sum of (lambda - birth lambda of the parent) x size."""
    births: Dict[int, float] = {c: lam for _, c, lam, _ in rows}
    root = min(p for p, _, _, _ in rows)
    births[root] = 0.0
    stab = {c: 0.0 for c in range(root, max(p for p, _, _, _ in rows) + 1)}
    for p, _, lam, size in rows:
        stab[p] += (lam - births[p]) * size
    return stab


def select_eom(rows, stab: Dict[int, float]) -> List[int]:
    """Excess-of-mass selection without the root -> the selected clusters, sorted."""
    stab = dict(stab)
    nodes = sorted(stab, reverse=True)[:-1]  # children before parents, the root left out
    children: Dict[int, List[int]] = {}
    for p, c, _, size in rows:
        if size > 1:
            children.setdefault(p, []).append(c)
    is_cluster = {c: True for c in nodes}
    for node in nodes:
        sub = sum(stab[c] for c in children.get(node, ()))
        if sub > stab[node]:
            is_cluster[node] = False
            stab[node] = sub
        else:
            queue = deque(children.get(node, ()))
            while queue:
                c = queue.popleft()
                is_cluster[c] = False
                queue.extend(children.get(c, ()))
    return sorted(c for c, keep in is_cluster.items() if keep)


def label_points(rows, selected: List[int], n: int) -> np.ndarray:
    """Each point's selected ancestor's number in ``selected``, or -1."""
    number = {c: i for i, c in enumerate(selected)}
    parent_of = {c: p for p, c, _, _ in rows}
    labels = np.full(n, -1, np.intp)
    for point in range(n):
        node = point
        while node in parent_of:
            node = parent_of[node]
            if node in number:
                labels[point] = number[node]
                break
    return labels


def tree_labels(hierarchy: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """Labels from a single-linkage tree: condensed at ``min_cluster_size``,
    clusters selected by excess of mass."""
    rows = condense_tree(hierarchy, min_cluster_size)
    return label_points(rows, select_eom(rows, stabilities(rows)), hierarchy.shape[0] + 1)


def hdbscan(x, min_cluster_size: int = 5, min_samples: Optional[int] = None,
            device="cuda") -> np.ndarray:
    """HDBSCAN labels of x [N, D] (N >= 2): cluster numbers from 0, -1 for
    noise.  ``min_samples`` defaults to ``min_cluster_size``, as in
    scikit-learn.  Steps 1 and 2 run on ``device`` (default the CUDA card,
    which raises when there is none; ``"cpu"`` for the CPU).  See the
    module docstring."""
    x = points(x, device)
    n = x.shape[0]
    if n < 2:
        raise ValueError(f"HDBSCAN needs at least 2 samples, got {n}")
    ms = min_cluster_size if min_samples is None else min_samples
    if ms > n:
        raise ValueError(f"min_samples ({ms}) must be at most the number of samples ({n})")
    return tree_labels(linkage_tree(x, ms), min_cluster_size)
