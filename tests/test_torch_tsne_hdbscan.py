"""The port's t-SNE (``utils/tsne.py``, its repulsion in
``ops/cuda_kernels.tsne_repulsion``) and HDBSCAN (``utils/hdbscan.py``) on
the CPU against scikit-learn, which only the tests import.

HDBSCAN runs here on the CPU (``device="cpu"``: the plain versions of its
two kernels).  It is held label for label to ``sklearn.cluster.HDBSCAN`` on
seeded data whose pairwise distances have no ties (continuous random
draws), and ``hdbscan_clustering`` to the JAX package's test cases.  Its
two quadratic steps are held bit for bit to scikit-learn's: the core
distances to ``NearestNeighbors(algorithm="kd_tree").kneighbors`` and the
MST to ``mst_from_data_matrix``, edge for edge, also on data full of ties.

The t-SNE computes the objective of scikit-learn's default Barnes-Hut
method, which the JAX package's ``perform_tsne`` calls, with the repulsion
summed exactly.  Its steps are held tightly: the nearest neighbours to
``kneighbors_graph``, the sparse joint P to ``_joint_probabilities_nn``, the
PCA init, the KL divergence and gradient at a layout and the first
iterations of the descent to ``_kl_divergence_bh(angle=0.0)``, where the
quadtree summarises nothing.  At the PCA init (std 1e-4) that quadtree still
merges points within 1e-6 of each other in every coordinate
(``EPSILON`` in ``sklearn/neighbors/_quad_tree.pyx``; 10 pairs of the data
below), so there the steps are held to scikit-learn's exact objective
``_kl_divergence`` on the same sparse P, which is the same sum with no tree.

t-SNE is a non-convex descent whose trajectory amplifies any difference:
scikit-learn's own exact method, given its input scaled by (1 + 1e-7),
ends with a KL divergence up to 3.9 % away and coordinates several units
apart on the data below.  So the whole run is held by what it is for: the
final KL within 5 % relative of ``TSNE(angle=0.0)`` and of the JAX
package's ``TSNE()`` call, trustworthiness (n_neighbors 5) within 0.01 of
them, and within 0.02 of the JAX package's ``perform_tsne`` layout.
"""

import warnings

import numpy as np
import pytest
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import hdbscan as thdb
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import tsne as ttsne
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads.embed import (
    hdbscan_clustering,
)
from _torch_threads import one_torch_thread  # noqa: F401

TSNE_KL_REL = 5e-2  # scikit-learn's own KL moves by up to 3.9 % under a 1e-7 input perturbation
TRUST_TOL = 0.01
BH_TRUST_TOL = 0.02


# -- HDBSCAN -----------------------------------------------------------------------


def _blobs(seed, noise_heavy=False):
    """Seeded gaussian blobs of random count, size, spread and dimension;
    with ``noise_heavy`` as many uniform points again.  Continuous draws:
    no two pairwise distances are equal."""
    rng = np.random.RandomState(seed)
    k, n, d = rng.randint(1, 6), rng.randint(20, 200), rng.randint(2, 12)
    centers = rng.randn(k, d) * rng.uniform(1, 8)
    x = centers[rng.randint(0, k, n)] + rng.randn(n, d) * rng.uniform(0.3, 2)
    if noise_heavy:
        x = np.concatenate([x, rng.uniform(-20, 20, (n, d))])
    return x


def _no_distance_ties(x):
    from scipy.spatial.distance import pdist

    d = np.sort(pdist(x))
    return (np.diff(d) > 0).all()


HDB_CASES = [(seed, noisy, mcs, ms) for seed, noisy in ((0, False), (1, False), (2, True), (3, True),
                                                        (4, False), (5, True))
             for mcs, ms in ((2, 1), (5, None), (10, 5), (15, 10))]


@pytest.mark.parametrize("seed,noisy,mcs,ms", HDB_CASES,
                         ids=[f"seed{s}-{'noisy' if n else 'blobs'}-mcs{m}-ms{k}"
                              for s, n, m, k in HDB_CASES])
def test_hdbscan_labels_equal_sklearn(seed, noisy, mcs, ms):
    from sklearn.cluster import HDBSCAN

    x = _blobs(seed, noisy)
    assert _no_distance_ties(x)
    want = HDBSCAN(min_cluster_size=mcs, min_samples=ms, copy=True).fit(x).labels_
    got = thdb.hdbscan(x, mcs, ms, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_hdbscan_float32_embeddings_equal_sklearn():
    """float32 input (the engines' embeddings), as both cluster it in float64."""
    from sklearn.cluster import HDBSCAN

    x = _blobs(7).astype(np.float32)
    want = HDBSCAN(min_cluster_size=5, min_samples=3, copy=True).fit(x).labels_
    np.testing.assert_array_equal(thdb.hdbscan(x, 5, 3, device="cpu"), want)


def test_hdbscan_refuses_what_sklearn_refuses():
    with pytest.raises(ValueError, match="at least 2"):
        thdb.hdbscan(np.zeros((1, 3)), 2, 1, device="cpu")
    with pytest.raises(ValueError, match="min_samples"):
        thdb.hdbscan(np.random.RandomState(0).randn(4, 3), 2, 5, device="cpu")


def test_hdbscan_clustering_grid_and_tiny_classes():
    """The JAX package's test (tests/test_workloads.py:687): the grid finds
    the two blobs; a 3-point class clamps its knobs; 1- and 0-point classes
    are noise with no parameters."""
    rng = np.random.RandomState(0)
    blobs = np.vstack([rng.randn(30, 8) + 10.0, rng.randn(30, 8) - 10.0]).astype(np.float32)
    paths = [f"img_{i}.jpg" for i in range(60)]
    res = hdbscan_clustering(blobs, paths, device="cpu")
    assert res["n_clusters"] == 2
    assert sum(len(v) for v in res["clusters"].values()) == 60
    tiny = rng.randn(3, 8).astype(np.float32)
    res2 = hdbscan_clustering(tiny, paths[:3], device="cpu")
    assert sum(len(v) for v in res2["clusters"].values()) == 3
    res1 = hdbscan_clustering(tiny[:1], paths[:1], device="cpu")
    assert res1 == {"best_params": {"min_cluster_size": None, "min_samples": None},
                    "n_clusters": 0, "clusters": {"-1": paths[:1]}}
    res0 = hdbscan_clustering(tiny[:0], [], device="cpu")
    assert res0["n_clusters"] == 0 and res0["clusters"] == {}


@pytest.mark.parametrize("n", [0, 1, 3, 60])
def test_hdbscan_clustering_equals_jax(n):
    from wadt.workloads.embed import hdbscan_clustering as jclustering

    rng = np.random.RandomState(1)
    x = np.vstack([rng.randn(30, 8) + 6.0, rng.randn(30, 8) - 6.0]).astype(np.float32)[:n]
    paths = [f"img_{i}.jpg" for i in range(n)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = jclustering(x, paths)
    assert hdbscan_clustering(x, paths, device="cpu") == want


def _tied_blobs(seed):
    """Three seeded 3-D blobs rounded to one decimal, with points repeated:
    many pairwise distances are equal, some are 0."""
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(150, 3) + rng.randn(3, 3)[rng.randint(0, 3, 150)] * 4, 1)
    dup = rng.randint(0, len(x), 12)
    return np.concatenate([x, x[dup], x[dup[:3]]])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 5, 10, "N"])
def test_core_distances_equal_sklearn_kneighbors(dtype, k):
    """(a) The plain core distances are ``kneighbors``' k-th distance bit for
    bit, the point itself counted (HDBSCAN queries the fitted points), on
    float32 and float64 points with duplicates."""
    from sklearn.neighbors import NearestNeighbors

    x = np.concatenate([_blobs(8), _blobs(8)[:7]]).astype(dtype)
    k = len(x) if k == "N" else k
    want = NearestNeighbors(n_neighbors=k, algorithm="kd_tree").fit(x).kneighbors(x, k)[0][:, -1]
    got = thdb.core_distances(torch.from_numpy(x), k)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tied", [False, True], ids=["tie-free", "rounded-with-duplicates"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mst_equals_sklearn_mst_from_data_matrix(tied, dtype):
    """(b) The plain MST is scikit-learn's ``mst_from_data_matrix`` field for
    field (source, node added, float64 weight), in its order: on tie-free
    blobs, and on blobs rounded to one decimal with repeated points, where
    the lowest index must win among equal candidates."""
    from sklearn.cluster._hdbscan._linkage import mst_from_data_matrix
    from sklearn.metrics import DistanceMetric
    from sklearn.neighbors import NearestNeighbors

    x = (_tied_blobs(9) if tied else _blobs(9)).astype(dtype)
    x64 = x.astype(np.float64)  # HDBSCAN widens its input before both steps
    core = np.ascontiguousarray(
        NearestNeighbors(n_neighbors=5, algorithm="kd_tree").fit(x64).kneighbors(x64, 5)[0][:, -1])
    want = mst_from_data_matrix(x64, core, DistanceMetric.get_metric("euclidean"), 1.0)
    if tied:
        assert np.unique(want["distance"]).size < 0.8 * want.size
    got = thdb.mutual_reachability_mst(torch.from_numpy(x), torch.from_numpy(core)).numpy()
    np.testing.assert_array_equal(got[:, 0], want["current_node"])
    np.testing.assert_array_equal(got[:, 1], want["next_node"])
    np.testing.assert_array_equal(got[:, 2], want["distance"])


def test_tied_labels_equal_sklearn():
    """On data full of distance ties the labels are still scikit-learn's."""
    from sklearn.cluster import HDBSCAN

    x = _tied_blobs(10)
    want = HDBSCAN(min_cluster_size=5, min_samples=4, copy=True).fit(x).labels_
    np.testing.assert_array_equal(thdb.hdbscan(x, 5, 4, device="cpu"), want)


def test_hdbscan_allocates_no_n_by_n_array(monkeypatch):
    """(c) With the plain core distances cut to blocks of 8 rows, no strided
    tensor of N^2 elements or more is made on the HDBSCAN path (every op's
    outputs are watched), and the numpy steps on the host allocate less
    than one N x N float64 matrix at their peak."""
    import tracemalloc

    from torch.utils._python_dispatch import TorchDispatchMode

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    x = np.random.RandomState(11).randn(300, 3)
    x[:150] += 6.0
    n = x.shape[0]
    monkeypatch.setattr(ck, "_HDBSCAN_CHUNK", 8 * n)
    largest = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.layout == torch.strided:
                    largest.append(t.numel())
            return out

    with Watch():
        hierarchy = thdb.linkage_tree(thdb.points(x, "cpu"), 5)
    assert max(largest) < n * n
    tracemalloc.start()
    try:
        labels = thdb.tree_labels(hierarchy, 10)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 8 * n * n
    from sklearn.cluster import HDBSCAN

    np.testing.assert_array_equal(labels, HDBSCAN(min_cluster_size=10, min_samples=5).fit(x).labels_)


def test_hdbscan_clustering_builds_one_tree_per_min_samples(monkeypatch):
    """(d) The grid's six parameterizations build one MST per distinct
    clamped ``min_samples`` (2 here; 1 for a class of 3 points), and the
    result is still the JAX package's."""
    from wadt.workloads.embed import hdbscan_clustering as jclustering

    calls = []
    mst = thdb.mutual_reachability_mst

    def counted(x, core):
        calls.append(x.shape[0])
        return mst(x, core)

    monkeypatch.setattr(thdb, "mutual_reachability_mst", counted)
    rng = np.random.RandomState(2)
    x = np.vstack([rng.randn(40, 6) + 5.0, rng.randn(40, 6) - 5.0, rng.randn(10, 6) * 8]).astype(np.float32)
    paths = [f"img_{i}.jpg" for i in range(len(x))]
    got = hdbscan_clustering(x, paths, device="cpu")
    assert calls == [len(x)] * 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        assert got == jclustering(x, paths)
    calls.clear()
    hdbscan_clustering(x[:3], paths[:3], device="cpu")
    assert calls == [3]


def test_hdbscan_on_cuda_without_a_card_raises():
    """(e) The default device is the card; without one it raises, as
    ``perform_tsne`` does, and names the way to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    x = _blobs(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thdb.hdbscan(x, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hdbscan_clustering(x, [str(i) for i in range(len(x))])


# -- t-SNE -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    """N = 200 seeded points in float64: four gaussian clusters in 8-D."""
    rng = np.random.RandomState(0)
    return np.concatenate([rng.randn(50, 8) + rng.randn(8) * 4 for _ in range(4)])


PERPLEXITY = 30.0  # perform_tsne's min(30, max(1, (n-1)/3)) at N = 200


def _sk_joint_p(x, perplexity):
    """scikit-learn's sparse P as ``TSNE._fit`` builds it for Barnes-Hut:
    the kNN graph's distances squared, then ``_joint_probabilities_nn``."""
    from sklearn.manifold._t_sne import _joint_probabilities_nn
    from sklearn.neighbors import NearestNeighbors

    k = min(len(x) - 1, int(3.0 * perplexity + 1))
    graph = NearestNeighbors(algorithm="auto", n_neighbors=k).fit(x).kneighbors_graph(mode="distance")
    graph.data **= 2
    return _joint_probabilities_nn(graph, perplexity, 0)


def _csr(p, n):
    from scipy.sparse import csr_array

    return csr_array((p.vals.numpy(), (p.rows.numpy(), p.cols.numpy())), shape=(n, n))


def _assert_same_p(got, want, n):
    """Same pattern, values within 1e-6 x max P (scikit-learn's distances
    come from its tree's square roots squared again)."""
    g = _csr(got, n)
    assert (got.rows != got.cols).all()
    assert np.array_equal(g.toarray() != 0, want.toarray() != 0)
    np.testing.assert_allclose(g.toarray(), want.toarray(), rtol=0, atol=1e-6 * want.max())


def test_joint_p_equals_sklearn(data):
    want = _sk_joint_p(data, PERPLEXITY)
    got = ttsne.joint_p_nn(torch.from_numpy(data), PERPLEXITY)
    assert got.vals.dtype == torch.float64 and got.rows.shape == got.cols.shape == got.vals.shape
    _assert_same_p(got, want, len(data))
    print(f"joint P vs _joint_probabilities_nn: {want.nnz} entries each, max abs diff "
          f"{np.abs(_csr(got, len(data)).toarray() - want.toarray()).max() / want.max():.2e} x max P")
    # symmetric, and row-major as scipy's CSR keeps it, with each row's
    # count of entries (the attraction's segmented sum reads them in order)
    key = got.rows * len(data) + got.cols
    assert (key[1:] > key[:-1]).all()
    np.testing.assert_array_equal(got.counts.numpy(), np.diff(_csr(got, len(data)).indptr))
    dense = _csr(got, len(data)).toarray()
    np.testing.assert_array_equal(dense, dense.T)


@pytest.mark.parametrize("n", [2, 4, 10])
def test_joint_p_nn_tiny_n_equals_sklearn(n):
    """perform_tsne's perplexity at tiny N gives k = N - 1 neighbours."""
    x = np.random.RandomState(n).randn(n, 3)
    perplexity = min(30.0, max(1.0, (n - 1) / 3.0))
    assert min(n - 1, int(3.0 * perplexity + 1)) == n - 1
    _assert_same_p(ttsne.joint_p_nn(torch.from_numpy(x), perplexity), _sk_joint_p(x, perplexity), n)


def test_knn_with_duplicates_equals_sklearn(monkeypatch):
    """Exact neighbours over row chunks; the point itself is left out by
    index, so its duplicates stay neighbours at distance 0 (seeded data
    with three duplicated points).  Each row's distances equal scikit-learn's;
    its neighbours too where the k-th and (k+1)-th distances differ, and
    where a duplicated pair ties there, each neighbour is within the k-th
    distance."""
    from sklearn.neighbors import NearestNeighbors

    rng = np.random.RandomState(3)
    x = rng.randn(60, 5)
    x[[7, 21, 40]] = x[[3, 3, 12]]
    k = 6
    graph = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(mode="distance")
    want_idx = graph.indices.reshape(-1, k)
    want_d2 = np.sort(graph.data.reshape(-1, k) ** 2, 1)
    monkeypatch.setattr(ttsne, "_CHUNK", 7 * len(x))  # 7 rows a chunk: 9 chunks
    d2, idx = ttsne.knn(torch.from_numpy(x), k)
    d2, idx = d2.numpy(), idx.numpy()
    assert (np.diff(d2, axis=1) >= 0).all()  # nearest first
    np.testing.assert_allclose(d2, want_d2, rtol=1e-12, atol=1e-12)
    full = ttsne.squared_distances(torch.from_numpy(x)).numpy()
    np.fill_diagonal(full, np.inf)
    kth = np.sort(full, 1)
    untied = kth[:, k - 1] < kth[:, k]
    assert untied.sum() >= len(x) - 6
    assert (np.sort(idx[untied], 1) == np.sort(want_idx[untied], 1)).all()
    assert (np.take_along_axis(full, idx, 1) <= kth[:, k - 1:k]).all()
    for a, b in ((3, 7), (3, 21), (7, 21), (12, 40)):
        assert b in idx[a] and a in idx[b] and full[a, b] == 0.0
    assert all(i not in idx[i] for i in range(len(x)))
    with pytest.raises(ValueError, match="0 < k < N"):
        ttsne.knn(torch.from_numpy(x), len(x))


def _brute_repulsion(y):
    """float64 brute force of rep_i = sum_{j != i} q^2 (y_i - y_j) and
    z_i = sum_{j != i} q, q = 1 / (1 + |y_i - y_j|^2), j = i left out by index."""
    y = np.asarray(y, np.float64)
    d = y[:, None, :] - y[None, :, :]
    q = 1.0 / (1.0 + (d ** 2).sum(-1))
    np.fill_diagonal(q, 0.0)
    return ((q ** 2)[..., None] * d).sum(1), q.sum(1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tsne_repulsion_plain_equals_float64_formula(dtype, monkeypatch):
    """The plain repulsion over row chunks (5 rows a chunk here) against a
    float64 brute force, with duplicated points (they repel with q = 1 in z
    and add nothing to rep) and a layout of std 10: float64 to 1e-12 x max,
    float32 to 1e-5 x max."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    rng = np.random.RandomState(8)
    y = rng.randn(53, 2) * 10.0
    y[[4, 30, 31]] = y[[9, 9, 9]]
    monkeypatch.setattr(ck, "_REPULSION_CHUNK", 5 * len(y))
    rep, z = ck.tsne_repulsion_plain(torch.from_numpy(y).to(dtype))
    assert rep.dtype == z.dtype == dtype and rep.shape == (53, 2) and z.shape == (53,)
    want_rep, want_z = _brute_repulsion(torch.from_numpy(y).to(dtype).double().numpy())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(rep.double().numpy(), want_rep, rtol=0, atol=tol * np.abs(want_rep).max())
    np.testing.assert_allclose(z.double().numpy(), want_z, rtol=tol, atol=0)
    assert (z.double().numpy()[[4, 9, 30, 31]] >= 3.0).all()  # three duplicates at q = 1 each
    one_rep, one_z = ck.tsne_repulsion_plain(torch.zeros(1, 2, dtype=dtype))
    assert float(one_rep.abs().sum()) == float(one_z.sum()) == 0.0


def test_pca_init_equals_sklearn(data):
    from sklearn.decomposition import PCA

    want = PCA(n_components=2, random_state=42).fit_transform(data).astype(np.float32)
    want = want / np.std(want[:, 0]) * 1e-4
    got = ttsne.pca_init(torch.from_numpy(data))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def _layouts(data):
    """The PCA init, and a seeded layout of std 10."""
    return {"pca_init": ttsne.pca_init(torch.from_numpy(data)),
            "std10": torch.from_numpy((np.random.RandomState(1).randn(len(data), 2) * 10.0)
                                      .astype(np.float32))}


def _sk_objective(layout, p, n, exaggeration=1.0):
    """scikit-learn's objective and its P for a layout: at std 10
    ``_kl_divergence_bh(angle=0.0)``; at the PCA init the exact
    ``_kl_divergence`` on the same sparse P (its quadtree merges points
    within 1e-6 there, see the module docstring)."""
    from scipy.spatial.distance import squareform
    from sklearn.manifold._t_sne import _kl_divergence, _kl_divergence_bh

    pc = _csr(p, n) * exaggeration
    if layout == "std10":
        return _kl_divergence_bh, pc, dict(skip_num_points=0, angle=0.0)
    return _kl_divergence, squareform(pc.toarray(), checks=False), dict(skip_num_points=0)


def test_kl_and_gradient_equal_sklearn(data):
    """At the PCA init against the exact ``_kl_divergence`` on the same P,
    the KL divergence within 1e-9 relative; at a seeded layout of std 10
    against ``_kl_divergence_bh(angle=0.0)``, within 1e-5 relative (its
    float32 sums).  The gradient within 1e-5 relative at both (elementwise,
    plus 1e-6 x max near zero)."""
    from sklearn.manifold._t_sne import _kl_divergence_bh

    n = len(data)
    p = ttsne.joint_p_nn(torch.from_numpy(data), PERPLEXITY)
    for layout, y in _layouts(data).items():
        objective, pc, kw = _sk_objective(layout, p, n)
        kl, grad = objective(y.numpy().ravel().copy(), pc, 1, n, 2, **kw)
        tkl, tgrad = ttsne._kl_and_grad(y, p, True)
        assert tgrad.dtype == torch.float32
        grad = grad.reshape(-1, 2)
        print(f"{layout} vs {objective.__name__}: KL rel {abs(tkl - kl) / kl:.2e}, gradient rel "
              f"{np.linalg.norm(tgrad.numpy() - grad) / np.linalg.norm(grad):.2e}")
        assert abs(tkl - kl) <= {"pca_init": 1e-9, "std10": 1e-5}[layout] * kl, layout
        np.testing.assert_allclose(tgrad.numpy(), grad, rtol=1e-5,
                                   atol=1e-6 * np.abs(grad).max(), err_msg=layout)
    # what the quadtree's merge does at the init (printed, not held)
    y = _layouts(data)["pca_init"].numpy()
    close = (np.abs(y[:, None] - y[None]) <= 1e-6).all(-1)
    bkl, bgrad = _kl_divergence_bh(y.ravel().copy(), _csr(p, n), 1, n, 2, angle=0.0)
    tkl, tgrad = ttsne._kl_and_grad(torch.from_numpy(y), p, True)
    print(f"pca_init: {(close.sum() - n) // 2} pairs within 1e-6 in every coordinate; "
          f"_kl_divergence_bh(angle=0.0) from the exact sum: KL rel {abs(tkl - bkl) / tkl:.2e}, gradient "
          f"rel {np.linalg.norm(tgrad.numpy().ravel() - bgrad) / np.linalg.norm(tgrad.numpy()):.2e}")


@pytest.mark.parametrize("steps", [1, 3])
def test_first_iterations_equal_sklearn(data, steps):
    """The descent's first steps (exaggerated P, momentum 0.5, gains) from
    the PCA init and from a layout of std 10, before the trajectory's
    amplification sets in."""
    from sklearn.manifold._t_sne import _gradient_descent

    n = len(data)
    p = ttsne.joint_p_nn(torch.from_numpy(data), PERPLEXITY)
    lr = max(n / 12 / 4, 50.0)
    for layout, y0 in _layouts(data).items():
        objective, pc, kw = _sk_objective(layout, p, n, 12.0)
        want, _, _ = _gradient_descent(
            objective, y0.numpy().ravel().copy(), it=0, max_iter=steps, n_iter_check=50,
            n_iter_without_progress=250, momentum=0.5, learning_rate=np.maximum(lr, 50),
            min_gain=0.01, min_grad_norm=1e-7, verbose=0, args=[pc, 1, n, 2], kwargs=kw)
        got, _, _ = ttsne._descend(y0, p.scaled(12.0), 0, steps, 0.5, lr, 250)
        want = want.reshape(n, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                   err_msg=layout)


def test_trustworthiness_equals_sklearn(data):
    from sklearn.manifold import trustworthiness

    y = np.random.RandomState(2).randn(len(data), 2)
    got = ttsne.trustworthiness(torch.from_numpy(data), torch.from_numpy(y))
    assert got == pytest.approx(trustworthiness(data, y, n_neighbors=5), abs=1e-12)
    with pytest.raises(ValueError, match="n_neighbors"):
        ttsne.trustworthiness(torch.from_numpy(data[:8]), torch.from_numpy(y[:8]))


@pytest.fixture(scope="module")
def port_layout(data):
    return ttsne.tsne(torch.from_numpy(data), PERPLEXITY)


def test_tsne_matches_sklearn_exact(data, port_layout):
    """The final KL within 5 % of ``TSNE(angle=0.0)`` (the same objective)
    and of ``TSNE()`` as the JAX package's ``perform_tsne`` calls it;
    trustworthiness within 0.01 of both."""
    from sklearn.manifold import TSNE, trustworthiness

    y, kl = port_layout
    assert y.shape == (len(data), 2) and y.dtype == torch.float32
    trust = ttsne.trustworthiness(torch.from_numpy(data), y)
    for name, sk in (("angle 0", TSNE(angle=0.0, random_state=42, perplexity=PERPLEXITY)),
                     ("JAX call", TSNE(n_components=2, random_state=42, perplexity=PERPLEXITY))):
        want = sk.fit_transform(data)
        sk_trust = trustworthiness(data, want, n_neighbors=5)
        print(f"t-SNE port vs scikit-learn {name}: KL {kl:.5f} vs {sk.kl_divergence_:.5f}, "
              f"trustworthiness {trust:.5f} vs {sk_trust:.5f}")
        assert abs(kl - sk.kl_divergence_) <= TSNE_KL_REL * sk.kl_divergence_, name
        assert abs(trust - sk_trust) <= TRUST_TOL, name


def test_tsne_trustworthiness_near_jax_barnes_hut(data, port_layout, tmp_path):
    from wadt.workloads.embed import perform_tsne as jtsne

    labels = np.repeat(np.arange(4), 50)
    jx2d, _ = jtsne(data, labels, ["a", "b", "c", "d"], None, str(tmp_path), "t")
    x = torch.from_numpy(data)
    jtrust = ttsne.trustworthiness(x, torch.from_numpy(np.asarray(jx2d, np.float64)))
    assert abs(ttsne.trustworthiness(x, port_layout[0]) - jtrust) <= BH_TRUST_TOL


def test_tsne_allocates_no_n_by_n_tensor(monkeypatch):
    """With the distance and repulsion blocks cut to 8 rows, no strided
    tensor of N^2 elements or more is made anywhere on the t-SNE's path
    (every op's outputs are watched), and P holds at most 2 N k entries."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    n, perplexity = 160, 10.0  # 4 N k < N^2: the [entries, 2] tensors stay under N^2
    x = torch.from_numpy(np.random.RandomState(5).randn(n, 6))
    monkeypatch.setattr(ttsne, "_CHUNK", 8 * n)
    monkeypatch.setattr(ck, "_REPULSION_CHUNK", 8 * n)
    monkeypatch.setattr(ttsne, "_MAX_ITER", 300)
    largest = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.layout == torch.strided:
                    largest.append(t.numel())
            return out

    with Watch():
        y, kl = ttsne.tsne(x, perplexity)
    assert y.shape == (n, 2) and np.isfinite(kl)
    assert max(largest) < n * n
    p = ttsne.joint_p_nn(x, perplexity)
    assert p.vals.numel() <= 2 * n * int(3 * perplexity + 1)


def test_tsne_refuses_too_few_points():
    with pytest.raises(ValueError, match="perplexity"):
        ttsne.tsne(torch.zeros(1, 3), 1.0)
    with pytest.raises(ValueError, match="perplexity"):
        ttsne.tsne(torch.randn(5, 3, generator=torch.Generator().manual_seed(0)), 5.0)
