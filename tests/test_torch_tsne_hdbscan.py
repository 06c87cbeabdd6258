"""The port's t-SNE (``utils/tsne.py``) and HDBSCAN (``utils/hdbscan.py``)
on the CPU against scikit-learn, which only the tests import.

HDBSCAN is held label for label to ``sklearn.cluster.HDBSCAN`` on seeded
data whose pairwise distances have no ties (continuous random draws), and
``hdbscan_clustering`` to the JAX package's test cases.

t-SNE is a non-convex descent whose trajectory amplifies any difference:
scikit-learn's own exact method, given its input scaled by (1 + 1e-7),
ends with a KL divergence up to 3.9 % away and coordinates several units
apart on the data below.  So the steps are held tightly (the joint P, the
PCA init, the KL divergence and gradient at a layout, the first iterations
of the descent) and the whole run by what it is for: the final KL within
5 % relative of scikit-learn's exact method, trustworthiness (n_neighbors
5) within 0.01 of it, and within 0.02 of the JAX package's Barnes-Hut
``perform_tsne``.
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
    got = thdb.hdbscan(x, mcs, ms)
    np.testing.assert_array_equal(got, want)


def test_hdbscan_float32_embeddings_equal_sklearn():
    """float32 input (the engines' embeddings), as both cluster it in float64."""
    from sklearn.cluster import HDBSCAN

    x = _blobs(7).astype(np.float32)
    want = HDBSCAN(min_cluster_size=5, min_samples=3, copy=True).fit(x).labels_
    np.testing.assert_array_equal(thdb.hdbscan(x, 5, 3), want)


def test_hdbscan_refuses_what_sklearn_refuses():
    with pytest.raises(ValueError, match="at least 2"):
        thdb.hdbscan(np.zeros((1, 3)), 2, 1)
    with pytest.raises(ValueError, match="min_samples"):
        thdb.hdbscan(np.random.RandomState(0).randn(4, 3), 2, 5)


def test_hdbscan_clustering_grid_and_tiny_classes():
    """The JAX package's test (tests/test_workloads.py:687): the grid finds
    the two blobs; a 3-point class clamps its knobs; 1- and 0-point classes
    are noise with no parameters."""
    rng = np.random.RandomState(0)
    blobs = np.vstack([rng.randn(30, 8) + 10.0, rng.randn(30, 8) - 10.0]).astype(np.float32)
    paths = [f"img_{i}.jpg" for i in range(60)]
    res = hdbscan_clustering(blobs, paths)
    assert res["n_clusters"] == 2
    assert sum(len(v) for v in res["clusters"].values()) == 60
    tiny = rng.randn(3, 8).astype(np.float32)
    res2 = hdbscan_clustering(tiny, paths[:3])
    assert sum(len(v) for v in res2["clusters"].values()) == 3
    res1 = hdbscan_clustering(tiny[:1], paths[:1])
    assert res1 == {"best_params": {"min_cluster_size": None, "min_samples": None},
                    "n_clusters": 0, "clusters": {"-1": paths[:1]}}
    res0 = hdbscan_clustering(tiny[:0], [])
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
    assert hdbscan_clustering(x, paths) == want


# -- t-SNE -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    """N = 200 seeded points in float64: four gaussian clusters in 8-D."""
    rng = np.random.RandomState(0)
    return np.concatenate([rng.randn(50, 8) + rng.randn(8) * 4 for _ in range(4)])


PERPLEXITY = 30.0  # perform_tsne's min(30, max(1, (n-1)/3)) at N = 200


def test_joint_p_equals_sklearn(data):
    from scipy.spatial.distance import squareform
    from sklearn.manifold._t_sne import _joint_probabilities
    from sklearn.metrics import pairwise_distances

    want = _joint_probabilities(pairwise_distances(data, squared=True), PERPLEXITY, 0)
    got = ttsne.joint_p(torch.from_numpy(data), PERPLEXITY).numpy()
    assert np.diag(got).max() == 0.0
    # scikit-learn rounds the distances to float32 before its search
    np.testing.assert_allclose(squareform(got, checks=False), want, rtol=1e-5,
                               atol=1e-6 * want.max())


def test_pca_init_equals_sklearn(data):
    from sklearn.decomposition import PCA

    want = PCA(n_components=2, random_state=42).fit_transform(data).astype(np.float32)
    want = want / np.std(want[:, 0]) * 1e-4
    got = ttsne.pca_init(torch.from_numpy(data))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_kl_and_gradient_equal_sklearn(data):
    from scipy.spatial.distance import squareform
    from sklearn.manifold._t_sne import _kl_divergence

    p = ttsne.joint_p(torch.from_numpy(data), PERPLEXITY)
    y = np.random.RandomState(1).randn(len(data), 2).astype(np.float32)
    kl, grad = _kl_divergence(y.ravel(), squareform(p.numpy(), checks=False), 1, len(data), 2)
    tkl, tgrad = ttsne._kl_and_grad(torch.from_numpy(y), p, True)
    assert abs(tkl - kl) <= 1e-9 * kl
    np.testing.assert_allclose(tgrad.numpy(), grad.reshape(-1, 2), rtol=1e-5,
                               atol=1e-6 * np.abs(grad).max())


@pytest.mark.parametrize("steps", [1, 3])
def test_first_iterations_equal_sklearn(data, steps):
    """The descent's first steps (exaggerated P, momentum 0.5, gains) from the
    same init, before the trajectory's amplification sets in."""
    from scipy.spatial.distance import squareform
    from sklearn.manifold._t_sne import _gradient_descent, _kl_divergence

    n = len(data)
    p = ttsne.joint_p(torch.from_numpy(data), PERPLEXITY)
    y0 = ttsne.pca_init(torch.from_numpy(data))
    lr = max(n / 12 / 4, 50.0)
    want, _, _ = _gradient_descent(
        _kl_divergence, y0.numpy().ravel().copy(), it=0, max_iter=steps, n_iter_check=50,
        n_iter_without_progress=250, momentum=0.5, learning_rate=np.maximum(lr, 50),
        min_gain=0.01, min_grad_norm=1e-7, verbose=0,
        args=[squareform(p.numpy(), checks=False) * 12.0, 1, n, 2],
        kwargs=dict(skip_num_points=0))
    got, _, _ = ttsne._descend(y0, p * 12.0, 0, steps, 0.5, lr, 250)
    want = want.reshape(n, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


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
    from sklearn.manifold import TSNE, trustworthiness

    sk = TSNE(method="exact", init="pca", random_state=42, perplexity=PERPLEXITY)
    want = sk.fit_transform(data)
    y, kl = port_layout
    assert y.shape == (len(data), 2) and y.dtype == torch.float32
    assert abs(kl - sk.kl_divergence_) <= TSNE_KL_REL * sk.kl_divergence_
    trust = ttsne.trustworthiness(torch.from_numpy(data), y)
    assert abs(trust - trustworthiness(data, want, n_neighbors=5)) <= TRUST_TOL
    print(f"t-SNE port vs scikit-learn exact: KL {kl:.5f} vs {sk.kl_divergence_:.5f}, "
          f"max coordinate distance {np.abs(y.numpy() - want).max():.3f} "
          f"(layout extent {np.abs(want).max():.1f})")


def test_tsne_trustworthiness_near_jax_barnes_hut(data, port_layout, tmp_path):
    from wadt.workloads.embed import perform_tsne as jtsne

    labels = np.repeat(np.arange(4), 50)
    jx2d, _ = jtsne(data, labels, ["a", "b", "c", "d"], None, str(tmp_path), "t")
    x = torch.from_numpy(data)
    jtrust = ttsne.trustworthiness(x, torch.from_numpy(np.asarray(jx2d, np.float64)))
    assert abs(ttsne.trustworthiness(x, port_layout[0]) - jtrust) <= BH_TRUST_TOL


def test_tsne_refuses_too_few_points():
    with pytest.raises(ValueError, match="perplexity"):
        ttsne.tsne(torch.zeros(1, 3), 1.0)
    with pytest.raises(ValueError, match="perplexity"):
        ttsne.tsne(torch.randn(5, 3, generator=torch.Generator().manual_seed(0)), 5.0)
