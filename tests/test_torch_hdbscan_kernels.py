"""HDBSCAN's two kernels (``csrc/hdbscan.cu``: ``hdbscan_core_distances``
and ``hdbscan_prim_mst`` in ``ops/cuda_kernels.py``) on the card, against
their float64 plain versions, bit for bit.

The plain versions are held to scikit-learn on the CPU in
``tests/test_torch_tsne_hdbscan.py``, and the wrappers' CPU paths to the
plain versions in ``tests/test_torch_kernels.py``.  This file imports no
JAX, so that the card's machine runs it:
``python -m pytest tests/test_torch_hdbscan_kernels.py -q -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck


def hdbscan_points(n=300, d=7, seed=10):
    """Seeded float32 points in three clusters, the last 5 repeating the
    first 5 (distance-0 ties)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) + rng.randn(3, d)[rng.randint(0, 3, n)] * 4.0
    x[n - 5:] = x[:5]
    return torch.from_numpy(x.astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k", [(300, 1), (300, 5), (300, 10), (4099, 10),
                                 (300, ck.HDBSCAN_FAST_K + 1), (4099, 4099)])
def test_hdbscan_core_matches_plain_on_card(n, k, dtype, cuda_device):
    """Both paths of the core-distance kernel (insertion for k <= 32, radix
    select above, up to k = N) equal the float64 plain version bit for bit,
    at a ragged N, and twice."""
    x = hdbscan_points(n, 7).to(dtype).to(cuda_device)
    ck.reset_launches()
    got = ck.hdbscan_core_distances(x, k)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["hdbscan_core"] == 1
    assert torch.equal(got, ck.hdbscan_core_distances_plain(x, k))
    assert torch.equal(ck.hdbscan_core_distances(x, k), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,tied", [(300, 7, False), (1500, 48, False), (600, 3, True)])
def test_hdbscan_mst_matches_plain_on_card(n, d, tied, cuda_device):
    """The cooperative Prim's kernel equals the plain row-at-a-time MST
    edge for edge, bit for bit, with equal weights (data rounded to one
    decimal, repeated points) resolved to the lowest index, and twice."""
    x = hdbscan_points(n, d)
    if tied:
        x = torch.round(x * 10) / 10
    x = x.to(cuda_device)
    core = ck.hdbscan_core_distances_plain(x, 5)
    ck.reset_launches()
    got = ck.hdbscan_prim_mst(x, core)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["hdbscan_mst"] == 1
    assert torch.equal(got, ck.hdbscan_prim_mst_plain(x, core))
    assert torch.equal(ck.hdbscan_prim_mst(x, core), got)


@pytest.mark.cuda
def test_hdbscan_mst_threads_own_several_nodes_on_card(cuda_device):
    """With more points than the largest grid has threads, each thread of
    the MST kernel owns several nodes (its stride loop); the edges are still
    the plain version's, bit for bit, on tied data."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    grid = ck.HDBSCAN_MST_BLOCKS_PER_SM * sms * ck.HDBSCAN_MST_THREADS
    x = (torch.round(hdbscan_points(grid + grid // 32 + 1, 3) * 10) / 10).to(cuda_device)
    core = ck.hdbscan_core_distances(x, 5)
    got = ck.hdbscan_prim_mst(x, core)
    assert torch.equal(got, ck.hdbscan_prim_mst_plain(x, core))
