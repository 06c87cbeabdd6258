"""The t-SNE's all-pairs repulsion kernel (``csrc/tsne_repulsion.cu``,
``ops/cuda_kernels.tsne_repulsion``) on the card.

Its plain version is held to a float64 brute force on the CPU in
``tests/test_torch_tsne_hdbscan.py``, and the wrapper's CPU path to the
plain version in ``tests/test_torch_kernels.py``.  This file imports no
JAX, so that the card's machine runs it:
``python -m pytest tests/test_torch_tsne_repulsion.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("std", [1e-4, 10.0])
def test_tsne_repulsion_matches_float64_plain_on_card(std, cuda_device):
    """A ragged N (a partial last tile) with duplicated points, at the PCA
    init's scale and at std 10: rep within 1e-4 x max|rep| and each z_i
    within 1e-5 relative of the plain version in float64; one launch; two
    calls bit-identical (no atomics)."""
    rng = np.random.RandomState(10)
    y = rng.randn(4099, 2) * std
    y[[5, 700, 4098]] = y[[3000, 3000, 3000]]
    y = torch.from_numpy(y.astype(np.float32)).to(cuda_device)
    ck.reset_launches()
    rep, z = ck.tsne_repulsion(y)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["tsne_repulsion"] == 1
    want_rep, want_z = ck.tsne_repulsion_plain(y.double())
    torch.testing.assert_close(rep.double(), want_rep, atol=1e-4 * float(want_rep.abs().max()), rtol=0)
    torch.testing.assert_close(z.double(), want_z, atol=0, rtol=1e-5)
    rep2, z2 = ck.tsne_repulsion(y)
    assert torch.equal(rep, rep2) and torch.equal(z, z2)


@pytest.mark.cuda
def test_tsne_repulsion_refuses_what_the_kernel_does_not_take(cuda_device):
    """float32 [N, 2] only; a float64 or [N, 3] layout raises, launching nothing."""
    ck.reset_launches()
    with pytest.raises(ValueError, match="float32"):
        ck.tsne_repulsion(torch.zeros(8, 2, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        ck.tsne_repulsion(torch.zeros(8, 3, device=cuda_device))
    assert ck.LAUNCHES["tsne_repulsion"] == 0
