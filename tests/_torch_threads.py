"""One thread per worker for the port's test modules, which run long loops
of small CPU operations (the t-SNE's 1,000 descent steps, HDBSCAN, the
trunks at test sizes, their scikit-learn references).

The suite runs its files in parallel worker processes.  At torch's default
intra-op pool, one thread a core, each worker's loop of small operations
spins that many threads against every other worker's, and the loop takes
tens of times longer than alone; at one thread it runs as fast as alone and
gives the same numbers.  A module applies the fixture by importing it
(pytest puts ``tests/`` on the path of the modules it collects there; a
package named ``tests`` elsewhere on the path may shadow ``tests.``)::

    from _torch_threads import one_torch_thread  # noqa: F401

It holds torch to one intra-op thread, and the OpenMP and BLAS pools that
scikit-learn and numpy use to one thread, for the module, and restores
both when the module ends.
"""

import contextlib

import pytest
import torch

try:  # scikit-learn's dependency; the card's machine runs only the cuda tests and may lack both
    from threadpoolctl import threadpool_limits
except ImportError:
    threadpool_limits = None


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1) if threadpool_limits else contextlib.nullcontext():
            yield
    finally:
        torch.set_num_threads(before)
