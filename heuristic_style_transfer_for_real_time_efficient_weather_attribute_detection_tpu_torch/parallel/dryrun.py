"""Multi-process dryrun of the sharded train step.

Counterpart of the JAX package's ``tools/dryrun_multihost.py``: 2
processes joined over gloo into one ``("data", "model")`` mesh of shape
(2, 1), each feeding only its half of the global batch through
``multihost.host_local_batch`` into the same train step the single-process
path uses (dropout on, as the JAX tool's default step has it).  It passes
when the 2-process run's per-step losses are within 1e-5 of a
single-process run on the same global data, the JAX tool's bar.  The
spec, tasks, data and step count are the JAX tool's.  It writes nothing.

Usage:  python -m <port>.parallel.dryrun [--device cuda|cpu]
(``cuda``, the default: both processes share the card over gloo, which,
unlike NCCL, takes two ranks on one GPU; without a card it raises, and
``--device cpu`` runs it on the CPU.)
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np

NUM_PROC = 2
GLOBAL_BATCH = 16
STEPS = 3
TOL = 1e-5
TINY = dict(
    ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
    transformer_layers=1, transformer_heads=2, norm="batch",
)
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}


def global_data():
    """The deterministic global batch; every participant makes it and
    slices its own rows (a real loader would read only its slice)."""
    from ..config import IGNORE_INDEX

    rng = np.random.RandomState(0)
    images = rng.randn(GLOBAL_BATCH, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 2, (GLOBAL_BATCH, 2)).astype(np.int32)
    labels[0, 0] = IGNORE_INDEX
    return images, labels


def _run_steps(step_fn, init_fn, images, labels) -> List[float]:
    state = init_fn(0)
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, images, labels)
        losses.append(float(loss))
    return losses


def _child(rank: int, device: str) -> List[float]:
    from ..models import pmg
    from .mesh import make_mesh
    from .multihost import host_local_batch
    from .train import make_train_step

    mesh = make_mesh(NUM_PROC, axes=("data", "model"), shape=(NUM_PROC, 1))
    init_fn, step_fn = make_train_step("pmg", pmg.build_spec(TASKS, TINY), mesh=mesh,
                                       device=device)
    images, labels = global_data()
    rows = GLOBAL_BATCH // NUM_PROC
    lo = rank * rows
    local = host_local_batch(mesh, images[lo: lo + rows], labels[lo: lo + rows])
    # each process handed over only its own rows; the step sees the global batch's shape
    assert local[0].total == GLOBAL_BATCH and local[0].lo == lo
    return _run_steps(step_fn, init_fn, *local)


def run(device: str = "cuda") -> Dict[str, object]:
    """The dryrun on ``device`` -> {"multi", "single", "max_diff"}; raises
    AssertionError above the 1e-5 bar, and RuntimeError for ``"cuda"``
    without a card."""
    import torch

    from ..models import pmg
    from .multihost import spawn_world
    from .train import make_train_step

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA device is available; pass --device cpu (device='cpu') "
                           "to run it on the CPU")

    multi = spawn_world(_child, NUM_PROC, device, backend="gloo")
    if any(m != multi[0] for m in multi):
        raise AssertionError(f"the ranks report different losses: {multi}")
    init_fn, step_fn = make_train_step("pmg", pmg.build_spec(TASKS, TINY), device=device)
    single = _run_steps(step_fn, init_fn, *global_data())
    worst = max(abs(a - b) for a, b in zip(multi[0], single))
    if not worst < TOL:
        raise AssertionError(f"multi-process losses {multi[0]} vs single {single}: max diff "
                             f"{worst:.3e} >= {TOL}")
    return {"multi": multi[0], "single": single, "max_diff": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (both ranks on one card; the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device)
    print(f"multi-process losses:  {res['multi']}")
    print(f"single-process losses: {res['single']}")
    print(f"dryrun: PASS ({NUM_PROC} processes over gloo on {args.device}, {STEPS} steps, "
          f"max loss diff {res['max_diff']:.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
