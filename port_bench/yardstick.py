"""The benchmark's fixed arithmetic: the published peaks of one H100, the
least time of a kernel from its bytes and operations, the seeds of each
stream of inputs, and the gaps that decide ``correct``."""

from __future__ import annotations

import statistics
import zlib
from typing import Dict, Iterable, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """Least time in seconds: bytes over the HBM rate or operations over
    the peak of ``dtype``, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype])


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run's inputs (weights,
    frames, labels, order), from the run's ``--seed`` of any size."""
    ss = np.random.SeedSequence([int(seed) % (1 << 128), zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Iterable[str]) -> Tuple[float, str]:
    """(gap, leaf): the largest ``|prog - ref|`` of a leaf's norm over the
    larger of the reference's norm of that leaf and of the median leaf."""
    keep = list(keep)
    med = statistics.median(ref[k] for k in keep)
    return max(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k) for k in keep))
