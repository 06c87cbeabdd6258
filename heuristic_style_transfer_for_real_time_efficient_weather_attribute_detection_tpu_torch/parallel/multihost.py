"""Multi-process data feeding for the sharded train step.

Counterpart of the JAX package's ``parallel/multihost.py``.  Each process
joins the ``torch.distributed`` world (:func:`initialize_process`) and owns
one device; a host pipeline may load only its own rows of the global batch
and hand them to the step through :func:`host_local_batch`.  The step
function itself is unchanged: given a global batch it slices its own rows,
given a host-local batch it slices nothing.

Proven by ``python -m <port>.parallel.dryrun``: 2 processes over gloo, each
feeding its half of the global batch, reproduce the single-process losses
within 1e-5.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch.distributed as dist

from .mesh import HostLocal, Mesh


def initialize_process(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_devices: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> None:
    """Join the world as rank ``process_id`` of ``num_processes``.

    ``coordinator`` is ``host:port`` (a TCP rendezvous at rank 0's address)
    or a ``file://`` path every process can reach.  ``backend`` defaults to
    NCCL where CUDA is available and gloo otherwise; pass "gloo" for CPU
    processes, or for several processes sharing one card (NCCL refuses two
    ranks on one GPU).  ``local_devices`` is accepted for the JAX
    signature; one process owns one device, so it must be None or 1.
    ``timeout_s`` bounds every collective: a rank that never arrives fails
    the others instead of hanging them.
    """
    import torch

    if local_devices not in (None, 1):
        raise ValueError(f"local_devices={local_devices}: one process owns one device here; "
                         "start one process per device")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init, world_size=int(num_processes),
                            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))


def host_local_batch(mesh: Mesh, *arrays) -> Tuple[HostLocal, ...]:
    """Mark each array as this process's rows of a global batch.

    Each array holds this rank's contiguous rows: the global batch has
    ``len(array) * mesh.axis_size("data")`` rows and this rank's start at
    ``mesh.index("data") * len(array)``.  The train step takes the marked
    arrays where it takes a global batch.
    """
    n_data = mesh.axis_size("data")
    i = mesh.index("data")
    return tuple(HostLocal(a, i * len(a), len(a) * n_data) for a in arrays)


def _world_child(fn, rank: int, world: int, init: str, backend: str, timeout_s: float,
                 args: tuple, results) -> None:
    import traceback

    import torch

    torch.set_num_threads(1)
    try:
        initialize_process(init, world, rank, backend=backend, timeout_s=timeout_s)
        results.put((rank, None, fn(rank, *args)))
    except Exception:  # reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn, world: int, *args, backend: str = "gloo", timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes joined into one
    world (``spawn`` start method, a ``file://`` rendezvous in a temporary
    directory, one thread each) -> the ranks' return values, by rank.

    ``fn`` must be a module-level function and its results picklable.  A
    rank that raises, or a world that does not finish within ``timeout_s``
    plus a minute, raises ``RuntimeError`` with the ranks' tracebacks; every
    process is ended before this returns or raises.
    """
    import multiprocessing as mp
    import os
    import queue
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_world_child,
                             args=(fn, r, world, init, backend, timeout_s, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            while len(got) < world and time.monotonic() < deadline:
                try:
                    rank, err, val = results.get(timeout=1.0)
                except queue.Empty:
                    if not any(p.is_alive() for p in procs):
                        break
                    continue
                got[rank] = (err, val)
        finally:
            for p in procs:
                p.join(timeout=10)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    errors = [f"rank {r}:\n{got[r][0]}" for r in sorted(got) if got[r][0]]
    missing = [r for r in range(world) if r not in got]
    if errors or missing:
        raise RuntimeError(f"spawn_world({getattr(fn, '__name__', fn)}, {world}): ranks "
                           f"without a result {missing}, exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [got[r][1] for r in range(world)]
