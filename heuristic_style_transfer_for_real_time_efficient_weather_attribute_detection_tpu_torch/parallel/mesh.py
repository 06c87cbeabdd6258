"""The device mesh of the port: the ``torch.distributed`` world as a grid.

Counterpart of the JAX package's ``parallel/mesh.py``.  PyTorch's idiom is
one process per card, where JAX runs one controller over many devices, so
a :class:`Mesh` is the world of processes laid out as a grid over ``axes``
(``("data",)``, or ``("data", "model")`` with an explicit ``shape``), rank
``r`` at the grid coordinates of ``r`` in row-major order.  Each rank owns
one device and holds one process group per axis: the ``data`` group is the
ranks that share its model index, the ``model`` group the ranks that share
its data index.  A world of one process (no ``torch.distributed`` group, or
one of size 1) makes a mesh of one rank whose collectives are the identity.

The JAX package's ``replicated(mesh)`` and ``batch_sharding(mesh)`` name
array layouts; a torch tensor lives on one device and has none.  Their
places are taken by what each rank does: a replicated tensor is a full copy
on every rank (the params of an ``Engine``), and a batch sharded over
``data`` is the row range :meth:`Mesh.row_range` of each global batch,
which the engine and the train step slice for themselves (or which
``multihost.host_local_batch`` marks as already sliced).  Results come back
whole through :meth:`Mesh.gather`.

Two collectives serve every user:

- :meth:`Mesh.all_reduce` sums over an axis's group (or the world), with a
  differentiable form whose backward is the same sum of the gradients (the
  global batch norm's statistics, whose backward then carries the
  cross-rank terms);
- :meth:`Mesh.gather` concatenates each rank's slice along a dim, written
  as an all-reduce of a zero-filled buffer in which each rank writes its
  own slice: gloo has no ``all_gather`` of CUDA tensors, while
  ``all_reduce`` runs on every backend used here, and adding zeros is exact.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group whose backward sums the incoming gradients
    over the same group: the adjoint of y_r = sum_s x_s on every rank r is
    dx_r = sum_s dy_s."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.group)
        return dx, None


class Mesh:
    """This rank's place in the world laid out as a grid over ``axes``.

    Attributes: ``axis_names``, ``shape``, ``rank``, ``size`` (ranks in the
    mesh) and ``coords`` (this rank's index on each axis).  Build it with
    :func:`make_mesh`, which every rank of the world calls alike.
    """

    def __init__(self, axes: Sequence[str], shape: Sequence[int]):
        rank, world = _world()
        self.axis_names = tuple(axes)
        self.shape = tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape {self.shape} differ in length")
        if int(np.prod(self.shape)) != world:
            raise ValueError(
                f"a mesh of shape {self.shape} needs {int(np.prod(self.shape))} processes, one "
                f"per device; this world has {world} (launch one process per card, e.g. "
                "torchrun --nproc_per_node=N)"
            )
        self.rank, self.size = rank, world
        self.coords = {a: int(i) for a, i in
                       zip(self.axis_names, np.unravel_index(rank, self.shape))}
        grid = np.arange(world).reshape(self.shape)
        self._groups: Dict[str, Any] = {}
        for ai, name in enumerate(self.axis_names):
            if self.shape[ai] == 1:
                self._groups[name] = None
                continue
            # every rank creates every group of this axis, in the same order
            # (new_group is collective over the world)
            others = [range(s) for j, s in enumerate(self.shape) if j != ai]
            for idx in itertools.product(*others):
                sel = list(idx)
                sel.insert(ai, slice(None))
                ranks = [int(r) for r in grid[tuple(sel)]]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[name] = group

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, rank={self.rank})"

    @property
    def is_main(self) -> bool:
        """True on rank 0, the rank that writes files."""
        return self.rank == 0

    def axis_size(self, axis: str) -> int:
        """The number of ranks along ``axis`` (1 for an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    def _group(self, axis: Optional[str]):
        """The process group of ``axis``, or of the world for None; None
        where the group has one rank (its collectives are the identity)."""
        if axis is None:
            return dist.group.WORLD if self.size > 1 else None
        return self._groups.get(axis)

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None,
                   differentiable: bool = False, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis``'s group (the whole world for None):
        a new tensor, ``t`` itself where the group has one rank.  ``op`` is
        "sum" or "max"; the differentiable form is the sum only."""
        group = self._group(axis)
        if group is None:
            return t
        if differentiable:
            if op != "sum":
                raise ValueError("only the sum is differentiable")
            return _AllReduceSum.apply(t, group)
        y = t.detach().clone()
        dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=group)
        return y

    def gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The slices of every rank of ``axis``'s group concatenated along
        ``dim`` in index order (every slice the same shape): an all-reduce
        sum of a zero buffer holding this rank's slice at its place."""
        group = self._group(axis)
        if group is None:
            return t
        n, i = self.axis_size(axis), self.index(axis)
        shape = list(t.shape)
        per = shape[dim]
        shape[dim] = per * n
        buf = t.new_zeros(shape)
        buf.narrow(dim, i * per, per).copy_(t)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def row_range(self, n: int, axis: str = "data") -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a global batch of ``n`` rows split
        evenly over ``axis``; ``n`` must divide by the axis's size."""
        k = self.axis_size(axis)
        if n % k:
            raise ValueError(f"a batch of {n} rows does not split evenly over the {k} ranks "
                             f"of the mesh's {axis!r} axis")
        per = n // k
        lo = self.index(axis) * per
        return lo, lo + per


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
) -> Mesh:
    """The mesh over the world's processes, one device each.

    1-D ``("data",)`` by default; pass ``axes=("data", "model")`` with an
    explicit ``shape`` for a 2-D data x task mesh.  ``n_devices``, where
    given, must be the world's size: a torch mesh spans every process of
    the world.  Every rank calls it alike (it creates the axes' process
    groups, a collective over the world).  Without a process group it is a
    mesh of one rank.
    """
    _, world = _world()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh({n}): the world has {world} processes, one per device; "
                         "a mesh spans all of them")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    return Mesh(axes, shape)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class HostLocal(NamedTuple):
    """This process's rows of a global batch (``multihost.host_local_batch``):
    ``rows`` are the global rows [lo, lo + len(rows)) of ``total``."""

    rows: Any
    lo: int
    total: int


class RowShard(NamedTuple):
    """What a train-mode forward needs to compute as if it saw the global
    batch while it holds rows [lo, lo + n) of ``total``: batch norm sums its
    statistics over the ``data`` group (``all_reduce``, differentiable), and
    dropout and augmentation draw for ``total`` rows and keep their own."""

    lo: int
    total: int
    mesh: Mesh

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(t, "data", differentiable=True)

    def rows(self, draws: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's n rows of ``draws``, a draw for the global batch."""
        return draws[self.lo: self.lo + n]


def batch_rows(mesh: Mesh, a) -> Tuple[Any, int, int]:
    """(this rank's rows, their first global row, the global row count) of
    a global batch, or of a :class:`HostLocal` batch already sliced."""
    if isinstance(a, HostLocal):
        return a.rows, a.lo, a.total
    n = len(a)
    lo, hi = mesh.row_range(n)
    return a[lo:hi], lo, n
