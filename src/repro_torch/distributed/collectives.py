"""The collectives the distributed modules issue, each counted where it is
issued (what GSPMD's gathers and reductions, ``psum``/``pmax`` and
``ppermute`` are in the reference).

Every function takes a process group (one mesh axis: ``mesh.group(axis)``)
and works on gloo (CPU tensors) and NCCL (CUDA tensors) alike; a group of
one rank still goes through the backend.  :func:`collective_counts` says
how many of each were issued since :func:`reset_collective_counts`.

An :class:`AbstractGroup` (an axis of a
:class:`~repro_torch.distributed.device_mesh.AbstractMesh`, which has no
processes) runs nothing: a gather or an all-reduce over it is entered in
the mesh's :class:`Ledger` and returns a tensor of the shape the
collective gives, on the input's device (the ``meta`` device in the dry
run).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_dim", "all_reduce", "ring_shift", "collective_counts",
           "reset_collective_counts", "AbstractGroup", "Ledger"]

_counts: dict[str, int] = {}


def _count(op: str) -> None:
    _counts[op] = _counts.get(op, 0) + 1


def collective_counts() -> dict[str, int]:
    return dict(_counts)


def reset_collective_counts() -> None:
    _counts.clear()


class Ledger:
    """The collectives issued over the axes of an abstract mesh: ``counts``
    by operation (the names of :func:`collective_counts`), and the bytes
    each rank sends over its links, by operation and by mesh axis, on the
    ring model: a gather (n - 1) / n of its output, an all-reduce
    2 (n - 1) / n of its tensor (a group of one rank sends nothing)."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.link_bytes: dict[str, float] = {}
        self.axis_bytes: dict[str, float] = {}

    def add(self, op: str, axis: str, n: int, nbytes: int) -> None:
        link = (1 if op == "all_gather" else 2) * (n - 1) / n * nbytes
        self.counts[op] = self.counts.get(op, 0) + 1
        self.link_bytes[op] = self.link_bytes.get(op, 0.0) + link
        self.axis_bytes[axis] = self.axis_bytes.get(axis, 0.0) + link


class AbstractGroup:
    """Mesh axis ``axis`` of ``size`` ranks with no processes behind it:
    its collectives are entered in ``ledger``, not run."""

    def __init__(self, axis: str, size: int, ledger: Ledger):
        self.axis, self.size, self.ledger = axis, size, ledger

    def _add(self, op: str, t: torch.Tensor) -> None:
        self.ledger.add(op, self.axis, self.size, t.numel() * t.element_size())


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's chunks of one tensor concatenated along ``dim`` in group
    rank order."""
    if isinstance(group, AbstractGroup):
        shape = list(x.shape)
        shape[dim] *= group.size
        out = x.new_empty(shape)
        group._add("all_gather", out)
        return out
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    _count("all_gather")
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the group in place (``op``: sum or max)."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if isinstance(group, AbstractGroup):
        group._add("all_reduce", x)
        return x
    dist.all_reduce(x, op=red, group=group)
    _count("all_reduce")
    return x


def ring_shift(x: torch.Tensor, group, shift: int = 1):
    """Post the ring step ``rank -> rank + shift`` of ``x`` over the group:
    ``x`` goes to the group rank ``shift`` ahead and the buffer returned is
    filled from the one ``shift`` behind.  Returns ``(buffer, wait)``; call
    ``wait()`` before reading the buffer.  On a ring of one rank the step
    is the identity (there is no peer): ``x`` itself comes back."""
    n = dist.get_world_size(group)
    if n == 1 or shift % n == 0:
        return x, (lambda: None)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    buf = torch.empty_like(x)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                    dist.P2POp(dist.irecv, buf, src, group)])
    _count("send_recv")

    def wait():
        for w in works:
            w.wait()

    return buf, wait
