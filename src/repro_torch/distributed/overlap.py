"""Manually overlapped collective matmul: all-gather x matmul pipelining
(counterpart of ``repro.distributed.overlap``).

The weight's row shards walk the ring: the transfer of the next shard is
posted (``batch_isend_irecv``) before the product with the resident one,
so the link carries shard i+1 while the device multiplies shard i (the
collective-matmul technique of Wang et al., ASPLOS'23).  A replacement
for FSDP-style ``all_gather(W)`` then ``x @ W``.
"""
from __future__ import annotations

import torch

from .collectives import ring_shift

__all__ = ["overlapped_ag_matmul"]


@torch.no_grad()
def overlapped_ag_matmul(x, w_shard, *, mesh, axis: str = "model"):
    """y = x @ all_gather(w, axis) without materializing the gathered weight.

    x [.., K], the same on every rank of ``axis``; w_shard [K/n, N], this
    rank's row block.  At step i the resident block is global block
    (rank + i) % n; blocks move one rank back along the ring each step.
    """
    n = mesh.shape[axis]
    idx = mesh.coord(axis)
    group = mesh.group(axis)
    k_shard = w_shard.shape[0]
    acc = torch.zeros(x.shape[:-1] + (w_shard.shape[1],),
                      dtype=torch.promote_types(x.dtype, torch.float32),
                      device=x.device)
    w_cur = w_shard
    for i in range(n):
        src = (idx + i) % n
        if i < n - 1:  # post the next block's transfer before this product
            w_nxt, wait = ring_shift(w_cur, group, -1)
        acc += torch.einsum("...k,kn->...n",
                            x[..., src * k_shard:(src + 1) * k_shard], w_cur)
        if i < n - 1:
            wait()
            w_cur = w_nxt
    return acc.to(x.dtype)
