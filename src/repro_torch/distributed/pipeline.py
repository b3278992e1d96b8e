"""GPipe-style pipeline parallelism over a "pipe" mesh axis (counterpart of
``repro.distributed.pipeline``).

Layers are split into S stages; microbatches stream through; each tick
every stage processes one microbatch and sends its activations to its
successor over the ring.  The classic GPipe schedule: S + M - 1 ticks,
bubble (S - 1) / M.  Self-contained (``stage_fn`` in, outputs out) so any
stacked-layer model can be pipelined by giving its per-stage layer stacks.
"""
from __future__ import annotations

import torch

from repro_torch.optim.optimizers import tree_map

from .collectives import all_reduce, ring_shift

__all__ = ["gpipe_forward", "split_stages"]


def split_stages(stacked_params, n_stages: int):
    """[L, ...] layer stacks -> [S, L/S, ...] per-stage stacks."""
    def re(a):
        n = a.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])
    return tree_map(re, stacked_params)


@torch.no_grad()
def gpipe_forward(stage_params, x_microbatches, stage_fn, *, mesh,
                  axis: str = "pipe"):
    """Run microbatches through pipeline stages.

    stage_params: tree with a leading stage axis — the whole ``[S, ...]``
      stack (this rank takes its stage's slice) or this rank's ``[1, ...]``
      chunk of it
    x_microbatches: [M, mb, ...] activations, the same on every stage
    stage_fn(params_slice, x) -> x — applies one stage's layers.

    Returns [M, mb, ...] outputs on every rank (the last stage's, summed
    over the ring with the other stages' zeros).
    """
    n_stages = mesh.shape[axis]
    stage_id = mesh.coord(axis)
    group = mesh.group(axis)
    m = x_microbatches.shape[0]
    params = tree_map(lambda a: a[0] if a.shape[0] == 1 else a[stage_id],
                      stage_params)
    last = stage_id == n_stages - 1
    buf = torch.zeros_like(x_microbatches)  # output collector (last stage)
    inflight = torch.zeros_like(x_microbatches[0])
    for t in range(n_stages + m - 1):
        # stage 0 injects microbatch t (if any); others take the ring's input
        xin = x_microbatches[min(max(t, 0), m - 1)] if stage_id == 0 else inflight
        active = 0 <= t - stage_id < m
        y = stage_fn(params, xin) if active else xin
        if active and last:
            buf[t - (n_stages - 1)] = y
        # activations stage i -> i + 1
        inflight, wait = ring_shift(y, group, 1)
        wait()
    # every rank gets the outputs: the last stage's buffer, zeros elsewhere
    if not last:
        buf.zero_()
    return all_reduce(buf, group, "sum")
