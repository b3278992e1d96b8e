"""Placement: a leaf's chunk at this rank, and the whole leaf back (what
``jax.device_put`` with a ``NamedSharding`` and GSPMD's gathers do in the
reference).

A spec names, per dimension, the mesh axes it is split over; a tuple of
axes splits the dimension as one flattened axis, the first name outermost.
This rank's chunk is the contiguous block at its coordinates.  The policy
only splits a dimension its axes divide, so every chunk has one shape.
Gathering a tuple-split dimension gathers over its axes innermost first:
each gather rebuilds the block of the next axis out.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import torch

from .collectives import all_gather_dim
from .sharding import batch_pspecs, map_specs, params_pspecs

__all__ = ["axes_of", "chunk_slices", "shard_leaf", "gather_leaf",
           "shard_tree", "gather_tree", "shard_state", "gather_state",
           "local_batch"]


def axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(mesh, axes) -> int:
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord(a)
    return idx


def chunk_slices(shape, spec, mesh) -> tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        axes = axes_of(spec[d]) if d < len(spec) else ()
        parts = math.prod(mesh.shape[a] for a in axes)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({parts} parts)")
        size = n // parts
        i = _index(mesh, axes)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard_leaf(x, spec, mesh, device=None) -> torch.Tensor:
    """This rank's chunk of ``x`` (a tensor or numpy array), in memory of
    its own on ``device`` (default: ``x``'s, the mesh's for numpy)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(x)
        device = mesh.device if device is None else device
    return x[chunk_slices(x.shape, spec, mesh)].to(device).clone(
        memory_format=torch.contiguous_format)


def gather_leaf(chunk: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's chunk; a replicated leaf is the
    chunk itself."""
    out = chunk
    for d in range(min(len(spec), chunk.dim())):
        for a in reversed(axes_of(spec[d])):
            out = all_gather_dim(out, mesh.group(a), d)
    return out


def shard_tree(tree, specs, mesh, device=None):
    return map_specs(lambda x, s: shard_leaf(x, s, mesh, device), tree, specs)


def gather_tree(tree, specs, mesh):
    return map_specs(lambda x, s: gather_leaf(x, s, mesh), tree, specs)


def shard_state(state, mesh, specs=None, device=None):
    """A whole ``TrainState`` -> this rank's chunks of it, its spec tree in
    ``pspecs`` (default: ``params_pspecs`` of the whole state, the
    reference launcher's placement)."""
    if specs is None:
        specs = params_pspecs(state, mesh)
    return dataclasses.replace(shard_tree(state, specs, mesh, device),
                               pspecs=specs)


def gather_state(state, mesh):
    """A sharded ``TrainState`` -> the whole state (every rank takes part;
    each gets the whole)."""
    if state.pspecs is None:
        return state
    return gather_tree(state, state.pspecs, mesh)


def local_batch(batch: dict, mesh, axes=("pod", "data")):
    """This rank's part of a global batch under :func:`batch_pspecs` over
    the mesh's ``axes`` (the others ignored).  Only the batch dimension is
    split: under the sequence-parallel fallback every rank keeps the whole
    batch.  Returns ``(local batch, the axes the batch dim was split
    over)``."""
    view = SimpleNamespace(shape={a: s for a, s in mesh.shape.items()
                                  if a in axes or a not in ("pod", "data")})
    specs = batch_pspecs(batch, view)
    out, split = {}, ()
    for k, x in batch.items():
        spec = specs[k]
        b_ax = 1 if (x.dim() >= 2 and x.shape[0] == 3) else 0
        entry = spec[b_ax] if len(spec) > b_ax else None
        if entry is None:
            out[k] = x
            continue
        split = axes_of(entry)
        parts = math.prod(mesh.shape[a] for a in split)
        size = x.shape[b_ax] // parts
        i = _index(mesh, split)
        out[k] = x.narrow(b_ax, i * size, size)
    return out, split
