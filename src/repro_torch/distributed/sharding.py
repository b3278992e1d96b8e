"""Sharding policy (counterpart of ``repro.distributed.sharding``): a
partition spec for every parameter / optimizer / residual leaf, batch leaf
and decode-state leaf, from its tree path and shape, with
divisibility-checked fallbacks.

Strategy (the reference's, rule for rule):
  * parameters: FSDP/ZeRO-3 storage — the largest dim divisible by |model|
    goes to "model"; then the largest remaining dim divisible by |data| goes
    to "data".  The train step gathers a leaf before it uses it
    (:mod:`repro_torch.distributed.placement`) and keeps only this rank's
    chunk between steps.
  * MoE expert stacks: expert dim on "model" when divisible (EP), else the ff
    dim (TP-within-expert).
  * batch axes of inputs / caches: ("pod", "data") when divisible, "data"
    when not, replicated as last resort; for batch-1 long-context the
    sequence axis takes "data".
  * optimizer state and gradient-compression residuals mirror the
    parameters' rules under their own paths (``.opt_state/...``,
    ``.error_fb/...`` when a whole ``TrainState`` is given).

These are host functions over shapes: a mesh is anything whose ``.shape``
maps axis names to sizes, so a 16 x 16 or 2 x 16 x 16 policy is computed
without 256 processes.  A spec is a :class:`P`, a tuple with the entries of
the reference's ``PartitionSpec`` (``None``, an axis name, or a tuple of
names split as one flattened axis in that order).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["P", "NamedSharding", "param_pspec", "params_pspecs",
           "batch_pspecs", "decode_state_pspecs", "named", "mesh_axis_size",
           "plan_batch_spec", "map_specs", "map_tree"]


class P(tuple):
    """A partition spec: one entry a dimension (trailing ones may be left
    out).  A one-name tuple is stored as the name, as ``PartitionSpec``
    stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (what ``jax.sharding.NamedSharding`` is)."""

    mesh: Any
    spec: P


def mesh_axis_size(mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


# ------------------------------------------------------------ tree walking


def _fields(node):
    """A dataclass's fields that hold values: a field marked
    ``metadata={"static": True}`` (``TrainState.pspecs``) holds none."""
    return [f for f in dataclasses.fields(node)
            if not f.metadata.get("static")]


def _statics(node) -> dict:
    return {f.name: None for f in dataclasses.fields(node)
            if f.metadata.get("static")}


def _walk(tree, fn, path):
    """``tree``'s structure with each leaf replaced by ``fn(name, leaf)``;
    names as the reference's ``tree_flatten_with_path`` gives them: a dict
    key or list index as itself, a dataclass field ``f`` as ``.f``."""
    if tree is None:
        return None
    if isinstance(tree, P):
        raise TypeError("a spec tree is not a value tree")
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **_statics(tree), **{
            f.name: _walk(getattr(tree, f.name), fn, path + (f".{f.name}",))
            for f in _fields(tree)})
    return fn("/".join(path), tree)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a value tree and its spec tree; the value
    tree drives the walk, so a :class:`P` stays whole."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **_statics(tree), **{
            f.name: map_specs(fn, getattr(tree, f.name),
                              getattr(specs, f.name))
            for f in _fields(tree)})
    return fn(tree, specs)


def map_tree(fn, tree):
    """``fn(leaf)`` over every leaf of a value tree."""
    return _walk(tree, lambda _, x: fn(x), ())


# -------------------------------------------------------------- parameters


def _assign_axes(shape: tuple[int, ...], skip: set[int], mesh,
                 want_data: bool = True) -> list:
    """Greedy: biggest dim % model == 0 -> 'model'; biggest remaining % data -> 'data'."""
    spec: list = [None] * len(shape)
    msize = mesh_axis_size(mesh, "model")
    dsize = mesh_axis_size(mesh, "data")
    order = sorted((i for i in range(len(shape)) if i not in skip),
                   key=lambda i: -shape[i])
    mi = next((i for i in order if shape[i] % msize == 0 and shape[i] >= msize), None)
    if mi is not None:
        spec[mi] = "model"
    if want_data:
        di = next((i for i in order if i != mi and shape[i] % dsize == 0
                   and shape[i] >= dsize), None)
        if di is not None:
            spec[di] = "data"
    return spec


def param_pspec(path: str, shape: tuple[int, ...], mesh, *,
                fsdp: bool = True) -> P:
    """The spec of one parameter given its flattened path name."""
    if len(shape) <= 1:
        return P()  # norms / biases / small vectors: replicated
    skip: set[int] = set()
    # stacked-layer leading axis is never sharded
    if any(k in path for k in ("blocks", "enc_blocks", "dec_blocks")):
        skip.add(0)
    if ("gate" in path or "up" in path or "down" in path) and len(shape) - len(skip) == 3:
        # MoE expert stack [L?, E, d, f]: prefer EP on the expert dim
        e_ax = min(i for i in range(len(shape)) if i not in skip)
        msize = mesh_axis_size(mesh, "model")
        if shape[e_ax] % msize == 0 and shape[e_ax] >= msize:
            spec = [None] * len(shape)
            spec[e_ax] = "model"
            if fsdp:
                rest = sorted((i for i in range(len(shape)) if i != e_ax and i not in skip),
                              key=lambda i: -shape[i])
                dsize = mesh_axis_size(mesh, "data")
                di = next((i for i in rest if shape[i] % dsize == 0), None)
                if di is not None:
                    spec[di] = "data"
            return P(*spec)
        skip.add(e_ax)  # TP-within-expert below
    return P(*_assign_axes(shape, skip, mesh, want_data=fsdp))


def params_pspecs(tree: Any, mesh, *, fsdp: bool = True, prefix=()):
    """A params tree (tensors, ``meta`` tensors or numpy arrays), or a whole
    ``TrainState`` -> the same structure with a :class:`P` at each leaf.
    ``prefix`` is the path of ``tree`` inside a larger tree."""
    return _walk(tree, lambda name, leaf: param_pspec(
        name, tuple(leaf.shape), mesh, fsdp=fsdp), tuple(prefix))


# ------------------------------------------------------------------- batch


def _batch_axes(mesh) -> tuple[str, ...] | str | None:
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def plan_batch_spec(mesh, b: int):
    """Mesh axis name(s) to split a layer plan's batch/slot axis over, or
    None (replicate): ("pod","data") when the slot count divides the full
    extent, "data" alone when only that divides — the slot rule of
    :func:`decode_state_pspecs`."""
    baxes = _batch_axes(mesh)
    if baxes is None:
        return None
    bsize = int(np.prod([mesh_axis_size(mesh, a) for a in ("pod", "data")]))
    dsize = mesh_axis_size(mesh, "data")
    if bsize > 1 and b % bsize == 0 and b >= bsize:
        return baxes
    if dsize > 1 and b % dsize == 0 and b >= dsize:
        return "data"
    return None


def batch_pspecs(batch_tree: Any, mesh):
    """Inputs: batch-major sharding over ("pod","data"); batch-1
    long-context shards the sequence axis instead (SP)."""
    baxes = _batch_axes(mesh)
    bsize = int(np.prod([mesh_axis_size(mesh, a) for a in ("pod", "data")]))
    dsize = mesh_axis_size(mesh, "data")

    def one(_, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        spec: list = [None] * len(shape)
        # positions3 [3, B, S] style: batch is axis 1
        b_ax = 1 if (len(shape) >= 2 and shape[0] == 3) else 0
        if shape[b_ax] % bsize == 0 and shape[b_ax] >= bsize:
            spec[b_ax] = baxes
        elif shape[b_ax] % dsize == 0 and shape[b_ax] >= dsize:
            spec[b_ax] = "data"
        elif len(shape) > b_ax + 1 and shape[b_ax + 1] % dsize == 0:
            spec[b_ax + 1] = "data"  # SP fallback (e.g. long_500k batch=1)
        return P(*spec)

    return _walk(batch_tree, one, ())


def decode_state_pspecs(state_tree: Any, mesh):
    """KV caches / recurrent states: batch (slot) axis over ("pod","data")
    when divisible, head/feature dims over "model"; layer-stack leading axis
    skipped.  The "model" pick prefers trailing head/feature axes (axis >= 3)
    over the sequence axis (axis 2); integer leaves stay replicated beyond
    the batch axis.  Paged pools ``[L, n_blocks, bs, ...]`` shard their pool
    axis like slots; the shared ``block_tbl`` is replicated."""
    baxes = _batch_axes(mesh)
    bsize = int(np.prod([mesh_axis_size(mesh, a) for a in ("pod", "data")]))
    dsize = mesh_axis_size(mesh, "data")
    msize = mesh_axis_size(mesh, "model")

    def one(name, leaf):
        shape = tuple(leaf.shape)
        if "block_tbl" in name or len(shape) <= 1:
            return P()
        spec: list = [None] * len(shape)
        b_ax = 1  # [L, B, ...] / paged [L, Nb, ...] layout everywhere
        if shape[b_ax] % bsize == 0 and shape[b_ax] >= bsize:
            spec[b_ax] = baxes
        elif shape[b_ax] % dsize == 0 and shape[b_ax] >= dsize:
            spec[b_ax] = "data"
        if _is_integer(leaf.dtype):
            return P(*spec)
        order = (sorted(range(3, len(shape)), key=lambda i: -shape[i])
                 + ([2] if len(shape) > 2 else []))
        mi = next((i for i in order if shape[i] % msize == 0 and shape[i] >= msize), None)
        if mi is not None:
            spec[mi] = "model"
        return P(*spec)

    return _walk(state_tree, one, ())


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex
                    or dtype == torch.bool)
    return bool(np.issubdtype(np.dtype(dtype), np.integer))


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` bound to ``mesh``."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    if dataclasses.is_dataclass(spec_tree):
        return dataclasses.replace(spec_tree, **{
            f.name: named(mesh, getattr(spec_tree, f.name))
            for f in _fields(spec_tree)})
    raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")
