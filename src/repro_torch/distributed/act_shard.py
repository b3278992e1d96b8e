"""Activation sharding constraints (counterpart of
``repro.distributed.act_shard``).

The reference's models call ``constrain(x, ...)`` with symbolic axes to
anchor GSPMD's sharding propagation inside layers.  The port has no
propagation to anchor: its sharded train step and its sharded serving step
compute each rank's part explicitly (:mod:`repro_torch.training.trainer`,
:mod:`repro_torch.distributed.tp`), so :func:`constrain` resolves the spec
the reference would pin — for the record and for code that wants it
(:func:`resolve`) — and returns ``x`` unchanged.  The port's models need no
call sites.

The current mesh (:func:`mesh_context`, :func:`get_mesh`) is the serving
step's: ``models.api`` enters it for a call given ``mesh=``, and the models
read it where the reference's do — ``moe_ffn_manual``'s mesh, the decode
step's KV split, the step plan run per shard.

Symbolic axes: "batch" -> ("pod","data") (whichever exist), "data",
"model", None; any axis that does not divide becomes None, and an axis an
enclosing per-pod region has made manual (:class:`manual_axes`) is dropped.
"""
from __future__ import annotations

import numpy as np

from .sharding import P

__all__ = ["set_mesh", "get_mesh", "constrain", "mesh_context", "resolve",
           "manual_axes"]

_MESH = None
_MANUAL: frozenset = frozenset()


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


class mesh_context:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = _MESH
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self.prev)


class manual_axes:
    """Within it, the named axes are manual (a per-pod region, the
    reference's ``shard_map`` body): :func:`constrain` never names them."""

    def __init__(self, *axes: str):
        self.axes = frozenset(axes)

    def __enter__(self):
        global _MANUAL
        self.prev = _MANUAL
        _MANUAL = self.prev | self.axes
        return self

    def __exit__(self, *exc):
        global _MANUAL
        _MANUAL = self.prev


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def resolve(shape, axes, mesh, manual=None) -> P:
    """The spec ``constrain(x, *axes)`` pins for an ``x`` of ``shape``."""
    manual = _MANUAL if manual is None else frozenset(manual)
    spec = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax in manual:
            spec.append(None)
            continue
        if ax == "batch":
            cand = tuple(a for a in ("pod", "data")
                         if a in mesh.shape and a not in manual)
            if not cand:
                spec.append(None)
                continue
            if dim % _axis_size(mesh, cand) == 0:
                spec.append(cand if len(cand) > 1 else cand[0])
            elif dim % _axis_size(mesh, ("data",)) == 0 and "data" in mesh.shape:
                spec.append("data")
            else:
                spec.append(None)
        else:
            if ax in mesh.shape and dim % mesh.shape[ax] == 0 and dim >= mesh.shape[ax]:
                spec.append(ax)
            else:
                spec.append(None)
    spec += [None] * (len(shape) - len(spec))
    return P(*spec)


def constrain(x, *axes):
    """``x`` unchanged (see the module docstring); the spec it stands for
    is :func:`resolve`'s."""
    return x
