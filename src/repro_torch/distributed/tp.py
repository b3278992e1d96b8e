"""Tensor parallelism for the sharded serving step: each rank computes its
own part of every product whose weight the policy partitions
(:func:`~repro_torch.distributed.sharding.params_pspecs`), explicitly — what
GSPMD's partitioner derives for the reference's ``ServingEngine(mesh=)``.

A partitioned weight reaches the models as a :class:`Sharded` leaf: this
rank's chunk, its spec (the policy's, one entry a dimension) and the mesh.
The rules, one per entry of a spec:

* "data" (or "pod") on a weight is FSDP storage: the chunk is all-gathered
  over that axis before use (:func:`fsdp`).
* "model" on the contraction dimension: the rank multiplies its slice of
  the input by its rows, and the partial products are all-reduced over
  "model" (in float32 when there is more than one part, so the sum rounds
  once into the activations' dtype).
* "model" on the output dimension: the rank computes its columns, and they
  are all-gathered over "model".
* "model" on the expert dimension of an expert stack: the rank runs its own
  experts and the outputs are all-gathered over "model".
* an embedding split over the vocabulary: a masked lookup of the rows the
  rank holds, all-reduced over "model"; the tied head's logits are computed
  on the rank's vocabulary columns and gathered whole.
* norm gains and biases are gathered at use (:func:`whole`).

The KV cache is split by :func:`~repro_torch.distributed.sharding
.decode_state_pspecs`: over "model" on the head dimension (usually), where
attention multiplies the rank's slice of q into its keys, all-reduces the
partial scores before the softmax, applies the probabilities to its value
slice and gathers the output; or over the kv heads, where each rank runs
its heads alone and gathers the output.  Rotary embeddings pair dimension
``i`` with ``i + hd / 2``, so q and k are rotated whole before the rank
keeps its slice.

Every collective goes through :mod:`~repro_torch.distributed.collectives`,
where it is counted; a group of one rank still goes through the backend
(at world size 1 each gather is one copy).  Nothing here gathers a whole
weight where its spec asks for a partial product.
"""
from __future__ import annotations

import math

import torch

from .collectives import all_gather_dim, all_reduce
from .placement import axes_of, chunk_slices, gather_leaf, shard_leaf
from .sharding import P, decode_state_pspecs, map_specs, params_pspecs

__all__ = ["Sharded", "shard_params", "whole", "fsdp", "local_chunk",
           "linear", "embed", "expert_matmul", "kv_split", "kv_local",
           "gather_kv", "attend"]

MODEL = "model"


class Sharded:
    """One rank's chunk of a partitioned leaf: ``local`` (a tensor), its
    ``spec`` over ``mesh``.  ``shape`` is the whole leaf's; indexing or
    unbinding the leading (layer) dimension, which the policy never splits,
    gives the layer's leaf."""

    __slots__ = ("local", "spec", "mesh")

    def __init__(self, local: torch.Tensor, spec, mesh):
        self.local = local
        self.spec = P(*spec, *([None] * (local.dim() - len(spec))))
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        return torch.Size(n * _parts(self.mesh, e)
                          for n, e in zip(self.local.shape, self.spec))

    def _layer_ok(self) -> None:
        if self.spec[0] is not None:
            raise ValueError(f"leading dimension split over {self.spec[0]}")

    def __getitem__(self, i: int) -> "Sharded":
        self._layer_ok()
        return Sharded(self.local[i], self.spec[1:], self.mesh)

    def unbind(self, dim: int = 0) -> list["Sharded"]:
        assert dim == 0
        self._layer_ok()
        return [Sharded(t, self.spec[1:], self.mesh)
                for t in self.local.unbind(0)]

    @property
    def T(self) -> "Sharded":
        assert self.local.dim() == 2
        return Sharded(self.local.T, P(self.spec[1], self.spec[0]), self.mesh)

    def to(self, dtype: torch.dtype) -> "Sharded":
        return Sharded(self.local.to(dtype), self.spec, self.mesh)


def _parts(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in axes_of(entry))


def shard_params(params, mesh, device=None, specs=None):
    """The whole ``params`` tree (tensors or numpy arrays) -> this rank's
    :class:`Sharded` leaves under ``specs`` (default: the policy's)."""
    if specs is None:
        specs = params_pspecs(params, mesh)
    return map_specs(lambda x, s: Sharded(shard_leaf(x, s, mesh, device), s,
                                          mesh), params, specs)


def whole(w) -> torch.Tensor:
    """The whole leaf (a plain tensor is already whole)."""
    if not isinstance(w, Sharded):
        return w
    return gather_leaf(w.local, w.spec, w.mesh)


def _gather(t: torch.Tensor, group, d: int) -> torch.Tensor:
    """``all_gather_dim`` in ``t``'s own layout: a transposed view (the tied
    head's ``embed.T``) is gathered as its storage and transposed back, so
    the product reads the same layout as the unsharded one."""
    if t.dim() == 2 and not t.is_contiguous() and t.T.is_contiguous():
        return all_gather_dim(t.T, group, 1 - d).T
    return all_gather_dim(t, group, d)


def fsdp(w: Sharded) -> Sharded:
    """``w`` with every axis but "model" gathered (FSDP storage made whole
    for use)."""
    out, spec = w.local, list(w.spec)
    for d, e in enumerate(spec):
        axes = axes_of(e)
        if axes and axes != (MODEL,):
            if MODEL in axes:
                raise ValueError(f"a dimension split over {axes}: 'model' "
                                 "beside another axis")
            for a in reversed(axes):
                out = _gather(out, w.mesh.group(a), d)
            spec[d] = None
    return Sharded(out, P(*spec), w.mesh)


def local_chunk(w, spec, mesh) -> torch.Tensor:
    """This rank's chunk of ``w`` (a whole tensor or a :class:`Sharded`)
    under ``spec``: a dimension whose stored entry differs is gathered over
    the stored axes, then split over the wanted ones (the resharding at the
    reference's ``shard_map`` boundary)."""
    if not isinstance(w, Sharded):
        return w[chunk_slices(w.shape, P(*spec), mesh)]
    want = tuple(spec) + (None,) * (w.local.dim() - len(spec))
    out = w.local
    for d, (have, e) in enumerate(zip(w.spec, want)):
        if have == e:
            continue
        for a in reversed(axes_of(have)):
            out = _gather(out, mesh.group(a), d)
        one = P(*([None] * d), e)
        out = out[chunk_slices(out.shape, one, mesh)]
    return out


def _model_dim(w: Sharded) -> int | None:
    for d, e in enumerate(w.spec):
        if axes_of(e) == (MODEL,):
            return d
    return None


def _partial(y: torch.Tensor, mesh, dtype) -> torch.Tensor:
    """The sum over "model" of the partial products ``y`` (float32 when the
    axis has several ranks), in ``dtype``."""
    return all_reduce(y, mesh.group(MODEL)).to(dtype)


def _slice_last(x: torch.Tensor, mesh, width: int) -> torch.Tensor:
    i = mesh.coord(MODEL)
    return x[..., i * width:(i + 1) * width]


def linear(x: torch.Tensor, w: Sharded, b=None) -> torch.Tensor:
    """``x @ W (+ b)`` for a partitioned ``W [K, N]`` (the rules of the
    module docstring); the result is whole on every rank."""
    w = fsdp(w)
    mesh = w.mesh
    md = _model_dim(w)
    if md == 0:
        xl = _slice_last(x, mesh, w.local.shape[0])
        if mesh.shape[MODEL] > 1:
            y = _partial(xl.to(torch.float32) @ w.local.to(torch.float32),
                         mesh, x.dtype)
        else:
            y = _partial(xl @ w.local, mesh, x.dtype)
    else:
        y = x @ w.local
        if md == 1:
            y = all_gather_dim(y, mesh.group(MODEL), -1)
    if b is not None:
        y = y + whole(b)
    return y


def embed(table: Sharded, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a partitioned ``table [V, d]``: a vocabulary split
    looks up the rows this rank holds (others zero) and all-reduces."""
    t = fsdp(table)
    mesh = t.mesh
    md = _model_dim(t)
    if md == 0:
        v_loc = t.local.shape[0]
        loc = ids - mesh.coord(MODEL) * v_loc
        mine = (loc >= 0) & (loc < v_loc)
        rows = t.local[loc.clamp(0, v_loc - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return all_reduce(rows, mesh.group(MODEL))
    rows = t.local[ids]
    if md == 1:
        rows = all_gather_dim(rows, mesh.group(MODEL), -1)
    return rows


def expert_matmul(z: torch.Tensor, w: Sharded) -> torch.Tensor:
    """``einsum("ecd,edf->ecf", z, W)`` for a partitioned expert stack
    ``W [E, d, f]``: the expert split runs the rank's experts and gathers
    them, a contraction split all-reduces, an output split gathers."""
    w = fsdp(w)
    mesh = w.mesh
    md = _model_dim(w)
    if md == 0:
        e_loc = w.local.shape[0]
        i = mesh.coord(MODEL)
        y = torch.einsum("ecd,edf->ecf", z[i * e_loc:(i + 1) * e_loc], w.local)
        return all_gather_dim(y, mesh.group(MODEL), 0)
    if md == 1:
        zl = _slice_last(z, mesh, w.local.shape[1])
        if mesh.shape[MODEL] > 1:
            y = torch.einsum("ecd,edf->ecf", zl.to(torch.float32),
                             w.local.to(torch.float32))
        else:
            y = torch.einsum("ecd,edf->ecf", zl, w.local)
        return _partial(y, mesh, z.dtype)
    y = torch.einsum("ecd,edf->ecf", z, w.local)
    if md == 2:
        y = all_gather_dim(y, mesh.group(MODEL), -1)
    return y


# ---------------------------------------------------------------- KV cache


def kv_split(mesh, n_kv: int, head_dim: int, seq: int) -> int:
    """The dimension of a per-layer KV cache ``[..., seq, Hkv, hd]`` that
    ``decode_state_pspecs`` splits over "model": -1 (head_dim) or -2 (the
    kv heads).  A split of the sequence is refused."""
    meta = {"k": torch.empty((1, 1, seq, n_kv, head_dim), device="meta")}
    spec = decode_state_pspecs(meta, mesh)["k"]
    for d, e in enumerate(spec):
        if axes_of(e) == (MODEL,):
            if d in (3, 4):
                return d - 5
            raise NotImplementedError(
                "a KV cache split over 'model' on its sequence axis (neither "
                f"{n_kv} kv heads nor head_dim {head_dim} divide over "
                f"{mesh.shape[MODEL]} ranks)")
    raise ValueError("decode_state_pspecs split no dimension over 'model'")


def kv_local(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's slice of a whole K/V tensor ``[..., Hkv, hd]`` along the
    split dimension ``dim``."""
    n = t.shape[dim] // mesh.shape[MODEL]
    return t.narrow(dim, mesh.coord(MODEL) * n, n)


def gather_kv(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The whole K/V tensor from every rank's slice along ``dim``."""
    return all_gather_dim(t, mesh.group(MODEL), dim)


def attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask, mesh,
           dim: int) -> torch.Tensor:
    """Attention of whole queries ``qg [B, Sq, Hkv, G, hd]`` over this rank's
    slice of the keys and values ``[B, Sk, Hkv, hd]`` (split along ``dim``),
    additive ``mask [B, 1, 1, Sq, Sk]`` or None -> the whole output
    ``[B, Sq, Hkv, G, hd]`` in float32, as ``attention._sdpa`` returns it."""
    group = mesh.group(MODEL)
    scale = 1.0 / (qg.shape[-1] ** 0.5)
    if dim == -1:  # head_dim split: partial scores, summed before softmax
        q = _slice_last(qg, mesh, k.shape[-1])
        scores = all_reduce(torch.einsum("bqhgd,bkhd->bhgqk",
                                         q.to(torch.float32),
                                         k.to(torch.float32)), group) * scale
    else:  # kv-head split: this rank's heads alone
        n = k.shape[-2]
        i = mesh.coord(MODEL)
        q = qg[:, :, i * n:(i + 1) * n]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                              k.to(torch.float32)) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return all_gather_dim(out, group, -1 if dim == -1 else 2)
