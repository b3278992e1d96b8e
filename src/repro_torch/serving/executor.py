"""Site-keyed compressed execution: route every compressed site through fused
kernels at serving time.

:class:`CompressedExecutor` is built from a
:class:`~repro_torch.core.artifact.CompressedModel`; it maps every site name
(the keys of ``artifact.records``: ``attn.q.l0``, ``ffn.down.l3``, ...) to a
fused-kernel callable, and the model decode path consults it inside the step.

Two kernel routes:

* :class:`LCCMatvec` — one dense site: prune gather -> eq. (10) segment-sum
  (``cluster_segment_sum``) -> the whole FP chain in ONE ``lcc_chain_matmul``
  launch.
* :class:`GroupedLCCMatvec` — one *fused region*: several sites (an attention
  layer's q/k/v, a SwiGLU's gate/up) apply their chains in ONE
  ``lcc_group_matmul`` launch.

Models never import this module — they receive the executor as an opaque
object with the protocol ``matvec(name)``, ``grouped(names)``, ``conv(name)``
(each returning a callable or None).  Nothing here is traced or compiled: the
callables run eagerly, at any batch width (the kernels mask their own ragged
edges, so there is no batch bucketing).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compress import CompressedDense
from repro_torch.kernels import ops
from repro_torch.kernels.shared_matmul import csr_from_labels

__all__ = ["CompressedExecutor", "LCCMatvec", "GroupedLCCMatvec",
           "matvecs_from_artifact"]


class _SitePrep:
    """One site's input preparation: kept-column gather, then the
    weight-sharing segment-sum.  Device tensors are made on first use, so a
    site reached only through its group never uploads anything of its own
    beyond these index vectors."""

    def __init__(self, cd, device):
        self.device = torch.device(device)
        kept = np.asarray(cd.kept_columns, np.int64)
        self._kept_np = kept
        self._kept = None
        # a full, ordered keep of a K-row input needs no gather
        self._identity_rows = (kept.size if (kept == np.arange(kept.size)).all()
                               else -1)
        self._labels_np = (np.asarray(cd.shared.labels, np.int64)
                           if cd.shared is not None else None)
        self.n_clusters = cd.shared.n_clusters if cd.shared is not None else 0
        self._labels = None
        self._csr = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self._identity_rows:
            if self._kept is None:
                self._kept = torch.from_numpy(self._kept_np).to(self.device)
            x = x.index_select(0, self._kept)
        if self._labels_np is not None:
            if self._labels is None:
                self._labels = torch.from_numpy(self._labels_np).to(self.device)
                self._csr = csr_from_labels(self._labels_np, self.n_clusters,
                                            self.device)
            x = ops.segment_sum(self._labels, x, self.n_clusters, csr=self._csr)
        return x


class LCCMatvec:
    """One compressed projection as a fused-kernel matvec: x [K, B] -> [N, B].

    Prune (kept_columns gather) -> optional weight-sharing segment-sum (paper
    eq. (10)) -> the whole FP decomposition in a single ``lcc_chain_matmul``
    launch.  Built from a ``core.compress.CompressedDense`` record; pass
    ``packed=`` to reuse an artifact's pre-packed kernel buffers instead of
    re-packing the decomposition.  The streams go to the device at the first
    call, not at construction.
    """

    def __init__(self, cd, *, packed=None, block: int = 128, device="cuda"):
        self.name = cd.name
        self.device = torch.device(device)
        self.packed = (packed if packed is not None
                       else ops.pack_decomposition(cd.decomposition, block))
        self.prep = _SitePrep(cd, device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        vec = x.dim() == 1
        if vec:
            x = x[:, None]
        y = ops.apply_packed_decomposition(self.packed, self.prep(x))
        return y[:, 0] if vec else y


class GroupedLCCMatvec:
    """Several compressed sites applied in ONE fused launch (a *fused region*).

    Call with a per-site list of features-major inputs ``[K_g, B]`` (all the
    same batch width; input widths may differ — each member gathers its own
    kept columns and segment-sums its own clusters before the shared
    ``lcc_group_matmul`` dispatch).  Returns the per-site ``[N_g, B]`` outputs.
    """

    def __init__(self, records, *, packed=None, block: int = 128,
                 device="cuda"):
        packed = packed or [None] * len(records)
        members = [pk if pk is not None
                   else ops.pack_decomposition(cd.decomposition, block)
                   for cd, pk in zip(records, packed)]
        self.names = tuple(cd.name for cd in records)
        self.device = torch.device(device)
        self.group = ops.pack_group(members)
        self.preps = [_SitePrep(cd, device) for cd in records]

    def __call__(self, xs) -> list[torch.Tensor]:
        return ops.apply_packed_group(
            self.group, [prep(x) for prep, x in zip(self.preps, xs)])


def matvecs_from_artifact(artifact, *, include=None, block: int = 128,
                          device="cuda") -> dict[str, LCCMatvec]:
    """Per-site :class:`LCCMatvec` table for an artifact's dense records.
    ``include`` filters site names (callable or prefix string)."""
    keep = (include if callable(include)
            else (lambda n: n.startswith(include)) if include is not None
            else (lambda n: True))
    return {name: LCCMatvec(rec, packed=artifact.packed.get(name),
                            block=block, device=device)
            for name, rec in artifact.records.items()
            if isinstance(rec, CompressedDense) and keep(name)}


class CompressedExecutor:
    """Site-keyed registry mapping every compressed site of an artifact to a
    fused-kernel callable.

    Protocol consumed by the model decode paths (duck-typed — models never
    import serving):

    * ``matvec(name)``   -> features-major callable ``[K, B] -> [N, B]`` or
      None when the site is not compressed (dense fallback).
    * ``grouped(names)`` -> one-launch callable over a *fused region* (list of
      per-site ``[K_g, B]`` inputs -> list of ``[N_g, B]`` outputs), or None
      unless every name is a compressed dense site.
    * ``conv(name)``     -> None (conv sites are not carried over yet).
    * ``step_plan(cfg)`` -> None: the whole-step layer plan is not carried
      over yet; the reason ``"not_ported"`` is recorded in
      :attr:`plan_fallbacks` and decode takes the per-region route.

    ``routed`` records every site actually served by a fused kernel — tests
    assert it covers the artifact, and the engine reports it.
    """

    def __init__(self, artifact, *, block: int = 128, device="cuda"):
        self.artifact = artifact
        self.block = block
        self.device = torch.device(device)
        self.plan_fallbacks: dict[str, str] = {}
        self._matvecs = matvecs_from_artifact(artifact, block=block,
                                              device=device)
        self._groups: dict[tuple, GroupedLCCMatvec | None] = {}
        self.routed: set[str] = set()

    @property
    def sites(self) -> set[str]:
        """Every site this executor can serve through a fused kernel."""
        return set(self._matvecs)

    def __contains__(self, name: str) -> bool:
        return name in self._matvecs

    def matvec(self, name: str):
        fn = self._matvecs.get(name)
        if fn is not None:
            self.routed.add(name)
        return fn

    def grouped(self, names):
        names = tuple(names)
        if names not in self._groups:
            if names and all(n in self._matvecs for n in names):
                recs = [self.artifact.records[n] for n in names]
                # reuse the per-site packed buffers (host side); only the
                # group's re-padded copy of the streams goes to the device
                packed = [self._matvecs[n].packed for n in names]
                g = GroupedLCCMatvec(recs, packed=packed, block=self.block,
                                     device=self.device)
                self._groups[names] = g
                if g.group.waste is not None:
                    self.artifact.pipeline_stats.setdefault(
                        "padding_waste", {})["+".join(names)] = g.group.waste
            else:
                self._groups[names] = None
        g = self._groups[names]
        if g is not None:
            self.routed.update(names)
        return g

    def conv(self, name: str):
        return None

    def step_plan(self, cfg):
        self.plan_fallbacks.setdefault("step", "not_ported")
        return None

    @property
    def n_layer_plans(self) -> int:
        return 0
