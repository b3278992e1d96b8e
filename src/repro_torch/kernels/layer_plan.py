"""Layer plans on the GPU: a whole stage per launch, and the whole decode step.

Counterpart of ``repro.kernels.layer_plan`` (Pallas TPU), dense and MoE
families:

* :func:`stage_matmul` (K6) evaluates one :class:`~repro_torch.kernels.ops.
  PackedStage` — every compressed site that reads one activation (q+k+v,
  o, gate+up, down), plus baked dense blocks and biases — for one layer or
  for all L.  CUDA source ``csrc/stage_matmul.cu``: a prep kernel (the
  weight-shared scatter-add in fixed order), the chain kernel and an
  epilogue.  The chain kernel's unit of work is a chunk of consecutive FP
  slices of one site: a block runs each slice through its live fused CSD
  levels in shared memory (term streams staged by ``cp.async``) and adds
  the slice's output rows into register sums, so the last level never goes
  to device memory; each block writes its site's rows of ``partial`` once,
  and the epilogue sums the chunks in fixed order and adds the dense blocks,
  the bias and the residual.  The epilogue has two more output modes, which
  take over the elementwise kernels that followed a stage: ``gated=True``
  writes SwiGLU of the gate and up rows, ``combine=`` an MoE layer's gated
  combine plus residual.  The input has one more mode, which takes over the
  MoE dispatch that preceded the experts' stage: ``gather=`` reads the
  experts' input from ``h2`` through the route's source token of each
  slot, so it is never written.  The output map the kernel follows (sites,
  slices, depths) is derived from ``outg`` once at upload
  (:func:`stage_slices`) and checked against it entry by entry; ``outg``
  itself is read only by the plain version.
* :func:`step_plan_matmul` (K7) runs the whole decode step over L identical
  layers as a fixed sequence of hand-written kernels a layer: norm, stage
  qkv, RoPE + decode attention (:func:`step_attention`; emits the new K/V
  rows), stage o + residual, norm, stage gate+up with SwiGLU in its
  epilogue, stage down + residual.  No PyTorch operation runs between them.
  CUDA source ``csrc/step_plan.cu`` (norm, attention) beside the stage
  kernel.
  The attention is split over the cache (:func:`plan_attention`), reads
  only the K/V rows of the live slots, staged in shared memory by
  ``cp.async``, and merges the splits in order in a second kernel.  The
  norm (:func:`step_norm`) reads its ``[d, B]`` tile once into shared
  memory, a cluster of blocks a group of columns, each block a range of
  rows (:func:`plan_norm`), and takes its column sums in a fixed order.
* ``step_plan_matmul(moe=...)`` (K8) replaces a layer's FFN with the routed
  experts inside the same sequence: route, stage eg (all experts' gates and
  ups, e-major, the dispatch as its gathered input, SwiGLU in its
  epilogue), stage ed (all downs, the gated combine + residual in its
  epilogue).  The route kernel is :mod:`~repro_torch.kernels.moe_route`
  (``csrc/moe_route.cu``).
* :func:`moe_plan_matmul` (K9) runs one MoE layer's experts where the
  whole-step plan does not apply (MLA, shared experts): stage A (all gates
  and ups, SwiGLU in its epilogue), stage B (all downs) — two launches, no
  PyTorch operation between them; dispatch and combine stay with the
  caller, as in the reference.

Both evaluate the shift-add streams at every size.  The reference folds a
large stage into one dense matrix (``PackedStage.eff``) and picks between two
lowerings of a level by a row-count threshold; both choices were tuned to the
dispatch costs of an interpreter host and turn the paper's shift-add
evaluation into dense products, so neither is taken here.  ``eff`` stays a
test surface (:func:`stage_apply_eff`).

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions (:func:`stage_matmul_plain`, :func:`step_plan_matmul_plain`), which
repeat the arithmetic in PyTorch operations.  Public layouts are the
reference's: feature-major ``x [d, B]``, caches ``[L, B, S, Hkv, hd]``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from . import build, dispatch
from .lcc_chain_matmul import (MAX_SUMS, SM_SMEM, SMEM_LIMIT, launch_staging,
                               plan_launch, signed_pow2)
from .moe_route import (capacity, moe_combine_plain, moe_dispatch_plain,
                        moe_route, moe_route_plain)
from .ops import PackedStage

__all__ = ["AttentionPlan", "DeviceStage", "NormPlan", "StageLaunch",
           "StageSlices", "attention_key", "device_stage", "plan_attention",
           "plan_norm", "plan_stage", "plan_units", "stage_blocks",
           "stage_slices", "stage_matmul", "stage_matmul_plain",
           "stage_apply_eff", "step_attention", "step_attention_plain",
           "step_norm", "step_norm_plain", "step_plan_matmul",
           "step_plan_matmul_plain", "moe_plan_matmul",
           "moe_plan_matmul_plain"]

_NEG = -1e30
_STAGE_ORDER = ("qkv", "o", "gu", "dn")
_MOE_STAGE_ORDER = ("qkv", "o", "eg", "ed")


# ---------------------------------------------------------------- upload


def stage_blocks(ps: PackedStage, layer: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The finest row pieces of one layer of a stage: ``(r0, r1, depth,
    live_terms)``.

    The pieces partition ``[0, R)`` so that no live term of a level >= 1
    reads a row outside its own piece (the finest such partition: a piece
    is closed under the reads of the levels after the first).  ``depth`` is
    the number of levels a piece must run: the levels after it are identity
    rows (``gidx[p, r, 0] == r``, sign 1, exponent 0, no other live term)
    for every row of the piece.  ``live_terms`` counts the terms with sign
    != 0 in the levels the pieces run.  Raises on indices outside the
    stage."""
    gidx, gexp, gsgn = ps.gidx[layer], ps.gexp[layer], ps.gsgn[layer]
    n_p, r, n_s = gidx.shape
    rows = np.arange(r, dtype=gidx.dtype)
    lo, hi = rows.copy(), rows.copy()
    depth_row = np.ones(r, np.int32)
    live_rows = np.zeros(r, bool)  # a live term in any level
    # loops over the few term columns: reductions over a short last axis
    # are slow in numpy, elementwise passes over [R] are not
    for s in range(n_s):
        live_rows |= (gsgn[:, :, s] != 0).any(axis=0)
    for p in range(1, n_p):
        other = np.zeros(r, bool)  # a live term past column 0
        for s in range(n_s):
            g, live = gidx[p, :, s], gsgn[p, :, s] != 0
            if (live & ((g < 0) | (g >= r))).any():
                raise ValueError(f"stage level {p} reads a row outside [0, {r})")
            np.minimum(lo, np.where(live, g, r), out=lo)
            np.maximum(hi, np.where(live, g, -1), out=hi)
            if s:
                other |= live
        ident = ((gsgn[p, :, 0] == 1) & (gexp[p, :, 0] == 0)
                 & (gidx[p, :, 0] == rows) & ~other)
        depth_row[~ident] = p + 1
    # a row dead in every level is zero after level 0 already
    depth_row[~live_rows] = 1
    cuts = np.arange(1, r)
    ok = ((np.maximum.accumulate(hi)[:-1] < cuts)
          & (np.minimum.accumulate(lo[::-1])[::-1][1:] >= cuts))
    r0 = np.concatenate([[0], cuts[ok]]).astype(np.int64)
    r1 = np.append(r0[1:], r)
    depth = np.maximum.reduceat(depth_row, r0)
    return (r0.astype(np.int32), r1.astype(np.int32), depth.astype(np.int32),
            _live_terms(gsgn, r0, r1, depth))


def _live_terms(gsgn: np.ndarray, r0, r1, depth) -> int:
    """Terms with sign != 0 of rows ``[r0[i], r1[i])`` in their first
    ``depth[i]`` levels (``gsgn [P, R, S]`` of one layer; disjoint ranges)."""
    n_p, r, n_s = gsgn.shape
    step = np.zeros(r + 1, np.int64)
    np.add.at(step, np.asarray(r0, np.int64), depth)
    np.add.at(step, np.asarray(r1, np.int64), -np.asarray(depth, np.int64))
    row_depth = np.cumsum(step[:-1])
    total = 0
    for p in range(n_p):
        runs = row_depth > p
        for s in range(n_s):
            total += int(np.count_nonzero((gsgn[p, :, s] != 0) & runs))
    return total


@dataclass
class StageSlices:
    """One layer's output map, as the chain kernel follows it.

    ``sites`` ``[U, 4]``: output offset, width ``odim``, first slice, slice
    count — disjoint output ranges in ascending order.  ``slices`` ``[E, 5]``
    (a site's slices consecutive, in ``outg`` order): first row ``row0``,
    rows ``n`` (the pieces of :func:`stage_blocks` that hold its folded
    rows ``[row0, row0 + odim)``), levels to run ``depth``, its row ``j`` of
    ``outg``, and its site.  Output ``out_off + i`` of a site sums row
    ``row0 + i`` of each of its slices, except where ``holes[e]`` (offsets
    ``i`` of slice ``e``) marks an entry that reads the zero row.
    ``window`` ``[E, 2]``: the rows ``[in0, in1)`` of the prep buffer its
    first level reads.  ``live_terms``: terms with sign != 0 that the data
    needs, in the levels the pieces of :func:`stage_blocks` run (what a
    bound counts); ``run_terms``: those in the levels the slices run (each
    slice at its deepest piece's depth, rows outside every slice dropped)."""

    sites: np.ndarray
    slices: np.ndarray
    holes: dict
    window: np.ndarray
    live_terms: int
    run_terms: int


def _stage_name(ps: PackedStage) -> str:
    return "+".join(ps.site_names) or "(unnamed)"


def stage_slices(ps: PackedStage, layer: int) -> StageSlices:
    """Derive the chain kernel's output map of one layer from ``outg`` and
    the row layout, and check it against ``outg`` entry by entry.

    A site is a maximal run of outputs over which every row ``j`` of
    ``outg`` reads rows at one constant offset (``outg[j, o] - o``, entries
    that read the zero row ``R`` aside); its slices are the rows ``j`` that
    read any row there.  A slice's rows must start a piece of
    :func:`stage_blocks` (its later levels read nothing before it) and no
    two slices may share a row: a stage the map cannot express — a row read
    by two outputs, a slice whose first folded row lies inside another's
    rows — raises ``ValueError`` naming the stage, and is never evaluated
    otherwise."""
    name = _stage_name(ps)

    def refuse(msg):
        raise ValueError(f"stage {name} (layer {layer}): {msg}; the stage "
                         "kernel cannot evaluate it")

    r0p, r1p, depth_p, need_terms = stage_blocks(ps, layer)
    gsgn = ps.gsgn[layer]
    r = gsgn.shape[1]
    og = ps.outg[layer]
    n_j, n_o = og.shape
    if og.min() < 0 or og.max() > r:
        refuse(f"output gather outside [0, {r}]")
    hole = og == r
    ar = np.arange(n_o, dtype=np.int64)
    live = ~hole.all(axis=0)
    cut = np.zeros(n_o + 1, bool)
    cut[0] = cut[n_o] = True
    cut[1:n_o] = live[1:] != live[:-1]
    for j in range(n_j):
        d = og[j].astype(np.int64) - ar
        cut[1:n_o] |= ~hole[j, 1:] & ~hole[j, :-1] & (d[1:] != d[:-1])

    def runs(lo, hi, extra=None):
        c = cut[lo:hi + 1].copy()
        if extra is not None:
            c[1:-1] |= extra
        at = np.flatnonzero(c)
        return [(int(lo + a), int(lo + b)) for a, b in zip(at[:-1], at[1:])
                if live[lo + a]]

    def build(site_runs):
        """(site table, slice records, holes, bad site indices)."""
        sites, recs, holes, bad = [], [], {}, set()
        for u, (a, b) in enumerate(site_runs):
            blk, h = og[:, a:b], hole[:, a:b]
            js = np.flatnonzero(~h.all(axis=1))
            off = blk[js].astype(np.int64) - np.arange(b - a)
            top = np.where(h[js], np.iinfo(np.int64).min, off).max(axis=1)
            low = np.where(h[js], np.iinfo(np.int64).max, off).min(axis=1)
            sites.append((a, b - a, len(recs), js.size))
            for j, beta, ok in zip(js, top, top == low):
                k0 = int(np.searchsorted(r0p, beta))
                if (not ok or beta < 0 or beta + b - a > r or k0 >= r0p.size
                        or r0p[k0] != beta):
                    bad.add(u)
                    recs.append((0, 0, 0, int(j), u))
                    continue
                k1 = int(np.searchsorted(r0p, beta + b - a - 1, side="right"))
                recs.append((int(beta), int(r1p[k1 - 1] - beta),
                             int(depth_p[k0:k1].max()), int(j), u))
                hj = np.flatnonzero(h[j])
                if hj.size:
                    holes[len(recs) - 1] = hj
        rows = np.asarray([(x[0], x[0] + x[1], x[4]) for x in recs
                           if x[1] > 0], np.int64).reshape(-1, 3)
        rows = rows[np.argsort(rows[:, 0], kind="stable")]
        over = np.flatnonzero(rows[1:, 0] < rows[:-1, 1])
        bad.update(int(u) for u in rows[over, 2])
        bad.update(int(u) for u in rows[over + 1, 2])
        return sites, recs, holes, bad

    site_runs = runs(0, n_o)
    sites, recs, holes, bad = build(site_runs)
    if bad:
        # a site merged across a change of its slice count (a one-slice site
        # beside one with more slices at the same offset): split the failing
        # runs where the pattern of zero-row entries changes, once
        split = []
        for u, (a, b) in enumerate(site_runs):
            if u in bad:
                split += runs(a, b, (hole[:, a + 1:b] != hole[:, a:b - 1]).any(axis=0))
            else:
                split.append((a, b))
        sites, recs, holes, bad = build(split)
        if bad:
            refuse("an output reads rows no slice of the table holds "
                   "(a row read twice, or a slice starting inside another)")
    sites = np.asarray(sites, np.int64).reshape(-1, 4)
    slices = np.asarray(recs, np.int64).reshape(-1, 5)
    # the map reproduces outg entry by entry
    covered = np.zeros(n_o, bool)
    for a, w, first, count in sites:
        want = np.full((n_j, w), r, og.dtype)
        for e in range(first, first + count):
            want[slices[e, 3]] = slices[e, 0] + np.arange(w)
            if e in holes:
                want[slices[e, 3], holes[e]] = r
        if not np.array_equal(want, og[:, a: a + w]):
            refuse("the derived output map differs from outg")
        covered[a: a + w] = True
    if not (og[:, ~covered] == r).all():
        refuse("the derived output map differs from outg")
    # the first level's read window of each slice: [in0, in1) of the prep
    # buffer (empty where the slice reads nothing)
    g0, s0 = ps.gidx[layer, 0], gsgn[0]
    big = np.iinfo(np.int32).max
    lo = np.full(r + 1, big, np.int32)
    hi = np.full(r + 1, -1, np.int32)
    for s in range(g0.shape[1]):
        on = s0[:, s] != 0
        np.minimum(lo[:r], np.where(on, g0[:, s], big), out=lo[:r])
        np.maximum(hi[:r], np.where(on, g0[:, s], -1), out=hi[:r])
    window = np.zeros((slices.shape[0], 2), np.int64)
    if slices.size:
        order = np.argsort(slices[:, 0])
        at = np.stack([slices[order, 0], slices[order, 0] + slices[order, 1]],
                      axis=1).ravel()
        w_lo = np.minimum.reduceat(lo, at)[::2]
        w_hi = np.maximum.reduceat(hi, at)[::2] + 1
        window[order] = np.where((w_hi > 0)[:, None],
                                 np.stack([w_lo, w_hi], axis=1), 0)
    return StageSlices(sites=sites, slices=slices, holes=holes, window=window,
                       live_terms=need_terms,
                       run_terms=_live_terms(gsgn, slices[:, 0],
                                             slices[:, 0] + slices[:, 1],
                                             slices[:, 2]))


def _check_stage(ps: PackedStage) -> None:
    """Host-side validation, once per upload (layer by layer, so the
    temporaries stay small): every index inside its buffer, every live
    exponent inside the float32 exponent field."""
    if ps.has_prep:
        if (ps.prep_src.min() < 0 or ps.prep_src.max() >= ps.d_src
                or ps.prep_tgt.min() < 0 or ps.prep_tgt.max() >= ps.k_alloc):
            raise ValueError("stage prep pairs address rows outside the stage")
    if not ps.has_fp:
        return
    if not ps.has_prep:
        raise ValueError("a stage with streams needs prep pairs (level 0 "
                         "reads the prep buffer)")
    r = ps.gidx.shape[2]
    for l in range(ps.n_layers):
        live = ps.gsgn[l] != 0
        g0 = ps.gidx[l, 0]
        if ((g0 < 0) | (g0 >= ps.k_alloc))[live[0]].any():
            raise ValueError("stage level 0 reads a row outside the prep buffer")
        if (ps.gexp[l] < -126)[live].any():
            raise ValueError("stage exponent outside the float32 exponent range")
    if ps.outg.min() < 0 or ps.outg.max() > r:
        raise ValueError(f"stage output gather outside [0, {r}]")


def plan_stage(n: int, s: int, b: int) -> tuple[int, int, int, int, int]:
    """Geometry of the chain kernel for slices of up to ``n`` rows at ``s``
    terms a row and ``b`` batch columns: ``(bb, threads, tile, stages,
    blocks a SM)``.  The K1/K2 planner's rules (:func:`~repro_torch.kernels.
    lcc_chain_matmul.plan_launch`, :func:`~repro_torch.kernels.
    lcc_chain_matmul.launch_staging`): rows fixed to 512 row threads (256
    where two blocks then fit an SM; up to 960 at one column above 16384
    rows) beside two copy warps; ``bb`` the widest of 8/4/2/1 not beyond the
    batch whose register sums (rows a thread x ``bb`` <= 32) and two
    ``[n, bb]`` float32 buffers plus a staging ring of ``tile``-row slots
    fit the 232,448 bytes of shared memory a block may use.  Raises
    ``NotImplementedError`` above that."""
    try:
        bb, threads, _, _ = plan_launch(n, b, 1, 1, 1, s)
    except NotImplementedError:
        raise NotImplementedError(
            f"stage_matmul kernel: a slice of {n} rows needs {2 * n * 4} "
            f"bytes of shared memory per batch column plus a staging ring "
            f"for {s} terms a row, beyond a block's limit (or more than "
            f"{MAX_SUMS} rows a thread)") from None
    tile, stages, smem = launch_staging(n, s, bb, threads)
    per_sm = 2 if threads <= 256 and 2 * (smem + 1024) <= SM_SMEM else 1
    return bb, threads, tile, stages, per_sm


def plan_units(costs: list[np.ndarray], want: int) -> list[tuple[int, int, int]]:
    """Split sites into chunks of consecutive slices: ``[(site, e0, e1)]``
    with ``e0``/``e1`` slice offsets inside the site, sites in order, each
    site's chunks in slice order, every slice in exactly one chunk.
    ``costs[u]`` holds site ``u``'s per-slice work (rows x levels).  The
    sites share ``want`` chunks (one wave of blocks) in proportion to their
    work — each site at least one, none more than its slices — and a
    site's slices are dealt evenly over its chunks."""
    n = [c.size for c in costs]
    tot = [float(c.sum()) for c in costs]
    k = [1 if m else 0 for m in n]
    spare = max(0, want - sum(k))
    while spare:
        grow = [u for u in range(len(n)) if 0 < k[u] < n[u]]
        if not grow:
            break
        u = max(grow, key=lambda v: (tot[v] / k[v], -v))
        k[u] += 1
        spare -= 1
    out = []
    for u, (m, ku) in enumerate(zip(n, k)):
        if m:
            spb = -(-m // ku)
            out += [(u, e0, min(m, e0 + spb)) for e0 in range(0, m, spb)]
    return out


@dataclass
class StageLaunch:
    """One launch's geometry and work tables (one batch width, one layer
    or all).  The sites are grouped by their own geometry (:func:`plan_stage`
    at the site's longest slice): ``groups`` ``[(first unit, units, bb,
    threads, tile, stages, blocks a SM, rows)]``, each group one launch of
    the chain kernel over its units, one wave of chunks each.
    ``units [NU, 5]`` int32: layer (from the launch's first), first and end
    slice (global), first ``partial`` row, the site's width; ``esites [NS,
    4]``: output offset, width, first ``partial`` row, chunk count, per layer
    in output order; ``ebegin [nl + 1]``: each layer's first row of
    ``esites``."""

    groups: list
    units: torch.Tensor | None
    esites: torch.Tensor
    ebegin: torch.Tensor
    n_units: int
    partial_rows: int
    chunks: list  # host copy of the units: (layer, site, e0, e1)
    host_groups: np.ndarray = field(repr=False, default=None)  # [G, 7] int32

    @property
    def geometries(self) -> list[dict]:
        return [dict(units=g[1], bb=g[2], threads=g[3], tile=g[4],
                     stages=g[5], blocks_per_sm=g[6], rows=g[7])
                for g in self.groups]


@dataclass
class DeviceStage:
    """One stage's operands on one device.  The prep pairs come twice: in
    pair order (the plain version's ``index_add_``) and sorted by target with
    per-target offsets (the kernel's fixed-order sums).  Where the stage
    has streams, ``maps`` holds each layer's output map (:func:`stage_slices`)
    and ``slice_tab``/``hole_bits`` its device form: ``[E, 4]`` int32 row0,
    rows, depth, first word of its zero-row mask (-1: none), every layer's
    slices in one table; a mask bit set marks an output entry that reads the
    zero row."""

    ps: PackedStage
    device: torch.device
    prep_src: torch.Tensor | None  # [L, M] int32
    prep_tgt: torch.Tensor | None  # [L, M] int32
    prep_sorted_src: torch.Tensor | None  # [L, M] int32, pairs by target
    prep_off: torch.Tensor | None  # [L, K_alloc + 1] int32
    gidx: torch.Tensor | None  # [L, P, R, S] int32
    gexp: torch.Tensor | None  # [L, P, R, S] int8
    gsgn: torch.Tensor | None  # [L, P, R, S] int8
    outg: torch.Tensor | None  # [L, J, O] int32 (the plain version's)
    fs_mat: torch.Tensor | None
    dw_mat: torch.Tensor | None
    bias: torch.Tensor | None
    fs_live: tuple[bool, ...] = ()  # per layer: the block holds a nonzero
    dw_live: tuple[bool, ...] = ()
    bias_live: tuple[bool, ...] = ()
    maps: tuple[StageSlices, ...] = ()
    slice_base: tuple[int, ...] = ()  # each layer's first row of slice_tab
    slice_tab: torch.Tensor | None = None
    hole_bits: torch.Tensor | None = None
    max_rows: int = 0  # the longest slice
    live_terms: tuple[int, ...] = ()  # per layer, what the data needs
    _geometry: dict = field(default_factory=dict, repr=False)
    _launches: dict = field(default_factory=dict, repr=False)

    @property
    def dims(self) -> dict:
        """(M, K, P, R, S, J, O, D) of the stage, ``E``/``U`` its slices and
        sites (the largest layer's)."""
        ps = self.ps
        p, r, s = ps.gidx.shape[1:] if ps.has_fp else (0, 0, 0)
        return dict(M=ps.prep_src.shape[1] if ps.has_prep else 0,
                    K=ps.k_alloc if ps.has_prep else 0, P=p, R=r, S=s,
                    J=ps.outg.shape[1] if ps.has_fp else 0, O=ps.out_dim,
                    D=ps.d_src,
                    E=max((m.slices.shape[0] for m in self.maps), default=0),
                    U=max((m.sites.shape[0] for m in self.maps), default=0))

    def shape_key(self, b: int, n_layers: int, mode: tuple = ()) -> tuple:
        """``(P, R, S, K_alloc, D_src, O, J, B, layers per launch)``, then
        the modes that are not the plain ones (:func:`stage_matmul`): the
        gathered input ``("gather", d, T)``, then the epilogue's output mode
        ``("gated",)`` or ``("combine", T, k)``."""
        d = self.dims
        return (d["P"], d["R"], d["S"], d["K"], d["D"], d["O"], d["J"], b,
                n_layers, *mode)

    def geometry(self, b: int) -> tuple[int, int, int, int, int]:
        """``(bb, threads, tile, stages, blocks a SM)`` of the chain kernel
        at ``b`` batch columns for the longest slice (:func:`plan_stage`;
        a launch plans each site at its own).  Refuses a stage whose
        longest slice does not fit one block."""
        if b not in self._geometry:
            self._geometry[b] = plan_stage(max(self.max_rows, 1),
                                           self.dims["S"], b)
        return self._geometry[b]

    def launch(self, b: int, layer: int | None, sm_count: int) -> StageLaunch:
        """The launch at ``b`` columns of one layer (or all, ``None``): each
        site at its own geometry, one wave of slice chunks a geometry
        (:func:`plan_units`), uploaded once and kept."""
        key = (b, layer, sm_count)
        if key not in self._launches:
            self._launches[key] = self.make_launch(b, layer, sm_count)
        return self._launches[key]

    def make_launch(self, b, layer, sm_count, *, geometry=None,
                    want=None) -> StageLaunch:
        """A launch as :meth:`launch` plans it, or (a geometry sweep's) with
        every site at ``geometry`` (``(bb, threads, tile, stages, blocks a
        SM)``) and ``want`` chunks a group; not kept."""
        layers = range(self.ps.n_layers) if layer is None else [layer]
        s_terms = self.dims["S"]
        sites, groups = [], {}  # geometry -> [(site, costs, rows)]
        for li, l in enumerate(layers):
            m = self.maps[l] if self.ps.has_fp else None
            for u in range(0 if m is None else m.sites.shape[0]):
                first, count = m.sites[u, 2], m.sites[u, 3]
                sl = m.slices[first: first + count]
                rows = int(sl[:, 1].max())
                geo = tuple(geometry or plan_stage(rows, s_terms, b))
                groups.setdefault(geo, []).append(
                    (len(sites), (sl[:, 1] * sl[:, 2]).astype(np.float64), rows))
                sites.append((li, l, u))
        units, chunks, plan_groups, prow, per_site_rows = [], [], [], 0, {}
        for geo, members in groups.items():
            bb, threads, tile, stages, per_sm = geo
            w = want or max(1, sm_count * per_sm // -(-b // bb))
            first_unit = len(units)
            for gi, e0, e1 in plan_units([c for _, c, _ in members], w):
                su = members[gi][0]
                li, l, u = sites[su]
                m = self.maps[l]
                odim = int(m.sites[u, 1])
                g0 = self.slice_base[l] + int(m.sites[u, 2])
                per_site_rows.setdefault(su, [prow, 0])[1] += 1
                units.append((li, g0 + e0, g0 + e1, prow, odim))
                chunks.append((l, u, e0, e1))
                prow += odim
            plan_groups.append((first_unit, len(units) - first_unit, bb,
                                threads, tile, stages, per_sm,
                                max(r for _, _, r in members)))
        esites, ebegin = [], [0]
        for li in range(len(layers)):
            for su, (li2, l, u) in enumerate(sites):
                if li2 == li and su in per_site_rows:
                    m = self.maps[l]
                    esites.append((int(m.sites[u, 0]), int(m.sites[u, 1]),
                                   *per_site_rows[su]))
            ebegin.append(len(esites))
        dev = self.device

        def t(a, shape):
            return torch.as_tensor(np.asarray(a, np.int32).reshape(shape),
                                   device=dev)

        host = np.asarray([(g[0], g[1], g[2], g[3], g[4], g[5], g[7])
                           for g in plan_groups], np.int32).reshape(-1, 7)
        return StageLaunch(
            groups=plan_groups, units=t(units, (-1, 5)) if units else None,
            esites=t(esites if esites else [(0, 0, 0, 0)], (-1, 4)),
            ebegin=t(ebegin, (-1,)), n_units=len(units), partial_rows=prow,
            chunks=chunks, host_groups=np.ascontiguousarray(host))


def _tensor(a, device):
    return None if a is None else dispatch.upload(np.ascontiguousarray(a), device)


def _upload(ps: PackedStage, device: torch.device) -> DeviceStage:
    _check_stage(ps)
    n_l = ps.n_layers
    sorted_src = off = None
    if ps.has_prep:
        sorted_src = np.empty_like(ps.prep_src)
        off = np.zeros((n_l, ps.k_alloc + 1), np.int32)
        for l in range(n_l):
            tgt = ps.prep_tgt[l].astype(np.int64)
            order = np.argsort(tgt, kind="stable")
            sorted_src[l] = ps.prep_src[l][order]
            np.cumsum(np.bincount(tgt, minlength=ps.k_alloc), out=off[l, 1:])

    def live(a):
        return (tuple(bool(np.any(a[l])) for l in range(n_l))
                if a is not None else (False,) * n_l)

    ds = DeviceStage(
        ps=ps, device=device, prep_src=_tensor(ps.prep_src, device),
        prep_tgt=_tensor(ps.prep_tgt, device),
        prep_sorted_src=_tensor(sorted_src, device),
        prep_off=_tensor(off, device), gidx=_tensor(ps.gidx, device),
        gexp=_tensor(ps.gexp, device), gsgn=_tensor(ps.gsgn, device),
        outg=_tensor(ps.outg, device), fs_mat=_tensor(ps.fs_mat, device),
        dw_mat=_tensor(ps.dw_mat, device), bias=_tensor(ps.bias, device),
        fs_live=live(ps.fs_mat), dw_live=live(ps.dw_mat),
        bias_live=live(ps.bias))
    if ps.has_fp:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as pool:  # numpy frees the GIL
            maps = tuple(pool.map(lambda l: stage_slices(ps, l), range(n_l)))
        tab, bits, base = [], [], []
        for m in maps:
            base.append(len(tab))
            for e, (row0, n, depth, _, u) in enumerate(m.slices):
                word = -1
                if e in m.holes:  # bit i of word k: offset 32 k + i reads R
                    word = len(bits)
                    mask = np.zeros(-(-int(m.sites[u, 1]) // 32) * 32, np.uint64)
                    mask[m.holes[e]] = 1
                    bits += (mask.reshape(-1, 32) << np.arange(32, dtype=np.uint64)
                             ).sum(axis=1).tolist()
                tab.append((row0, n, depth, word))
        ds.maps, ds.slice_base = maps, tuple(base)
        ds.slice_tab = _tensor(np.asarray(tab, np.int32).reshape(-1, 4), device)
        ds.hole_bits = _tensor(np.asarray(bits or [0], np.uint64)
                               .astype(np.uint32).view(np.int32), device)
        ds.max_rows = max((int(m.slices[:, 1].max()) for m in maps
                           if m.slices.size), default=0)
        ds.live_terms = tuple(m.live_terms for m in maps)
    _check_ranges(ds)
    return ds


_INT32_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535  # the chain kernel puts its chunks on grid y


def _check_ranges(ds: DeviceStage) -> None:
    """The kernels take every dimension as a 32-bit int and index rows
    (< R, < K_alloc) and per-layer offsets in 32 bits; flat offsets into
    ``[L, P, R, S]`` are formed in 64 bits (a layer of mixtral's expert
    stage holds 1.3e9 slots, two layers more than 2^31).  A chain launch
    has a chunk for every site of the layers it runs, at most one grid row
    each.  Refuse a stage whose dimensions or sites do not fit."""
    big = {k: v for k, v in ds.dims.items() if v > _INT32_MAX}
    if big:
        raise ValueError(f"stage dimensions beyond 32 bits: {big}")
    sites = sum(m.sites.shape[0] for m in ds.maps)
    if sites > _GRID_Y_MAX:
        raise ValueError(f"stage has {sites} sites over its layers, the "
                         f"chain kernel's grid takes {_GRID_Y_MAX} chunks")


def device_stage(ps: PackedStage, device) -> DeviceStage:
    """The stage's operands on ``device``, uploaded (and validated) at first
    use and cached on the stage."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in ps._dev:
        ps._dev[device] = _upload(ps, device)
    return ps._dev[device]


# ------------------------------------------------------------ K6: a stage


def _stage_layer_plain(ds: DeviceStage, l: int, src: torch.Tensor
                       ) -> torch.Tensor:
    """One layer of a stage in PyTorch operations: src [D_src, B] -> [O, B].
    The ``segs`` descriptors, when present, skip the all-identity levels and
    the term columns no active row uses."""
    ps = ds.ps
    src = src.to(torch.float32)
    b = src.shape[1]
    out = torch.zeros((ps.out_dim, b), dtype=torch.float32, device=src.device)
    inbuf = None
    if ps.has_prep:
        inbuf = torch.zeros((ps.k_alloc, b), dtype=torch.float32,
                            device=src.device)
        inbuf.index_add_(0, ds.prep_tgt[l].long(), src[ds.prep_src[l].long()])
    if ps.has_fp:
        n_p, r, s = ps.gidx.shape[1:]
        work = None
        for p in range(n_p):
            s_l = s
            if ps.segs is not None:
                a_end, _, s_live = (int(v) for v in ps.segs[l, p])
                if p > 0 and a_end == 0:
                    continue  # every chain has ended: an identity level
                s_l = max(s_live, 1)
            buf = inbuf if p == 0 else work
            g = buf[ds.gidx[l, p, :, :s_l].reshape(-1).long()].reshape(r, s_l, b)
            coef = signed_pow2(ds.gsgn[l, p, :, :s_l], ds.gexp[l, p, :, :s_l])
            work = (coef[..., None] * g).sum(dim=1)
        wext = torch.cat([work, work.new_zeros((1, b))])
        n_j = ps.outg.shape[1]
        out = out + wext[ds.outg[l].reshape(-1).long()].reshape(
            n_j, ps.out_dim, b).sum(dim=0)
    if ps.fs_mat is not None:
        out = out + ds.fs_mat[l] @ inbuf
    if ps.dw_mat is not None:
        out = out + ds.dw_mat[l] @ src
    if ps.bias is not None:
        out = out + ds.bias[l][:, None]
    return out


def _stage_mode(ps: PackedStage, layer, resid, gated, combine) -> tuple:
    """Checks the output mode of one stage application, on every device:
    ``()`` (plain), ``("gated",)`` or ``("combine", T, k)``."""
    if not (gated or combine is not None):
        return ()
    if gated and combine is not None:
        raise ValueError("gated= and combine= are two output modes; pass one")
    if layer is None:
        raise ValueError("an output mode needs layer=")
    if resid is not None:
        raise ValueError("resid= is the plain mode's; the combining mode "
                         "takes its residual in combine=")
    if gated:
        if ps.out_dim % 2:
            raise ValueError(f"gated mode needs an even output width, the "
                             f"stage has {ps.out_dim}")
        return ("gated",)
    x, slot, wgt = combine
    d = x.shape[0] if x.dim() == 2 else 0
    if d <= 0 or ps.out_dim % d:
        raise ValueError(f"combine: x of shape {tuple(x.shape)} does not "
                         f"divide the stage's {ps.out_dim} outputs into experts")
    t = x.shape[1]
    if slot.dim() != 2 or slot.shape[0] != t or slot.shape[1] <= 0:
        raise ValueError(f"combine: slot has shape {tuple(slot.shape)}, "
                         f"expected ({t}, k)")
    if tuple(wgt.shape) != tuple(slot.shape):
        raise ValueError(f"combine: wgt has shape {tuple(wgt.shape)}, slot "
                         f"{tuple(slot.shape)}")
    return ("combine", t, slot.shape[1])


def _stage_input(ps: PackedStage, src, layer, resid, gather, combine
                 ) -> tuple[int, tuple]:
    """Checks the input of one stage application, on every device:
    ``(B, ())`` for the dense ``src``, ``(cap, ("gather", d, T))`` for the
    gathered input ``gather=(h2 [d, T], slot [T, k], src_tok [E * cap])``
    (``D_src = E * d``); with ``combine=`` (checked by :func:`_stage_mode`)
    both must route the same T tokens over the same E experts."""
    if gather is None:
        if src is None:
            raise ValueError("a stage reads src, or gather=")
        return src.shape[-1], ()
    if src is not None:
        raise ValueError("gather= is the stage's input: pass src=None")
    if layer is None:
        raise ValueError("the gathered input needs layer=")
    if resid is not None:
        raise ValueError("resid= is the dense input's; the gathered input "
                         "takes none")
    h2, slot, src_tok = gather
    d = h2.shape[0] if h2.dim() == 2 else 0
    if d <= 0 or ps.d_src % d:
        raise ValueError(f"gather: h2 of shape {tuple(h2.shape)} does not "
                         f"divide the stage's {ps.d_src} inputs into experts")
    n_exp, t = ps.d_src // d, h2.shape[1]
    if slot.dim() != 2 or slot.shape[0] != t or slot.shape[1] <= 0:
        raise ValueError(f"gather: slot has shape {tuple(slot.shape)}, "
                         f"expected ({t}, k)")
    n = src_tok.numel()
    if src_tok.dim() != 1 or n <= 0 or n % n_exp:
        raise ValueError(f"gather: src_tok has shape {tuple(src_tok.shape)}, "
                         f"expected ({n_exp} * cap,)")
    if combine is not None and (combine[0].shape[1] != t or
                                ps.out_dim // combine[0].shape[0] != n_exp):
        raise ValueError("gather= and combine= route different tokens")
    return n // n_exp, ("gather", d, t)


def stage_matmul_plain(ps: PackedStage, src: torch.Tensor | None, *,
                       layer: int | None = None,
                       resid: torch.Tensor | None = None, gated: bool = False,
                       combine: tuple | None = None,
                       gather: tuple | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`stage_matmul` (same arguments): the
    kernel's arithmetic step by step, sums in PyTorch's own order; the
    gathered input :func:`~repro_torch.kernels.moe_route.moe_dispatch_plain`
    (the reference's scatter-add), the gated mode ``F.silu(out[:n]) *
    out[n:]``, the combining mode
    :func:`~repro_torch.kernels.moe_route.moe_combine_plain`."""
    mode = _stage_mode(ps, layer, resid, gated, combine)
    b, gmode = _stage_input(ps, src, layer, resid, gather, combine)
    if gmode:
        h2, slot, src_tok = gather
        src = moe_dispatch_plain(h2, slot, src_tok, ps.d_src // gmode[1], b)
    ds = device_stage(ps, src.device)
    if layer is None:
        if resid is not None:
            raise ValueError("resid= needs layer=")
        return torch.stack([_stage_layer_plain(ds, l, src[l])
                            for l in range(ps.n_layers)])
    out = _stage_layer_plain(ds, layer, src)
    if mode and mode[0] == "gated":
        n = ps.out_dim // 2
        return F.silu(out[:n]) * out[n:]
    if mode:
        x, slot, wgt = combine
        return moe_combine_plain(x, out, slot, wgt, ps.out_dim // x.shape[0], b)
    return out if resid is None else resid + out


def stage_apply_eff(ps: PackedStage, src: torch.Tensor, layer: int
                    ) -> torch.Tensor:
    """The reference's folded-effective evaluation of one layer (one product
    with ``ps.eff``): a test surface only, never on the serving path."""
    eff = torch.from_numpy(ps.eff[layer]).to(src.device)
    out = eff @ src.to(torch.float32)
    if ps.bias is not None and np.any(ps.bias[layer]):
        out = out + torch.from_numpy(ps.bias[layer]).to(src.device)[:, None]
    return out


def _ptr(t: torch.Tensor | None, layer: int = 0) -> int | None:
    """Address of layer ``layer`` of a contiguous ``[L, ...]`` tensor."""
    if t is None:
        return None
    return t.data_ptr() + layer * (t[0].numel() if t.dim() else 0) * t.element_size()


_sm_count: dict[int, int] = {}


def stage_matmul(ps: PackedStage, src: torch.Tensor | None, *,
                 layer: int | None = None,
                 resid: torch.Tensor | None = None, gated: bool = False,
                 combine: tuple | None = None,
                 gather: tuple | None = None) -> torch.Tensor:
    """Apply a stage: ``src [L, D_src, B] -> [L, O, B]`` over every layer in
    one launch, or with ``layer=l``: ``src [D_src, B] -> [O, B]`` for layer
    ``l`` alone, plus ``resid [O, B]`` when given (the decode step's residual
    add, folded into the kernel's epilogue).

    With ``layer=``, the epilogue can write in place of the ``[O, B]``
    output what the decode step reads of it (one mode at a time, no
    ``resid``):

    * ``gated=True`` — SwiGLU of the gate rows ``[0, n)`` and the up rows
      ``[n, 2 n)``, ``n = O / 2``: ``silu(out[:n]) * out[n:]``, ``[n, B]``;
    * ``combine=(x, slot, wgt)`` — an MoE layer's combine over the expert
      outputs ``out [E * d, cap]`` (e-major, ``B = cap``) for ``T`` tokens:
      ``x [d, T] + y``, ``y[:, t] = sum_j wgt[t, j] * out[e_j * d :, c_j]``
      over the kept choices j in order, ``(e_j, c_j) = divmod(slot[t, j],
      cap)`` (``slot``/``wgt [T, k]`` int32/float32 as
      :func:`~repro_torch.kernels.moe_route.moe_route` gives them; a slot
      outside ``[0, E * cap)`` is dropped).  Returns ``[d, T]``.

    With ``layer=`` and ``src=None``, the stage can read an MoE layer's
    expert input where it stands, independently of the output mode (no
    ``resid``):

    * ``gather=(h2, slot, src_tok)`` — ``src [E * d, cap]`` (e-major, ``D_src
      = E * d``) as the reference's dispatch forms it from ``h2 [d, T]``:
      ``src[e * d + i, c] = h2[i, src_tok[e * cap + c]]``, zero where
      ``src_tok`` is -1 (``slot [T, k]``/``src_tok [E * cap]`` int32 as
      :func:`~repro_torch.kernels.moe_route.moe_route` gives them; the
      kernel reads ``src_tok``, the plain version scatter-adds through
      ``slot``).  ``B = cap``.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`stage_matmul_plain`."""
    mode = _stage_mode(ps, layer, resid, gated, combine)
    b, gmode = _stage_input(ps, src, layer, resid, gather, combine)
    if not dispatch.on_device(src if gather is None else gather[0]):
        return stage_matmul_plain(ps, src, layer=layer, resid=resid,
                                  gated=gated, combine=combine, gather=gather)
    dev = (src if gather is None else gather[0]).device
    ds = device_stage(ps, dev)
    l0, nl = (0, ps.n_layers) if layer is None else (layer, 1)
    if not 0 <= l0 < ps.n_layers:
        raise ValueError(f"layer {layer} outside [0, {ps.n_layers})")
    if gmode:
        h2, slot, src_tok = gather
        _, d, t = gmode
        dispatch.check_tensor("h2", h2, torch.float32, (d, t), dev)
        dispatch.check_tensor("slot", slot, torch.int32, (t, slot.shape[1]), dev)
        dispatch.check_tensor("src_tok", src_tok, torch.int32,
                              (ps.d_src // d * b,), dev)
    else:
        lead = (nl,) if layer is None else ()
        dispatch.check_tensor("src", src, torch.float32, (*lead, ps.d_src, b),
                              dev)
    if resid is not None:
        if layer is None:
            raise ValueError("resid= needs layer=")
        dispatch.check_tensor("resid", resid, torch.float32, (ps.out_dim, b), dev)
    if mode and mode[0] == "combine":
        x, slot, wgt = combine
        _, t, k = mode
        dispatch.check_tensor("x", x, torch.float32, (x.shape[0], t), dev)
        dispatch.check_tensor("slot", slot, torch.int32, (t, k), dev)
        dispatch.check_tensor("wgt", wgt, torch.float32, (t, k), dev)
    if b <= 0:
        raise ValueError("empty batch")
    return _launch_stage(ds, src, layer, resid, ds.launch(b, layer, _sms(dev)),
                         mode=mode, combine=combine, gather=gather)


def stage_args(ds: DeviceStage, src: torch.Tensor | None, layer: int | None,
               resid: torch.Tensor | None, plan: StageLaunch,
               out: torch.Tensor, b: int | None = None
               ) -> tuple[list, list, list]:
    """The pointer and size arguments of one launch of ``plan`` at ``b``
    columns (default ``src``'s) that every mode shares — ``(src ... resid
    out, nl D B M K P R S O, scratch to keep alive)`` — the scratch (prep
    buffer, chunk sums) allocated; ``src`` None for the gathered input."""
    ps, dev, d = ds.ps, out.device, ds.dims
    l0, nl = (0, ps.n_layers) if layer is None else (layer, 1)
    b = src.shape[-1] if b is None else b
    inbuf = (torch.empty((nl, d["K"], b), dtype=torch.float32, device=dev)
             if d["K"] else None)
    partial = (torch.empty((plan.partial_rows, b), dtype=torch.float32,
                           device=dev) if plan.n_units else None)
    one = layer is not None

    def dense(t, live):  # a layer whose block is all zero adds nothing
        return None if t is None or (one and not live[l0]) else _ptr(t, l0)

    ptrs = [None if src is None else src.data_ptr(),
            _ptr(ds.prep_sorted_src, l0), _ptr(ds.prep_off, l0),
            _ptr(inbuf), _ptr(ds.gidx, l0), _ptr(ds.gexp, l0),
            _ptr(ds.gsgn, l0), _ptr(ds.slice_tab), _ptr(ds.hole_bits),
            _ptr(plan.units), plan.esites.data_ptr(), plan.ebegin.data_ptr(),
            _ptr(partial), dense(ds.fs_mat, ds.fs_live),
            dense(ds.dw_mat, ds.dw_live), dense(ds.bias, ds.bias_live),
            None if resid is None else resid.data_ptr(), out.data_ptr()]
    sizes = [nl, d["D"], b, d["M"], d["K"], d["P"], d["R"], d["S"], d["O"]]
    return ptrs, sizes, [inbuf, partial]


def _launch_stage(ds: DeviceStage, src: torch.Tensor | None,
                  layer: int | None, resid: torch.Tensor | None,
                  plan: StageLaunch, entry=None, mode: tuple = (),
                  combine: tuple | None = None,
                  gather: tuple | None = None) -> torch.Tensor:
    """Allocate the outputs and scratch of one launch of ``plan`` and launch
    it (``entry``: the C entry point, default the library's) in output mode
    ``mode`` (:func:`_stage_mode`), from ``src`` or the gathered input
    ``gather`` (:func:`_stage_input`); counts it."""
    ps, dev = ds.ps, ds.device
    nl = ps.n_layers if layer is None else 1
    b, gmode = _stage_input(ps, src, layer, resid, gather, combine)
    code_mode, n_exp, top_k, tokens, cx = 0, 0, 0, 0, (None, None, None)
    gx, d = (None, None), 0
    if gmode:
        _, d, tokens = gmode
        n_exp = ps.d_src // d
        gx = (gather[0].data_ptr(), gather[2].data_ptr())
    if not mode:
        shape = ((nl,) if layer is None else ()) + (ps.out_dim, b)
    elif mode[0] == "gated":
        code_mode, shape = 1, (ps.out_dim // 2, b)
    else:
        code_mode, (_, tokens, top_k) = 2, mode
        n_exp = ps.out_dim // combine[0].shape[0]
        shape = tuple(combine[0].shape)
        cx = tuple(t.data_ptr() for t in combine)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    ptrs, sizes, scratch = stage_args(ds, src, layer, resid, plan, out, b)
    fn = entry or build.load().repro_stage_matmul
    with torch.cuda.device(dev):
        code = fn(*ptrs, *cx, *gx, *sizes, code_mode, n_exp, top_k,
                  b if code_mode == 2 or gather else 0, tokens, d,
                  plan.host_groups.ctypes.data, len(plan.groups),
                  torch.cuda.current_stream().cuda_stream)
    del scratch  # enqueued: the caching allocator keeps it for the stream
    dispatch.check_launch(code, "repro_stage_matmul")
    dispatch.record_launch("stage_matmul",
                           shape=ds.shape_key(b, nl, gmode + mode))
    return out


# -------------------------------------------- K7: the decode attention

ATTN_TILE = 16  # live rows a ring slot holds (kAttnTile)
ATTN_RING = 3  # ring slots (kAttnRing)
ATTN_MAX_GROUP = 8  # query heads a kv-head (kMaxGroup)
ATTN_MAX_HD = 128  # head dimension: one float4 a lane and head
ATTN_CHUNK = 128  # slots a split takes at most, rounded up to a whole page
ATTN_BLOCKS_PER_SM = 4  # blocks a split aims to give every SM


@dataclass(frozen=True)
class AttentionPlan:
    """Geometry of one attention launch (``csrc/step_plan.cu``): the cache's
    S slots in ``splits`` chunks of ``chunk`` consecutive slots (the last
    may be shorter), one block a (split, kv-head, row) with ``smem`` bytes
    of dynamic shared memory; several splits merge in a second kernel
    (``merge_smem`` bytes)."""
    splits: int
    chunk: int
    smem: int
    merge_smem: int


def attention_smem(g: int, head_dim: int, chunk: int) -> int:
    """Bytes of shared memory of one attention block (the kernel's
    ``attention_smem_floats``): the ring, q, the new K/V rows, the chunk's
    logits, the live rows' cache offsets, the softmax statistics and the
    live list."""
    return 4 * (ATTN_RING * ATTN_TILE * head_dim + (g + 2) * head_dim
                + (ATTN_MAX_GROUP + 3) * chunk + 2 * ATTN_MAX_GROUP)


@functools.lru_cache(maxsize=None)
def plan_attention(b: int, nkv: int, g: int, s: int, sm_count: int,
                   paged: int | None, *, head_dim: int) -> AttentionPlan:
    """Split the decode attention over the cache (flash-decoding).

    ``b`` rows, ``nkv`` kv-heads of ``g`` query heads each, ``s`` cache
    slots, ``paged`` the page size of a paged cache (0 or None:
    contiguous).  The split count is the least that gives each of the
    ``sm_count`` SMs ``ATTN_BLOCKS_PER_SM`` blocks, so that a short cache's
    few live rows are read in parallel and their round trips overlap.  The
    chunk is then rounded up to a whole page (16 slots when contiguous) and
    held to at most ``ATTN_CHUNK`` slots (one page where a page is longer),
    so that a long cache gives several waves and shared memory is bounded
    by the chunk, not by S.  Raises
    ``ValueError`` for a shape the kernel cannot take: more than
    ``ATTN_MAX_GROUP`` query heads a group, a head dimension that is not a
    power of two from 4 to ``ATTN_MAX_HD``, or a page too long for shared
    memory."""
    if min(b, nkv, s, sm_count) <= 0:
        raise ValueError(f"attention of {b} rows, {nkv} kv-heads, {s} slots "
                         f"on {sm_count} SMs")
    if not 1 <= g <= ATTN_MAX_GROUP:
        raise ValueError(f"{g} query heads a kv-head: the attention kernel "
                         f"takes 1 to {ATTN_MAX_GROUP}")
    if not 4 <= head_dim <= ATTN_MAX_HD or head_dim & (head_dim - 1):
        raise ValueError(f"head dimension {head_dim}: the attention kernel "
                         f"takes a power of two from 4 to {ATTN_MAX_HD}")
    unit = int(paged or ATTN_TILE)
    if unit < 0:
        raise ValueError(f"page size {paged}")
    want = -(-ATTN_BLOCKS_PER_SM * sm_count // (b * nkv))
    chunk = -(-s // want)
    chunk = min(-(-chunk // unit), -(-ATTN_CHUNK // unit)) * unit
    splits = -(-s // chunk)
    plan = AttentionPlan(splits, chunk, attention_smem(g, head_dim, chunk),
                         4 * (splits + 1))
    if max(plan.smem, plan.merge_smem) > SMEM_LIMIT:
        raise ValueError(f"attention at {chunk} slots a chunk, {splits} "
                         f"splits, G = {g}, hd = {head_dim} needs "
                         f"{max(plan.smem, plan.merge_smem)} bytes of shared "
                         f"memory (limit {SMEM_LIMIT})")
    return plan


def attention_key(b, smax, nq, nkv, hd, bs, window) -> tuple:
    """Dimensions an attention launch is counted under: ``(B, S, Hq, Hkv,
    hd, page size (0: contiguous), window (0: none))``."""
    return (b, smax, nq, nkv, hd, bs, window or 0)


def _rot(v, cos, sin, half):
    v1, v2 = v[..., :half], v[..., half:]
    return torch.cat([v1 * cos - v2 * sin, v2 * cos + v1 * sin], dim=-1)


def step_attention_plain(qkv, pos, cos, sin, kc, vc, kpos, *, n_heads: int,
                         n_kv_heads: int, head_dim: int,
                         window: int | None = None, block_tbl=None):
    """Plain PyTorch version of :func:`step_attention` (same arguments): the
    reference's lines, operation by operation.  With ``block_tbl`` the
    caches are block pools and are gathered into the ``[B, S, Hkv, hd]``
    view first, as the reference's caller does."""
    b = qkv.shape[1]
    if block_tbl is not None:
        tbl = block_tbl.long()
        kc = kc[tbl].reshape(b, -1, *kc.shape[2:])
        vc = vc[tbl].reshape(b, -1, *vc.shape[2:])
    smax = kc.shape[1]
    nq, n_kv, hd = n_heads, n_kv_heads, head_dim
    half = hd // 2
    dev = qkv.device
    pos = pos.long()
    kc, vc = kc.to(torch.float32), vc.to(torch.float32)
    qb = qkv[: nq * hd].reshape(nq, hd, b).permute(2, 0, 1)
    kb = qkv[nq * hd: (nq + n_kv) * hd].reshape(n_kv, hd, b).permute(2, 0, 1)
    vb = qkv[(nq + n_kv) * hd:].reshape(n_kv, hd, b).permute(2, 0, 1)
    if cos is not None:
        cos_v = cos.to(torch.float32)[:, None, :]
        sin_v = sin.to(torch.float32)[:, None, :]
        qb, kb = _rot(qb, cos_v, sin_v, half), _rot(kb, cos_v, sin_v, half)
    sidx = torch.arange(smax, device=dev)[None, :].expand(b, smax)
    slot = (torch.where(pos >= 0, pos % smax, torch.full_like(pos, -1))
            if window is not None else pos)
    hit = sidx == slot[:, None]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                          device=dev))
    qg = qb.reshape(b, n_kv, nq // n_kv, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, kc)
    s_new = torch.einsum("bhgd,bhd->bhg", qg, kb)
    scores = torch.where(hit[:, None, None, :], s_new[..., None], scores)
    kp = kpos.long()
    ok = (kp >= 0) & (kp <= pos[:, None])
    if window is not None:
        ok = ok & (kp > pos[:, None] - window)
    valid = torch.where(hit, (pos >= 0)[:, None], ok)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mask = torch.where(valid, zero, zero + _NEG)
    probs = torch.softmax(scores * scale + mask[:, None, None, :], dim=-1)
    hitf = hit.to(torch.float32)[:, None, None, :]
    p_hit = torch.sum(probs * hitf, dim=-1)
    att = (torch.einsum("bhgs,bshd->bhgd", probs * (1.0 - hitf), vc)
           + p_hit[..., None] * vb[:, :, None, :])
    return (att.reshape(b, nq * hd).T.contiguous(), kb.contiguous(),
            vb.contiguous())


def _sms(dev: torch.device) -> int:
    di = dev.index if dev.index is not None else torch.cuda.current_device()
    if di not in _sm_count:
        _sm_count[di] = torch.cuda.get_device_properties(di).multi_processor_count
    return _sm_count[di]


def _cache_layout(kc, block_tbl, b, smax, nkv, hd, dev, lead=()):
    """``(page size, pages a row, cache shape)`` of one layer's cache (or of
    ``lead``-stacked layers), the block table checked; 0 pages when
    contiguous."""
    if block_tbl is None:
        return 0, 0, (*lead, b, smax, nkv, hd)
    mb = block_tbl.shape[1]
    bs = kc.shape[len(lead) + 1]
    dispatch.check_tensor("block_tbl", block_tbl, torch.int32, (b, mb), dev)
    if mb * bs != smax:
        raise ValueError(f"block table covers {mb * bs} slots, kpos {smax}")
    return bs, mb, (*lead, kc.shape[len(lead)], bs, nkv, hd)


def _attention_ws(plan: AttentionPlan, b, nkv, g, hd, dev):
    """Room for the splits' partial results, or None for one split."""
    if plan.splits == 1:
        return None
    return torch.empty(b * nkv * plan.splits * g * (hd + 2),
                       dtype=torch.float32, device=dev)


def _attend(lib, stream, plan: AttentionPlan, key: tuple, qkv, pos, cos, sin,
            kc_ptr, vc_ptr, kpos_ptr, block_tbl, kn_ptr, vn_ptr, ws, *, b,
            smax, nq, nkv, hd, bs, mb, window) -> torch.Tensor:
    """One launch of the attention kernels on checked arguments; counts it."""
    att = torch.empty((nq * hd, b), dtype=torch.float32, device=qkv.device)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    dispatch.check_launch(lib.repro_split_attention(
        qkv.data_ptr(), pos.data_ptr(), _ptr(cos), _ptr(sin), kc_ptr, vc_ptr,
        kpos_ptr, _ptr(block_tbl), att.data_ptr(), kn_ptr, vn_ptr, _ptr(ws),
        b, smax, nq, nkv, hd, bs, mb, window or 0, plan.splits, plan.chunk,
        scale, stream), "repro_split_attention")
    dispatch.record_launch("step_attention", shape=key)
    return att


def step_attention(qkv, pos, cos, sin, kc, vc, kpos, *, n_heads: int,
                   n_kv_heads: int, head_dim: int, window: int | None = None,
                   block_tbl=None):
    """RoPE and decode attention of one layer over its KV cache.

      qkv  [(Hq + 2 Hkv) hd, B] f32  the qkv stage's output (feature-major)
      pos  [B] int32     decode positions (-1 = idle slot)
      cos/sin [B, hd/2]  rope tables for ``pos`` (None: no rope)
      kc/vc [B, S, Hkv, hd], kpos [B, S]   the layer's KV cache
      block_tbl [B, mb] int32 (optional): kc/vc are then block pools
                         [Nb, bs, Hkv, hd] read through the table

    Returns ``(att [Hq hd, B], k_new [B, Hkv, hd], v_new)``: the attention
    output (feature-major) and the rotated new K row and the new V row for
    the caller to write back.  Scores are taken against the stale cache with
    the current slot patched in score space, as in the reference; the cache
    is read, never written.  CUDA tensors launch the kernels (split over the
    cache by :func:`plan_attention`, the splits merged in order) or raise;
    CPU tensors take :func:`step_attention_plain`."""
    if not dispatch.on_device(qkv):
        return step_attention_plain(
            qkv, pos, cos, sin, kc, vc, kpos, n_heads=n_heads,
            n_kv_heads=n_kv_heads, head_dim=head_dim, window=window,
            block_tbl=block_tbl)
    dev = qkv.device
    nq, nkv, hd = n_heads, n_kv_heads, head_dim
    if nq % nkv:
        raise ValueError(f"{nq} query heads over {nkv} kv-heads")
    b, smax = qkv.shape[1], kpos.shape[1]
    f32, i32 = torch.float32, torch.int32
    dispatch.check_tensor("qkv", qkv, f32, ((nq + 2 * nkv) * hd, b), dev)
    dispatch.check_tensor("pos", pos, i32, (b,), dev)
    dispatch.check_tensor("kpos", kpos, i32, (b, smax), dev)
    bs, mb, cache_shape = _cache_layout(kc, block_tbl, b, smax, nkv, hd, dev)
    dispatch.check_tensor("kc", kc, f32, cache_shape, dev)
    dispatch.check_tensor("vc", vc, f32, cache_shape, dev)
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin: both or neither")
    if cos is not None:
        dispatch.check_tensor("cos", cos, f32, (b, hd // 2), dev)
        dispatch.check_tensor("sin", sin, f32, (b, hd // 2), dev)
    g = nq // nkv
    plan = plan_attention(b, nkv, g, smax, _sms(dev), bs, head_dim=hd)
    kn = torch.empty((b, nkv, hd), dtype=f32, device=dev)
    vn = torch.empty_like(kn)
    with torch.cuda.device(dev):
        att = _attend(build.load(), torch.cuda.current_stream().cuda_stream,
                      plan, attention_key(b, smax, nq, nkv, hd, bs, window),
                      qkv, pos, cos, sin, kc.data_ptr(), vc.data_ptr(),
                      kpos.data_ptr(), block_tbl, kn.data_ptr(),
                      vn.data_ptr(), _attention_ws(plan, b, nkv, g, hd, dev),
                      b=b, smax=smax, nq=nq, nkv=nkv, hd=hd, bs=bs, mb=mb,
                      window=window)
    return att, kn, vn


# ------------------------------------------------------- K7: the norm


@dataclass(frozen=True)
class NormPlan:
    """Launch geometry of K7's norm on ``[d, B]``: a cluster of ``split``
    blocks a group of ``cols`` columns (a power of two <= 32), each block
    holding ``rows`` consecutive rows of the group's tile (``[rows, cols]``)
    in ``smem_bytes`` of shared memory, ``threads`` threads a block."""

    cols: int
    groups: int
    split: int
    rows: int
    threads: int
    smem_bytes: int


NORM_SPLIT = 8  # blocks a cluster over the rows (the portable cluster size)
NORM_NARROW_ROWS = 256  # rows a block at or under which groups are one column


def _norm_smem(rows: int, cols: int, threads: int, split: int) -> int:
    # the sub-tile, one partial sum a (warp, column), every block's sums of
    # both passes, the mean and 1/sd a column
    return 4 * (rows * cols + (threads // 32) * cols + 2 * split * cols
                + 2 * cols)


def _norm_threads(rows: int, cols: int) -> int:
    return min(1024, max(64, 1 << max(0, (rows * cols // 16 - 1).bit_length())))


def norm_geometry(d: int, b: int, cols: int, split: int) -> NormPlan:
    """The norm's launch on ``[d, B]`` at ``cols`` columns a cluster (a power
    of two <= 32) and ``split`` blocks a cluster (1 to 8), threads a power
    of two from 64 to 1024 sized to 16 sub-tile elements a thread.  Raises
    where these are out of range or one block's sub-tile does not fit its
    shared memory."""
    if d <= 0 or b <= 0:
        raise ValueError(f"norm of an empty [{d}, {b}] input")
    if cols < 1 or cols > 32 or cols & (cols - 1):
        raise ValueError(f"norm column group {cols}: a power of two <= 32")
    if not 1 <= split <= NORM_SPLIT:
        raise ValueError(f"norm split {split}: 1 to {NORM_SPLIT} blocks")
    rows = -(-d // split)
    threads = _norm_threads(rows, cols)
    smem = _norm_smem(rows, cols, threads, split)
    if smem > SMEM_LIMIT:
        raise ValueError(f"norm of [{d}, {b}]: a [{rows}, {cols}] sub-tile "
                         f"needs {smem} bytes of shared memory, a block has "
                         f"{SMEM_LIMIT}")
    return NormPlan(cols=cols, groups=-(-b // cols), split=split, rows=rows,
                    threads=threads, smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def plan_norm(d: int, b: int) -> NormPlan:
    """The norm's geometry (:func:`norm_geometry`): always a cluster of 8
    blocks over the rows; one column a cluster where a block holds at most
    256 rows (4-byte copies, B clusters: the most SMs pulling a small
    tile), else 4 columns where B is a multiple of 4 (16-byte copies), else
    the power of two at or above B, at most 32; halved while one block's
    sub-tile does not fit.  On the H100 these won at both plan serves'
    shapes (``tools/norm_sweep.py``; PERF.md).  Raises where not even one
    column fits."""
    rows = -(-d // NORM_SPLIT)
    if rows <= NORM_NARROW_ROWS:
        cols = 1
    else:
        cols = 4 if b % 4 == 0 else min(32, 1 << max(0, b - 1).bit_length())
    while cols > 1 and _norm_smem(rows, cols, _norm_threads(rows, cols),
                                  NORM_SPLIT) > SMEM_LIMIT:
        cols //= 2
    return norm_geometry(d, b, cols, NORM_SPLIT)


def step_norm_plain(x: torch.Tensor, w, norm: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`step_norm`: the reference's
    ``norm_fn`` on ``x [d, B]`` (rms with weight ``w [d]``, or the
    non-parametric layer norm, centred)."""
    if norm == "rms":
        var = torch.mean(x * x, dim=0, keepdim=True)
        return x * torch.rsqrt(var + 1e-6) * w[:, None]
    mu = torch.mean(x, dim=0, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=0, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def _norm_args(norm: str) -> tuple[int, float]:
    if norm == "rms":
        return 0, 1e-6
    if norm == "nonparam":
        return 1, 1e-5
    raise ValueError(f"norm {norm!r}: the step takes 'rms' or 'nonparam'")


def _norm_launch(lib, stream, x, w_ptr, plan: NormPlan, mode: int,
                 eps: float) -> torch.Tensor:
    """One launch of the norm kernel at ``plan``, unchecked (the callers
    checked ``x`` and the weight)."""
    d, b = x.shape
    out = torch.empty_like(x)
    dispatch.check_launch(lib.repro_step_norm(
        x.data_ptr(), w_ptr, out.data_ptr(), d, b, plan.cols, plan.split,
        plan.threads, mode, eps, stream), "repro_step_norm")
    dispatch.record_launch("step_norm", shape=(d, b))
    return out


def step_norm(x: torch.Tensor, w, norm: str) -> torch.Tensor:
    """K7's norm (the reference's ``norm_fn``, ``layer_plan.py:308-313``) of
    ``x [d, B]`` float32, features-major: ``norm == "rms"`` with weight ``w
    [d]``, or ``"nonparam"`` (``w`` None).  One launch of
    ``csrc/step_plan.cu``'s ``step_norm_kernel`` at :func:`plan_norm`'s
    geometry.  CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`step_norm_plain`."""
    mode, eps = _norm_args(norm)
    if not dispatch.on_device(x):
        return step_norm_plain(x, w, norm)
    d, b = x.shape
    dispatch.check_tensor("x", x, torch.float32, (d, b), x.device)
    if mode == 0:
        dispatch.check_tensor("w", w, torch.float32, (d,), x.device)
    elif w is not None:
        raise ValueError("the non-parametric layer norm takes no weight")
    plan = plan_norm(d, b)
    lib = build.load()
    with torch.cuda.device(x.device):
        return _norm_launch(lib, torch.cuda.current_stream().cuda_stream, x,
                            _ptr(w), plan, mode, eps)


# ------------------------------------------------- K7: the decode step


def step_plan_matmul_plain(stages: dict[str, PackedStage], *, n_heads: int,
                           n_kv_heads: int, head_dim: int, d_ff: int,
                           norm: str, rope: bool, x0, pos, cos, sin, ln1, ln2,
                           kc, vc, kpos, moe=None, window: int | None = None,
                           block_tbl=None):
    """Plain PyTorch version of :func:`step_plan_matmul` (same arguments):
    the reference's dense step body, operation by operation, the attention
    through :func:`step_attention_plain`, SwiGLU through the gated mode of
    :func:`stage_matmul_plain`.  With ``moe`` each layer's FFN is the
    routed block of the reference's ``moe_block``, through the plain
    versions of the route kernel and of the stages' gathered input and
    gated and combining modes."""
    n_layers, b = kpos.shape[0], x0.shape[1]

    kn = torch.empty((n_layers, b, n_kv_heads, head_dim), dtype=torch.float32,
                     device=x0.device)
    vn = torch.empty_like(kn)
    x = x0.to(torch.float32)
    for l in range(n_layers):
        h = step_norm_plain(x, ln1[l] if norm == "rms" else None, norm)
        qkv = stage_matmul_plain(stages["qkv"], h, layer=l)
        att, kn[l], vn[l] = step_attention_plain(
            qkv, pos, cos if rope else None, sin if rope else None, kc[l],
            vc[l], kpos[l], n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, window=window, block_tbl=block_tbl)
        x = x + stage_matmul_plain(stages["o"], att, layer=l)
        h2 = step_norm_plain(x, ln2[l] if norm == "rms" else None, norm)
        if moe is not None:
            x = _moe_layer_plain(stages, moe, l, h2, x)
            continue
        hf = stage_matmul_plain(stages["gu"], h2, layer=l, gated=True)
        x = x + stage_matmul_plain(stages["dn"], hf, layer=l)
    return x, kn, vn


def _moe_args(moe: dict, b: int, device) -> tuple:
    """``(router [L, d, E] f32 on device, E, k, cap)``."""
    n_exp, top_k = moe["n_experts"], moe["top_k"]
    cap = capacity(b, top_k, moe["capacity_factor"], n_exp,
                   moe.get("min_capacity", 4))
    router = torch.as_tensor(moe["router"], dtype=torch.float32, device=device)
    return router, n_exp, top_k, cap


def _moe_layer_plain(stages, moe, l, h2, x):
    """One layer's routed FFN plus residual (the reference's ``moe_block``):
    x [d, B] + experts(h2 [d, B])."""
    router, _, top_k, cap = _moe_args(moe, h2.shape[1], h2.device)
    sel, wgt, slot, src_tok = moe_route_plain(
        h2, router[l], top_k=top_k, cap=cap, norm_topk=moe["norm_topk"],
        dropped=moe.get("dropped"))
    hf = stage_matmul_plain(stages["eg"], None, layer=l, gated=True,
                            gather=(h2, slot, src_tok))
    return stage_matmul_plain(stages["ed"], hf, layer=l,
                              combine=(x, slot, wgt))


def step_plan_matmul(stages: dict[str, PackedStage], *, n_heads: int,
                     n_kv_heads: int, head_dim: int, d_ff: int, norm: str,
                     rope: bool, x0, pos, cos, sin, ln1, ln2, kc, vc, kpos,
                     moe=None, window: int | None = None, block_tbl=None):
    """Whole decode step for all L identical layers (dense and MoE families).

      x0   [d, B] f32    embedded tokens (feature-major)
      pos  [B] int32     decode positions (-1 = idle slot)
      cos/sin [B, hd/2]  rope tables for ``pos`` (None when rope=False)
      ln1/ln2 [L, d]     rms weights (None when norm == "nonparam")
      kc/vc [L, B, S, Hkv, hd], kpos [L, B, S]   the KV cache
      block_tbl [B, mb] int32 (optional): kc/vc are then block pools
                         [L, Nb, bs, Hkv, hd] read through the table

    ``moe`` (the MoE family, K8): every layer's FFN is the routed experts,
    stages ``eg``/``ed`` in place of ``gu``/``dn``.  Keys: ``router``
    [L, d, E] float32, ``n_experts``, ``top_k``, ``capacity_factor``,
    ``norm_topk``, ``min_capacity``, ``d_ff`` (= E * d_ff_expert) as in the
    reference, and optionally ``dropped`` (int32 ``[1]`` on the step's
    device), incremented by the dropped choices.  All B columns are routed,
    idle slots included, as in the reference.

    Returns ``(y [d, B], k_new [L, B, Hkv, hd], v_new)``: the final hidden
    state and the per-layer K/V rows for the caller to write back.  The cache
    is read, never written.  CUDA tensors launch the kernels (or raise); CPU
    tensors take :func:`step_plan_matmul_plain`."""
    args = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
                d_ff=d_ff, norm=norm, rope=rope, x0=x0, pos=pos, cos=cos,
                sin=sin, ln1=ln1, ln2=ln2, kc=kc, vc=vc, kpos=kpos, moe=moe,
                window=window, block_tbl=block_tbl)
    if not dispatch.on_device(x0):
        return step_plan_matmul_plain(stages, **args)
    dev = x0.device
    d, b = x0.shape
    nq, nkv, hd = n_heads, n_kv_heads, head_dim
    n_layers = kpos.shape[0]
    smax = kpos.shape[2]
    f32, i32 = torch.float32, torch.int32
    dispatch.check_tensor("x0", x0, f32, (d, b), dev)
    dispatch.check_tensor("pos", pos, i32, (b,), dev)
    dispatch.check_tensor("kpos", kpos, i32, (n_layers, b, smax), dev)
    bs, mb, cache_shape = _cache_layout(kc, block_tbl, b, smax, nkv, hd, dev,
                                        lead=(n_layers,))
    dispatch.check_tensor("kc", kc, f32, cache_shape, dev)
    dispatch.check_tensor("vc", vc, f32, cache_shape, dev)
    if rope:
        dispatch.check_tensor("cos", cos, f32, (b, hd // 2), dev)
        dispatch.check_tensor("sin", sin, f32, (b, hd // 2), dev)
    mode, eps = _norm_args(norm)
    if mode == 0:
        dispatch.check_tensor("ln1", ln1, f32, (n_layers, d), dev)
        dispatch.check_tensor("ln2", ln2, f32, (n_layers, d), dev)
    for name in _STAGE_ORDER if moe is None else _MOE_STAGE_ORDER:
        if stages[name].n_layers != n_layers:
            raise ValueError(f"stage {name} has {stages[name].n_layers} "
                             f"layers, the cache {n_layers}")
    if nq % nkv:
        raise ValueError(f"{nq} query heads over {nkv} kv-heads")
    ffn, ff = ("gu", d_ff) if moe is None else ("eg", moe["d_ff"])
    if stages[ffn].out_dim != 2 * ff:
        raise ValueError(f"stage {ffn} emits {stages[ffn].out_dim} rows, "
                         f"expected gates and ups of {ff}")
    nplan = plan_norm(d, b)
    g = nq // nkv
    aplan = plan_attention(b, nkv, g, smax, _sms(dev), bs, head_dim=hd)
    akey = attention_key(b, smax, nq, nkv, hd, bs, window)
    rcos, rsin = (cos, sin) if rope else (None, None)
    if moe is not None:
        router, n_exp, top_k, cap = _moe_args(moe, b, dev)
        dispatch.check_tensor("router", router, f32, (n_layers, d, n_exp), dev)
        if stages["eg"].d_src != n_exp * d:
            raise ValueError(f"stage eg reads {stages['eg'].d_src} rows, "
                             f"expected {n_exp} experts' inputs of {d}")
    kn = torch.empty((n_layers, b, nkv, hd), dtype=f32, device=dev)
    vn = torch.empty_like(kn)
    ws = _attention_ws(aplan, b, nkv, g, hd, dev)  # reused by every layer
    lib = build.load()

    def norm_(x, w, l):
        return _norm_launch(lib, stream, x, _ptr(w, l), nplan, mode, eps)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        x = x0
        for l in range(n_layers):
            h = norm_(x, ln1, l)
            qkv = stage_matmul(stages["qkv"], h, layer=l)
            att = _attend(lib, stream, aplan, akey, qkv, pos, rcos, rsin,
                          _ptr(kc, l), _ptr(vc, l), _ptr(kpos, l), block_tbl,
                          _ptr(kn, l), _ptr(vn, l), ws, b=b, smax=smax, nq=nq,
                          nkv=nkv, hd=hd, bs=bs, mb=mb, window=window)
            x = stage_matmul(stages["o"], att, layer=l, resid=x)
            h2 = norm_(x, ln2, l)
            if moe is None:
                hf = stage_matmul(stages["gu"], h2, layer=l, gated=True)
                x = stage_matmul(stages["dn"], hf, layer=l, resid=x)
                continue
            sel, wgt, slot, src_tok = moe_route(
                h2, router[l], top_k=top_k, cap=cap,
                norm_topk=moe["norm_topk"], dropped=moe.get("dropped"))
            hf = stage_matmul(stages["eg"], None, layer=l, gated=True,
                              gather=(h2, slot, src_tok))
            x = stage_matmul(stages["ed"], hf, layer=l, combine=(x, slot, wgt))
    return x, kn, vn


# ------------------------------------------- K9: one MoE layer's experts


def moe_plan_matmul_plain(stage_a: PackedStage, stage_b: PackedStage, *,
                          d_ff_total: int, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_plan_matmul` (same arguments):
    stage A in its gated mode, then stage B, through
    :func:`stage_matmul_plain`."""
    hf = stage_matmul_plain(stage_a, src, layer=0, gated=True)
    return stage_matmul_plain(stage_b, hf, layer=0)


def moe_plan_matmul(stage_a: PackedStage, stage_b: PackedStage, *,
                    d_ff_total: int, src: torch.Tensor) -> torch.Tensor:
    """One MoE layer's expert FFNs: ``src [E*d, C] -> [E*d, C]`` float32.

    Stage A emits all experts' gates at rows ``[0, E*dff)`` and ups at
    ``[E*dff, 2*E*dff)`` (e-major, expert ``e`` reading ``src`` rows
    ``[e*d, (e+1)*d)``), and its epilogue writes their SwiGLU (the gated
    mode of :func:`stage_matmul`); stage B applies the downs.  Both stages
    are one-layer :class:`~repro_torch.kernels.ops.PackedStage` s.  Replaces
    the reference's single ``pallas_call``; here two launches of K6
    ``stage_matmul`` with no PyTorch operation between them, counted as
    ``stage_matmul``.  CUDA tensors launch the kernels (or raise); CPU
    tensors take :func:`moe_plan_matmul_plain`."""
    if stage_a.n_layers != 1 or stage_b.n_layers != 1:
        raise ValueError("an MoE plan's stages hold one layer each")
    if stage_a.out_dim != 2 * d_ff_total or stage_b.d_src != d_ff_total:
        raise ValueError(
            f"stage A emits {stage_a.out_dim} rows and stage B reads "
            f"{stage_b.d_src}, expected {2 * d_ff_total} and {d_ff_total}")
    if not dispatch.on_device(src):
        return moe_plan_matmul_plain(stage_a, stage_b, d_ff_total=d_ff_total,
                                     src=src)
    hf = stage_matmul(stage_a, src, layer=0, gated=True)  # checks src
    return stage_matmul(stage_b, hf, layer=0)
