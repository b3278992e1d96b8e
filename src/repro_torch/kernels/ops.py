"""Public wrappers around the CUDA kernels.

Bridges ``repro_torch.core.lcc`` decomposition objects (numpy, offline) to the
GPU runtime format: pads factors to block multiples, packs (idx, exp, sign)
into the stacked whole-chain layout, applies chains / decompositions fused
(one launch per decomposition) and evaluates weight-shared layers (paper
eq. (10)) as segment-sum + centroid matmul.

Packed layout: all FP slices of a decomposition stack into [E, P, N_pad, S]
streams; chains shorter than P are right-padded with identity factors, unused
term slots and padded rows carry sign == 0.  FS programs have no factor-chain
form — they fall back to their dense equivalent and are combined outside the
fused launch.  The packers are numpy and **bitwise equal** to those of the JAX
package (the block padding is part of that contract; the CUDA kernels need no
block multiples and mask ragged edges themselves).  Device copies of the
streams are made on first use per device (``DeviceStreams``) and cached on the
packed object.

Layer plans (:class:`PackedStage`, :func:`pack_stage`, :func:`pack_layer`)
flatten every site of a layer stage into one set of streams, stacked over the
L layers; they are evaluated by ``repro_torch.kernels.layer_plan``.
"""
from __future__ import annotations

import functools
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.lcc import LCCChain, LCCDecomposition

from .dispatch import upload
from .lcc_chain_matmul import lcc_chain_matmul
from .lcc_group_matmul import lcc_group_matmul
from .lcc_matmul import lcc_factor_matmul
from .shared_matmul import cluster_segment_sum

__all__ = [
    "PackedChain",
    "PackedDecomposition",
    "PackedGroup",
    "PackedStage",
    "DeviceStreams",
    "pack_chain",
    "pack_decomposition",
    "pack_group",
    "pack_stage",
    "pack_layer",
    "apply_packed_chain",
    "apply_packed_decomposition",
    "apply_packed_group",
    "segment_sum",
    "shared_matmul",
]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_dim(n: int, block: int) -> int:
    """Padding convention shared with the JAX package: multiples of
    min(block, n) — small dims stay small, dims >= block become multiples."""
    return _round_up(n, min(block, max(n, 1)))


@dataclass
class DeviceStreams:
    """One packed object's kernel operands on one device."""

    idx: torch.Tensor  # int32, packed layout
    exp: torch.Tensor  # int8
    sign: torch.Tensor  # int8
    slice_c0: torch.Tensor  # int32 [.., E] first input row of each slice
    slice_w: torch.Tensor  # int32 [.., E] slice width
    chain_len: torch.Tensor  # int32 [.., E] real factors; 0 = dead slice
    dense: tuple = ()  # ((c0, c1), float32 tensor) FS fallbacks


def _chain_lengths(sign: np.ndarray, lengths) -> np.ndarray:
    """Real chain length per slice, 0 where one of the slice's real factors
    has no used term (the chain then maps everything to zero, contributes
    nothing, and the kernel skips it)."""
    lengths = np.asarray(lengths, np.int32)
    used = (sign != 0).any(axis=(-1, -2))  # [E, P]
    real = np.arange(sign.shape[1])[None, :] < lengths[:, None]
    live = (used | ~real).all(axis=1)
    return np.where(live, lengths, 0).astype(np.int32)


def _check_streams(idx: np.ndarray, sign: np.ndarray, exp: np.ndarray) -> None:
    """Host-side validation, once per upload: a later factor addresses only
    the previous factor's rows, and exponents fit a float32 exponent field."""
    n = idx.shape[-2]
    later = idx[..., 1:, :, :]
    if later.size and (later.min() < 0 or later.max() >= n):
        raise ValueError("packed idx addresses a row outside [0, N_pad)")
    if idx.size and idx[..., 0, :, :].min() < 0:
        raise ValueError("packed idx holds a negative first-factor column")
    if exp.size and (exp.min() < -126 or exp.max() > 127):
        raise ValueError("packed exp outside the float32 exponent range")


@dataclass
class PackedChain:
    """One FP chain in the stacked kernel layout: factor axis leading."""

    idx: np.ndarray  # [P, N_pad, S] int32
    exp: np.ndarray  # [P, N_pad, S] int8
    sign: np.ndarray  # [P, N_pad, S] int8
    in_dim: int  # unpadded
    out_dim: int  # unpadded
    d_pad: int  # width of the running vector of the padded layout
    first_width: int  # padded input width addressable by the first factor
    n_factors: int  # real (un-padded) chain length
    # device copies, made at first use; not an init field, so a
    # ``dataclasses.replace`` that changes the streams or the dense slices
    # starts with none rather than sharing (and serving) the old ones
    _dev: dict = field(default_factory=dict, init=False, repr=False,
                       compare=False)

    @property
    def compact_bytes(self) -> int:
        """Bytes in the deployment stream format (int16 idx + int8 code)."""
        return int(3 * int((self.sign != 0).sum()))

    def on(self, device) -> DeviceStreams:
        device = torch.device(device)
        if device not in self._dev:
            _check_streams(self.idx, self.sign, self.exp)
            i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=device)  # noqa: E731
            self._dev[device] = DeviceStreams(
                torch.from_numpy(self.idx[None]).to(device),
                torch.from_numpy(self.exp[None]).to(device),
                torch.from_numpy(self.sign[None]).to(device),
                i32(0), i32(self.in_dim),
                torch.from_numpy(_chain_lengths(self.sign[None],
                                                [self.n_factors])).to(device))
        return self._dev[device]


@dataclass
class PackedDecomposition:
    """Whole decomposition: FP slices stacked for one fused launch + dense rest."""

    idx: np.ndarray  # [E, P, N_pad, S] int32
    exp: np.ndarray  # [E, P, N_pad, S] int8
    sign: np.ndarray  # [E, P, N_pad, S] int8
    col_slices: tuple[tuple[int, int], ...]  # E entries (FP slices only)
    dense: tuple[tuple[tuple[int, int], np.ndarray], ...]  # non-FP fallback
    in_dim: int
    out_dim: int
    d_pad: int
    first_width: int  # padded max slice width (first-factor column span)
    chain_lengths: tuple[int, ...]  # real factor count per FP slice
    # device copies, made at first use; not an init field, so a
    # ``dataclasses.replace`` that changes the streams or the dense slices
    # starts with none rather than sharing (and serving) the old ones
    _dev: dict = field(default_factory=dict, init=False, repr=False,
                       compare=False)

    def slice_tables(self, base: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(c0, width, chain_len) int32 per FP slice; ``base`` shifts c0 (a
        group member's offset into the concatenated input)."""
        cs = np.asarray(self.col_slices, np.int32).reshape(-1, 2)
        return ((cs[:, 0] + base).astype(np.int32),
                (cs[:, 1] - cs[:, 0]).astype(np.int32),
                _chain_lengths(self.sign, self.chain_lengths))

    def dense_on(self, device) -> tuple:
        """The FS dense fallbacks on ``device`` (without the FP streams: a
        group member's streams live in its group's copy only)."""
        key = ("dense", torch.device(device))
        if key not in self._dev:
            self._dev[key] = tuple(
                (cs, upload(np.asarray(wm, np.float32), device))
                for cs, wm in self.dense)
        return self._dev[key]

    def on(self, device) -> DeviceStreams:
        device = torch.device(device)
        if device not in self._dev:
            _check_streams(self.idx, self.sign, self.exp)
            c0, w, ln = self.slice_tables()
            self._dev[device] = DeviceStreams(
                upload(self.idx, device),
                upload(self.exp, device),
                upload(self.sign, device),
                torch.from_numpy(c0).to(device),
                torch.from_numpy(w).to(device),
                torch.from_numpy(ln).to(device),
                dense=self.dense_on(device))
        return self._dev[device]


def _stack_chain(chain: LCCChain, n_pad: int, s_max: int, p_max: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack one chain's factors into [P, N_pad, S]; identity-pad to p_max."""
    idx = np.zeros((p_max, n_pad, s_max), np.int32)
    exp = np.zeros((p_max, n_pad, s_max), np.int8)
    sgn = np.zeros((p_max, n_pad, s_max), np.int8)
    for p, f in enumerate(chain.factors):
        idx[p, : f.out_dim, : f.s_terms] = f.idx
        exp[p, : f.out_dim, : f.s_terms] = f.exp
        sgn[p, : f.out_dim, : f.s_terms] = f.sign
    for p in range(len(chain.factors), p_max):  # identity wiring: y = prev
        idx[p, :, 0] = np.arange(n_pad)
        sgn[p, :, 0] = 1
    return idx, exp, sgn


def pack_chain(chain: LCCChain, block: int = 128) -> PackedChain:
    """Pack one FP chain into the stacked fused-kernel layout."""
    out_dim = chain.factors[-1].out_dim if chain.factors else chain.in_dim
    n_pad = _pad_dim(max([f.out_dim for f in chain.factors] or [chain.in_dim]),
                     block)
    s_max = max([f.s_terms for f in chain.factors] or [1])
    p_max = max(len(chain.factors), 1)
    k_pad = _pad_dim(chain.in_dim, block)
    d_pad = max(n_pad, k_pad)
    # an empty chain packs as one identity factor whose rows span n_pad
    first_width = k_pad if chain.factors else n_pad
    idx, exp, sgn = _stack_chain(chain, n_pad, s_max, p_max)
    return PackedChain(idx, exp, sgn, in_dim=chain.in_dim, out_dim=out_dim,
                       d_pad=d_pad, first_width=first_width,
                       n_factors=max(len(chain.factors), 1))


def pack_decomposition(dec: LCCDecomposition, block: int = 128
                       ) -> PackedDecomposition:
    """Pack every FP slice chain into ONE stacked multi-slice layout."""
    fp = [((c0, c1), s) for (c0, c1), s in zip(dec.col_slices, dec.slices)
          if isinstance(s, LCCChain)]
    dense = tuple(((c0, c1), np.asarray(s.to_dense(), np.float32))
                  for (c0, c1), s in zip(dec.col_slices, dec.slices)
                  if not isinstance(s, LCCChain))
    n, k = dec.shape
    if not fp:
        return PackedDecomposition(
            np.zeros((0, 1, 1, 1), np.int32), np.zeros((0, 1, 1, 1), np.int8),
            np.zeros((0, 1, 1, 1), np.int8), (), dense,
            in_dim=k, out_dim=n, d_pad=1, first_width=1, chain_lengths=())
    all_factors = [f for _, ch in fp for f in ch.factors]
    n_pad = _pad_dim(max([f.out_dim for f in all_factors] or [n]), block)
    s_max = max([f.s_terms for f in all_factors] or [1])
    p_max = max(max(len(ch.factors) for _, ch in fp), 1)
    w_pad = _pad_dim(max(c1 - c0 for (c0, c1), _ in fp), block)
    d_pad = max(n_pad, w_pad)
    stacked = [_stack_chain(ch, n_pad, s_max, p_max) for _, ch in fp]
    return PackedDecomposition(
        idx=np.stack([s[0] for s in stacked]),
        exp=np.stack([s[1] for s in stacked]),
        sign=np.stack([s[2] for s in stacked]),
        col_slices=tuple(cs for cs, _ in fp),
        dense=dense, in_dim=k, out_dim=n, d_pad=d_pad, first_width=w_pad,
        chain_lengths=tuple(max(len(ch.factors), 1) for _, ch in fp))


@dataclass
class PackedGroup:
    """G packed decompositions re-padded to common dims for ONE grouped launch.

    ``members`` keeps each decomposition's original packing metadata
    (col_slices over its own input, FS dense fallbacks, true in/out dims);
    the stacked (idx, exp, sign) carry the shared-padded factor streams that
    :func:`~repro_torch.kernels.lcc_group_matmul.lcc_group_matmul` consumes.
    """

    idx: np.ndarray  # [G, E, P, N_pad, S] int32
    exp: np.ndarray  # [G, E, P, N_pad, S] int8
    sign: np.ndarray  # [G, E, P, N_pad, S] int8
    members: tuple[PackedDecomposition, ...]
    d_pad: int
    first_width: int
    waste: dict | None = None  # padding-waste fractions (see pack_group)
    # device copies, made at first use; not an init field, so a
    # ``dataclasses.replace`` that changes the streams or the dense slices
    # starts with none rather than sharing (and serving) the old ones
    _dev: dict = field(default_factory=dict, init=False, repr=False,
                       compare=False)

    @property
    def n_groups(self) -> int:
        return len(self.members)

    def on(self, device) -> DeviceStreams:
        """Device operands; member g's slices are offset by the rows of the
        members before it in the concatenated input ``cat(xs)``."""
        device = torch.device(device)
        if device not in self._dev:
            _check_streams(self.idx, self.sign, self.exp)
            g, e = self.idx.shape[:2]
            c0 = np.zeros((g, e), np.int32)
            w = np.zeros((g, e), np.int32)
            ln = np.zeros((g, e), np.int32)
            base = 0
            for gi, m in enumerate(self.members):
                mc0, mw, mln = m.slice_tables(base)
                c0[gi, :mc0.size], w[gi, :mw.size], ln[gi, :mln.size] = mc0, mw, mln
                base += m.in_dim
            self._dev[device] = DeviceStreams(
                torch.from_numpy(self.idx).to(device),
                torch.from_numpy(self.exp).to(device),
                torch.from_numpy(self.sign).to(device),
                torch.from_numpy(c0).to(device),
                torch.from_numpy(w).to(device),
                torch.from_numpy(ln).to(device))
        return self._dev[device]


def pack_group(members: list[PackedDecomposition]) -> PackedGroup:
    """Re-pad G packed decompositions to common (E, P, N, S, D) dims.

    Padding preserves the kernel invariants: extra term slots and extra rows
    carry sign == 0 (decompress to zero), chains are right-extended with
    identity factors over the shared N_pad, and whole missing slices are
    all-zero-sign (a zero factor chain on zero input — contributes nothing).
    """
    if not members:
        raise ValueError("pack_group needs at least one member")
    e_max = max([m.idx.shape[0] for m in members] + [1])
    p_max = max([m.idx.shape[1] for m in members if m.idx.shape[0]] + [1])
    n_max = max([m.idx.shape[2] for m in members if m.idx.shape[0]] + [1])
    s_max = max([m.idx.shape[3] for m in members if m.idx.shape[0]] + [1])
    d_pad = max([m.d_pad for m in members if m.idx.shape[0]] + [n_max])
    first_width = max([m.first_width for m in members if m.idx.shape[0]] + [1])
    gi = np.zeros((len(members), e_max, p_max, n_max, s_max), np.int32)
    ge = np.zeros(gi.shape, np.int8)
    gs = np.zeros(gi.shape, np.int8)
    ident = np.arange(n_max, dtype=np.int32)
    for g, m in enumerate(members):
        e, p, n, s = m.idx.shape
        if e == 0:
            continue  # FS-only member: dense fallback handles everything
        gi[g, :e, :p, :n, :s] = m.idx
        ge[g, :e, :p, :n, :s] = m.exp
        gs[g, :e, :p, :n, :s] = m.sign
        # chains shorter than the group max continue as identity factors
        gi[g, :e, p:, :, 0] = ident
        gs[g, :e, p:, :, 0] = 1
    # padding-waste accounting: a (slice, factor, row) slot whose sign terms
    # are all zero does no work — report the fraction per group so
    # badly-matched group members are visible
    zero_rows = (gs == 0).all(axis=-1)  # [G, E, P, N]
    zero_slices = zero_rows.all(axis=(2, 3))  # [G, E]
    row_frac = zero_rows.reshape(len(members), -1).mean(axis=1)
    slice_frac = zero_slices.mean(axis=1)
    waste = {
        "row_waste": [float(f) for f in row_frac],
        "slice_waste": [float(f) for f in slice_frac],
        "mean_row_waste": float(row_frac.mean()),
        "shape": list(gi.shape),
    }
    if waste["mean_row_waste"] > 0.5:
        warnings.warn(
            f"pack_group: {waste['mean_row_waste']:.0%} of padded rows carry "
            f"sign==0 across {len(members)} members (shape {gi.shape}) — "
            "group members are badly matched; consider splitting the group",
            stacklevel=2)
    return PackedGroup(idx=gi, exp=ge, sign=gs, members=tuple(members),
                       d_pad=d_pad, first_width=first_width, waste=waste)


# ---------------------------------------------------------------------------
# layer plans: every compressed site of a layer stage in ONE set of streams
# ---------------------------------------------------------------------------
#
# A layer plan flattens all sites that consume the same activation into one
# gather/shift-add *stage*, and stacks all L identical layers along a leading
# axis.  A row is sum_s sign * 2^exp * prev[idx] (CSD structure), so the
# evaluator needs only integer gathers and shift-adds.
#
# Per stage, for layer l:
#
#   prep_src/prep_tgt [L, M]     scatter-add pairs building the stage input
#                                buffer: inbuf[tgt] += src[src'] implements
#                                both kept-column gather and weight-sharing
#                                segment-sum (tgt = cluster label).  Padding
#                                pairs are (0, K_alloc - 1): they add into a
#                                dead row that nothing downstream reads.
#   gidx/gexp/gsgn [L, P, R, S]  every FP slice of every site, concatenated
#                                along the row axis R; level 0 reads inbuf,
#                                levels >= 1 read the running work buffer.
#                                sign == 0 marks unused slots (rows decompress
#                                to zero); short chains continue as identity.
#   outg [L, J, O]               output gather: out[o] = sum_j work[outg[j,o]]
#                                (J = max FP-slice count of any site; padded
#                                entries point at the all-zero row R).
#   fs_mat [L, O, K_alloc]       FS-program dense fallback applied to inbuf
#                                (column K_alloc - 1, the dead row, is zero).
#   dw_mat [L, O, D_src]         uncovered sites' dense weights (w.T) baked in
#                                so the stage still produces the full output.
#   bias [L, O]                  site biases, summed at their output offsets.
#
# The arrays are bitwise equal to those of ``repro.kernels.ops.pack_stage``.


# per-level gather volume (P * R * S instruction slots) above which the JAX
# package decodes a stage through its folded effective matrix ``eff``.  It is
# kept here only so that ``PackedStage.eff`` is the same property as there
# (the packer tests compare it); nothing in this package evaluates a stage
# through ``eff``: the kernel and its plain version run the shift-add streams
# at every size.
EFF_GATHER_CUTOFF = 32_768


@dataclass(frozen=True)
class PackedStage:
    """One layer stage (e.g. fused q+k+v) stacked over L layers.

    All arrays are numpy; device copies are made on first use per device by
    ``repro_torch.kernels.layer_plan.device_stage`` and cached on the object.

    ``segs`` (segment-packed layout, optional): per (layer, level) the row
    space is run-length sorted at pack time — instructions laid out by
    descending chain depth so every level splits into a contiguous *active*
    prefix (rows with a real CSD level) followed by a contiguous *identity*
    run (rows whose chains already ended) and a zero tail.  ``segs[l, p] =
    (active_end, rows_used, live_terms)``.  The descriptors only trim work;
    stages without them evaluate to the same values.
    """

    prep_src: np.ndarray | None  # [L, M] int32
    prep_tgt: np.ndarray | None  # [L, M] int32
    gidx: np.ndarray | None  # [L, P, R, S] int32
    gexp: np.ndarray | None  # [L, P, R, S] int8
    gsgn: np.ndarray | None  # [L, P, R, S] int8
    outg: np.ndarray | None  # [L, J, O] int32
    fs_mat: np.ndarray | None  # [L, O, K_alloc] f32
    dw_mat: np.ndarray | None  # [L, O, D_src] f32
    bias: np.ndarray | None  # [L, O] f32
    k_alloc: int  # inbuf rows incl. trailing dead row
    d_src: int  # stage input rows
    out_dim: int  # stage output rows O
    n_layers: int
    site_names: tuple[str, ...]  # compressed sites this stage covers
    segs: np.ndarray | None = None  # [L, P, 3] int32 segment descriptors
    seg_stats: dict | None = None  # run-length stats
    waste: dict | None = None  # padding-waste report
    # device copies, per device (not an init field: ``dataclasses.replace``
    # gives the new stage an empty cache of its own)
    _dev: dict = field(default_factory=dict, init=False, repr=False,
                       compare=False)

    @property
    def has_prep(self) -> bool:
        return self.prep_src is not None

    @property
    def has_fp(self) -> bool:
        return self.gidx is not None

    @functools.cached_property
    def gcoef(self) -> np.ndarray:
        """``sign * 2**exp`` as f32 [L, P, R, S] (exact: a signed power of
        two is exact in f32).  The device copy keeps the int8 streams instead
        (6 bytes a slot against 8)."""
        return (self.gsgn.astype(np.float32)
                * np.exp2(self.gexp.astype(np.float32)))

    @functools.cached_property
    def _prep_mats(self) -> np.ndarray | None:
        """Prep scatter-add pairs as selection matrices [L, K_alloc, D_src]
        (kept-column gather + weight-sharing segment-sum, dead row zero)."""
        if not self.has_prep:
            return None
        mats = np.zeros((self.n_layers, self.k_alloc, self.d_src), np.float32)
        for l in range(self.n_layers):
            tgt = self.prep_tgt[l].astype(np.int64)
            src = self.prep_src[l].astype(np.int64)
            real = tgt < self.k_alloc - 1  # padding pairs hit the dead row
            np.add.at(mats[l], (tgt[real], src[real]), 1.0)
        return mats

    @functools.cached_property
    def eff(self) -> np.ndarray | None:
        """Whole-stage folded effective matrix [L, O, D_src], or ``None``
        (at or below ``EFF_GATHER_CUTOFF`` slots a level).

        The composition of prep, the P shift-add levels, the output gather
        and the dense fallbacks as one matrix per layer.  A test surface
        only: it turns the shift-add evaluation into a dense product, and at
        full width its running ``[R, D_src]`` f32 matrix takes gigabytes."""
        if not self.has_fp:
            return None
        n_l, n_p, r_max, s = self.gidx.shape
        if n_p * r_max * s <= EFF_GATHER_CUTOFF:
            return None
        w = np.zeros((n_l, self.out_dim, self.d_src), np.float32)
        chunk = 4096  # bounds the [rows, S, D_src] gather transient
        for l in range(n_l):
            m = (self._prep_mats[l] if self.has_prep
                 else np.eye(self.d_src, dtype=np.float32))
            for p in range(n_p):
                idx = self.gidx[l, p].astype(np.int64)
                coef = (self.gcoef[l, p]
                        * (self.gsgn[l, p] != 0)
                        * (idx < m.shape[0]))
                safe = np.clip(idx, 0, m.shape[0] - 1)
                nxt = np.empty((r_max, m.shape[1]), np.float32)
                for r0 in range(0, r_max, chunk):
                    r1 = min(r0 + chunk, r_max)
                    nxt[r0:r1] = np.einsum(
                        "rsd,rs->rd", m[safe[r0:r1]], coef[r0:r1])
                m = nxt
            e = self.outg[l].astype(np.int64)  # [J, O]
            valid = e < r_max  # padded entries read the zero row
            w[l] = np.einsum("jod,jo->od",
                             m[np.clip(e, 0, r_max - 1)],
                             valid.astype(np.float32))
        if self.fold_dense is not None:
            w += self.fold_dense
        return w

    @functools.cached_property
    def fold_dense(self) -> np.ndarray | None:
        """FS fallback (re-based from inbuf to the stage input) + uncovered
        dense weights as one [L, O, D_src] block, folded into ``eff``."""
        if self.fs_mat is None and self.dw_mat is None:
            return None
        d = np.zeros((self.n_layers, self.out_dim, self.d_src), np.float32)
        if self.fs_mat is not None:
            for l in range(self.n_layers):
                d[l] += self.fs_mat[l] @ self._prep_mats[l]
        if self.dw_mat is not None:
            d += self.dw_mat
        return d

    def operands(self) -> list[np.ndarray]:
        """The evaluator's operands in canonical order: the shift-add form at
        every size (never ``eff``), exponents and signs as int8 streams."""
        ops_ = []
        if self.has_prep:
            ops_ += [self.prep_src, self.prep_tgt]
        if self.has_fp:
            ops_ += [self.gidx, self.gexp, self.gsgn, self.outg]
        if self.fs_mat is not None:
            ops_.append(self.fs_mat)
        if self.dw_mat is not None:
            ops_.append(self.dw_mat)
        if self.bias is not None:
            ops_.append(self.bias)
        return ops_


def _fuse_csd_levels(idx: np.ndarray, exp: np.ndarray, sgn: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse adjacent CSD levels pairwise: two S-term shift-add levels become
    one S*S-term level (``exp`` summed, signs multiplied — still exact signed
    powers of two), halving the sequential depth at an identical add count.
    A term whose parent row is all-dead composes to sign 0, exactly matching
    the sequential evaluation (the parent row decompresses to zero).  An odd
    trailing level rides along unfused.  Arrays are [..., P, rows, S] (the
    slices of one packed decomposition share P, rows and S, so the packer
    fuses them all at once); the result is int32 [..., P', rows, S']."""
    *lead, pm, rows, s = idx.shape
    if pm < 2:
        return idx.astype(np.int32), exp.astype(np.int32), sgn.astype(np.int32)
    idx, exp, sgn = (a.reshape(-1, pm, rows, s) for a in (idx, exp, sgn))
    e, n_q, ss = idx.shape[0], (pm + 1) // 2, s * s
    fi = np.zeros((e, n_q, rows, ss), np.int32)
    fe = np.zeros((e, n_q, rows, ss), np.int32)
    fs = np.zeros((e, n_q, rows, ss), np.int32)
    base = (np.arange(e, dtype=np.int64) * rows)[:, None, None]
    for q, p in enumerate(range(0, pm, 2)):
        if p + 1 == pm:  # odd trailing level, unfused
            fi[:, q, :, :s], fe[:, q, :, :s], fs[:, q, :, :s] = \
                idx[:, p], exp[:, p], sgn[:, p]
            break
        # dead terms may carry junk indices: clip before the flat row gather
        flat = (np.clip(idx[:, p + 1], 0, rows - 1) + base).reshape(-1)

        def take(a):  # a[e, j[e, r, t], :] -> [E, rows, S, S]
            return np.take(a.reshape(e * rows, s), flat, axis=0).reshape(
                e, rows, s, s)

        cs = sgn[:, p + 1].astype(np.int32)[..., None] * take(sgn[:, p])
        live = cs != 0
        fi[:, q] = np.where(live, take(idx[:, p]), 0).reshape(e, rows, ss)
        fe[:, q] = np.where(live, exp[:, p + 1].astype(np.int32)[..., None]
                            + take(exp[:, p]), 0).reshape(e, rows, ss)
        fs[:, q] = cs.reshape(e, rows, ss)
    return tuple(a.reshape(*lead, n_q, rows, ss) for a in (fi, fe, fs))


# slices fused and written by one packing job (bounds the job's temporaries:
# at 16384 rows a slice, 64 slices take ~150 MB of fused int32 streams)
PACK_CHUNK = 64


def pack_stage(layer_sites: list[list[dict]], *, d_src: int, out_dim: int
               ) -> PackedStage:
    """Flatten per-layer site lists into one stacked stage.

    ``layer_sites[l]`` is the sites of layer l, each a dict:

      {"kind": "lcc", "name", "out_off", "src_off", "kept" [ints],
       "labels" [ints]|None, "n_clusters" int, "packed" PackedDecomposition,
       "bias" [out]|None}
      {"kind": "dense", "out_off", "src_off", "w" [in, out], "bias"|None}

    Sites write disjoint [out_off, out_off + site_out) row ranges of the
    stage output and read [src_off, ...) of the shared stage input.

    The layout is planned from the sites' shapes first; then the fused CSD
    streams are built and written in jobs of up to ``PACK_CHUNK`` slices of
    one site on up to 8 threads (numpy frees the GIL in its array passes;
    every job writes its own rows, so the result does not depend on the
    thread count), and last the per-layer tables."""
    n_layers = len(layer_sites)
    built = []  # per-layer dict of intermediate layout
    any_bias = any_fs = any_dw = False
    names: list[str] = []
    for sites in layer_sites:
        in_off = 0
        prep_pairs: list[tuple[np.ndarray, np.ndarray]] = []
        # one entry per site with FP slices: its packed streams, where its
        # slices read the prep buffer, and its fused depth and width (all
        # slices of a packed decomposition share P, rows and S)
        fp_sites: list[dict] = []
        site_slices: list[tuple[int, int, list[int]]] = []  # (out_off, odim, inst ids)
        fs_entries: list[tuple[int, int, int, np.ndarray]] = []
        dw_entries: list[tuple[int, int, np.ndarray]] = []
        bias_vec = None
        n_inst = 0
        for st in sites:
            b = st.get("bias")
            if b is not None:
                any_bias = True
                if bias_vec is None:
                    bias_vec = np.zeros(out_dim, np.float32)
                b = np.asarray(b, np.float32)
                bias_vec[st["out_off"]: st["out_off"] + b.size] += b
            if st["kind"] == "dense":
                any_dw = True
                w = np.asarray(st["w"], np.float32)
                dw_entries.append((st["out_off"], st["src_off"], w.T))
                continue
            names.append(st["name"])
            kept = np.asarray(st["kept"], np.int64)
            labels = st.get("labels")
            packed = st["packed"]
            tgt = (np.asarray(labels, np.int64) if labels is not None
                   else np.arange(kept.size))
            n_in = int(st["n_clusters"]) if labels is not None else kept.size
            if packed.in_dim != n_in:
                raise ValueError(f"{st['name']}: packed.in_dim={packed.in_dim}"
                                 f" != aggregated input {n_in}")
            prep_pairs.append((st["src_off"] + kept, in_off + tgt))
            ids = list(range(n_inst, n_inst + len(packed.col_slices)))
            if ids:
                _, pm, n_pad, s = packed.idx.shape
                # one pairwise pass only: deeper fusion squares the terms per
                # row
                fp_sites.append({
                    "packed": packed, "first": n_inst, "n_pad": n_pad,
                    "depth": (pm + 1) // 2 if pm >= 2 else pm,
                    "s": s * s if pm >= 2 else s,
                    "in0": np.asarray([in_off + c0 for c0, _ in packed.col_slices],
                                      np.int64),
                    "width": np.asarray([c1 - c0 for c0, c1 in packed.col_slices],
                                        np.int64)})
                n_inst += len(ids)
            site_slices.append((st["out_off"], packed.out_dim, ids))
            for (c0, c1), w in packed.dense:
                any_fs = True
                fs_entries.append((st["out_off"], packed.out_dim,
                                   in_off + c0, np.asarray(w, np.float32)))
            in_off += n_in
        built.append({"k_used": in_off, "prep": prep_pairs, "fp": fp_sites,
                      "n_inst": n_inst, "site_slices": site_slices,
                      "fs": fs_entries, "dw": dw_entries, "bias": bias_vec})

    has_prep = any(bl["k_used"] for bl in built)
    has_fp = any(bl["n_inst"] for bl in built)
    k_alloc = (max(bl["k_used"] for bl in built) + 1) if has_prep else 0
    m_max = max([sum(p[0].size for p in bl["prep"]) for bl in built] + [1])
    r_max = max([sum(f["n_pad"] * f["in0"].size for f in bl["fp"])
                 for bl in built] + [1])
    p_max = max([f["depth"] for bl in built for f in bl["fp"]] + [1])
    s_max = max([f["s"] for bl in built for f in bl["fp"]] + [1])
    j_max = max([len(ids) for bl in built for _, _, ids in bl["site_slices"]]
                + [1])

    prep_src = prep_tgt = gidx = gexp = gsgn = outg = None
    fs_mat = dw_mat = bias = None
    if has_prep:
        prep_src = np.zeros((n_layers, m_max), np.int32)
        prep_tgt = np.full((n_layers, m_max), k_alloc - 1, np.int32)
    if has_fp:
        gidx = np.zeros((n_layers, p_max, r_max, s_max), np.int32)
        gexp = np.zeros((n_layers, p_max, r_max, s_max), np.int8)
        gsgn = np.zeros((n_layers, p_max, r_max, s_max), np.int8)
        outg = np.full((n_layers, j_max, out_dim), r_max, np.int32)
    if any_fs:
        fs_mat = np.zeros((n_layers, out_dim, k_alloc), np.float32)
    if any_dw:
        dw_mat = np.zeros((n_layers, out_dim, d_src), np.float32)
    if any_bias:
        bias = np.zeros((n_layers, out_dim), np.float32)

    # segment packing: lay instructions out by descending (fused) chain depth
    # so at every level the rows with a real CSD level form ONE contiguous
    # prefix and the ended chains one contiguous identity run.  The slices of
    # a site share its depth and keep their order, so each site's slices stay
    # one contiguous run of rows.
    for bl in built:
        order = sorted(range(len(bl["fp"])),
                       key=lambda i: (-bl["fp"][i]["depth"], i))
        wo = 0
        for i in order:
            f = bl["fp"][i]
            f["wo"] = wo
            wo += f["n_pad"] * f["in0"].size
        bl["r_used"] = wo
        bl["order"] = order

    def fill(l: int, f: dict, e0: int, e1: int) -> None:
        """Fused levels of slices [e0, e1) of one site of layer l."""
        pk, n_pad, depth, sm = f["packed"], f["n_pad"], f["depth"], f["s"]
        fi, fe, fsg = _fuse_csd_levels(pk.idx[e0:e1], pk.exp[e0:e1],
                                       pk.sign[e0:e1])
        n_e = e1 - e0
        r0 = f["wo"] + e0 * n_pad
        rows = slice(r0, r0 + n_e * n_pad)
        wo_e = (r0 + np.arange(n_e, dtype=np.int64) * n_pad)[:, None, None]
        for p in range(p_max):
            if p < depth:
                ii, ss, ee = fi[:, p], fsg[:, p], fe[:, p]
                if p == 0:
                    # level 0 reads inbuf at the slice's column window;
                    # identity-padded level-0 rows of 0-factor chains can span
                    # n_pad > width — mask them so they never read a
                    # neighbouring site's region (the zero-padded-slab
                    # semantics of the per-region kernels)
                    base = f["in0"][e0:e1, None, None]
                    live = (ss != 0) & (ii < f["width"][e0:e1, None, None])
                else:
                    base = wo_e
                    live = ss != 0
                gidx[l, p, rows, :sm] = np.where(live, base + ii, base
                                                 ).reshape(-1, sm)
                gsgn[l, p, rows, :sm] = np.where(live, ss, 0).reshape(-1, sm)
                gexp[l, p, rows, :sm] = np.where(live, ee, 0).reshape(-1, sm)
            else:  # identity continuation over the stage's extra levels
                gidx[l, p, rows, 0] = np.arange(rows.start, rows.stop)
                gsgn[l, p, rows, 0] = 1

    def tables(l: int) -> tuple[list[int], list[int]]:
        """Layer l's prep pairs, segment descriptors, output gather and
        dense blocks; returns its (runs before, runs after) sorting."""
        bl = built[l]
        runs_before: list[int] = []
        runs_after: list[int] = []
        if bl["prep"]:
            src = np.concatenate([p[0] for p in bl["prep"]])
            tgt = np.concatenate([p[1] for p in bl["prep"]])
            prep_src[l, : src.size] = src
            prep_tgt[l, : tgt.size] = tgt
        fp, order = bl["fp"], bl["order"]
        depths = [f["depth"] for f in fp for _ in range(f["in0"].size)]
        pads = [f["n_pad"] for f in fp for _ in range(f["in0"].size)]
        inst_order = [f["first"] + e for i in order
                      for f in (fp[i],) for e in range(f["in0"].size)]
        for p in range(max(p_max, 1)):
            a_end = sum(pads[i] for i in inst_order if depths[i] > p)
            s_live = 1
            if has_fp and a_end:
                cols = np.flatnonzero((gsgn[l, p, :a_end, :] != 0).any(axis=0))
                s_live = int(cols[-1]) + 1 if cols.size else 1
            segs[l, p] = (a_end, bl["r_used"], s_live)
            runs_after.extend(_active_runs(
                [depths[i] > p for i in inst_order], [pads[i] for i in inst_order]))
            runs_before.extend(_active_runs([d > p for d in depths], pads))
        work_off = {f["first"] + e: f["wo"] + e * f["n_pad"]
                    for f in fp for e in range(f["in0"].size)}
        for out_off, odim, ids in bl["site_slices"]:
            for j, inst_id in enumerate(ids):
                outg[l, j, out_off: out_off + odim] = \
                    work_off[inst_id] + np.arange(odim)
        for out_off, odim, i0, w in bl["fs"]:
            fs_mat[l, out_off: out_off + odim, i0: i0 + w.shape[1]] = w
        for out_off, src_off, wt in bl["dw"]:
            dw_mat[l, out_off: out_off + wt.shape[0],
                   src_off: src_off + wt.shape[1]] = wt
        if bl["bias"] is not None:
            bias[l] = bl["bias"]
        return runs_before, runs_after

    segs = np.zeros((n_layers, max(p_max, 1), 3), np.int32)
    jobs = [(l, f, e0, min(e0 + PACK_CHUNK, f["in0"].size))
            for l, bl in enumerate(built) for f in bl["fp"]
            for e0 in range(0, f["in0"].size, PACK_CHUNK)]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for fut in [pool.submit(fill, *job) for job in jobs]:
            fut.result()
        runs = list(pool.map(tables, range(n_layers)))
    runs_before = [r for rb, _ in runs for r in rb]
    runs_after = [r for _, ra in runs for r in ra]

    seg_stats = _segment_stats(runs_before, runs_after, gsgn, segs) \
        if has_fp else None
    waste = _stage_waste(gsgn, segs, prep_tgt, k_alloc) if has_fp else None
    return PackedStage(prep_src=prep_src, prep_tgt=prep_tgt, gidx=gidx,
                       gexp=gexp, gsgn=gsgn, outg=outg, fs_mat=fs_mat,
                       dw_mat=dw_mat, bias=bias, k_alloc=k_alloc, d_src=d_src,
                       out_dim=out_dim, n_layers=n_layers,
                       site_names=tuple(names), segs=segs,
                       seg_stats=seg_stats, waste=waste)


def _active_runs(active: list[bool], pads: list[int]) -> list[int]:
    """Maximal contiguous runs (in rows) of instructions with a live level."""
    runs, cur = [], 0
    for a, n in zip(active, pads):
        if a:
            cur += n
        elif cur:
            runs.append(cur)
            cur = 0
    if cur:
        runs.append(cur)
    return runs


def _pct(xs: list[int], q: float) -> int:
    return int(np.percentile(np.asarray(xs), q)) if xs else 0


def _segment_stats(runs_before, runs_after, gsgn, segs) -> dict:
    """Gather run-length telemetry: how contiguous the per-level active row
    space is before vs after depth sorting, and what the packed layout skips."""
    n_layers, p_max = gsgn.shape[0], gsgn.shape[1]
    r_max = gsgn.shape[2]
    total = n_layers * p_max * r_max
    active = int(sum(int(segs[l, p, 0]) for l in range(n_layers)
                     for p in range(p_max)))
    return {
        "p50_run_before": _pct(runs_before, 50),
        "p99_run_before": _pct(runs_before, 99),
        "p50_run_after": _pct(runs_after, 50),
        "p99_run_after": _pct(runs_after, 99),
        "n_runs_before": len(runs_before),
        "n_runs_after": len(runs_after),
        "gathered_rows": active,
        "total_rows": total,
        "gather_frac": round(active / total, 4) if total else 0.0,
    }


def _stage_waste(gsgn, segs, prep_tgt, k_alloc) -> dict:
    """Per-stage padding-waste report (mirrors ``pack_group``'s keys): the
    fraction of gather rows that are pure identity/zero padding and the dead
    terms inside the active region."""
    n_layers, p_max, r_max, _ = gsgn.shape
    total_rows = n_layers * p_max * r_max
    active_rows = int(sum(int(segs[l, p, 0]) for l in range(n_layers)
                          for p in range(p_max)))
    live = dead = 0
    for l in range(n_layers):
        for p in range(p_max):
            a_end, _, s_live = segs[l, p]
            blk = gsgn[l, p, :a_end, :s_live]
            live += int(np.count_nonzero(blk))
            dead += int(blk.size - np.count_nonzero(blk))
    slots = live + dead
    prep_pad = 0.0
    if prep_tgt is not None and prep_tgt.size:
        prep_pad = float(np.mean(prep_tgt == k_alloc - 1))
    return {
        "row_waste": round(1.0 - active_rows / total_rows, 4) if total_rows
        else 0.0,
        "slice_waste": round(dead / slots, 4) if slots else 0.0,
        "mean_row_waste": round(prep_pad, 4),
        "shape": tuple(int(s) for s in gsgn.shape),
    }


def pack_layer(stage_specs: dict[str, tuple[list[list[dict]], int, int]]
               ) -> dict[str, PackedStage]:
    """Pack every stage of a layer plan: name -> (layer_sites, d_src,
    out_dim).  The stages are packed one after the other, each on all the
    packing threads (:func:`pack_stage`)."""
    return {name: pack_stage(sites, d_src=d_src, out_dim=out_dim)
            for name, (sites, d_src, out_dim) in stage_specs.items()}


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def apply_packed_group(pg: PackedGroup, xs) -> list[torch.Tensor]:
    """y_g = W_hat_g @ xs[g] for every group member — ONE fused launch.

    ``xs`` is either a per-member list of [K_g, B] inputs (all the same B;
    K_g is the member's own in_dim), concatenated here once, or the
    concatenation itself, ``[sum_g K_g, B]`` (what
    :class:`~repro_torch.kernels.shared_matmul.RegionPrep` writes).  Every
    slice reads its rows through its offset.  FS dense-fallback slices are
    added per member outside the launch, exactly like
    :func:`apply_packed_decomposition`.
    """
    rows = [m.in_dim for m in pg.members]
    if isinstance(xs, torch.Tensor):
        if xs.dim() != 2 or xs.shape[0] != sum(rows):
            raise ValueError(f"x has shape {tuple(xs.shape)}, the group takes "
                             f"[{sum(rows)}, B]")
        x = _as_f32(xs)
        xs = list(torch.split(x, rows))
    else:
        if len(xs) != len(pg.members):
            raise ValueError(f"{len(pg.members)} group members, {len(xs)} inputs")
        for k, xm in zip(rows, xs):
            if xm.shape[0] != k:
                raise ValueError(f"x has {xm.shape[0]} rows, member expects "
                                 f"in_dim={k}")
        xs = [_as_f32(xm) for xm in xs]
        x = None
    y = None
    if any(m.col_slices for m in pg.members):
        ds = pg.on(xs[0].device)
        y = lcc_group_matmul(ds.idx, ds.exp, ds.sign,
                             torch.cat(xs, dim=0) if x is None else x,
                             ds.slice_c0, ds.slice_w, ds.chain_len)
    outs = []
    for g, (m, xm) in enumerate(zip(pg.members, xs)):
        yg = y[g, : m.out_dim] if (y is not None and m.col_slices) else None
        for (c0, c1), w in m.dense_on(xm.device):
            part = w @ xm[c0:c1]
            yg = part if yg is None else yg + part
        if yg is None:
            raise ValueError("empty decomposition in group: no FP or dense slices")
        outs.append(yg)
    return outs


def _check_first_factor(idx, sign, col_slices, cache: dict) -> None:
    """Host-side validation for the per-factor route, once per packed object
    (``cache`` is its ``_dev``): every live first-factor term reads a row of
    its own slice.  The fused kernel reads ``x[c0 + idx]`` and guards the
    slice itself; the per-factor route hands the factor the slice alone."""
    if cache.get("per_factor_checked"):
        return
    for e, (c0, c1) in enumerate(col_slices):
        idx0, live = idx[e, 0], sign[e, 0] != 0
        if live.any() and (idx0[live].min() < 0 or idx0[live].max() >= c1 - c0):
            raise ValueError(f"slice {e}: a first-factor term reads outside "
                             f"its {c1 - c0} input rows")
    cache["per_factor_checked"] = True


def _apply_stacked_per_factor(ds: DeviceStreams, x: torch.Tensor,
                              col_slices, chain_lengths) -> torch.Tensor:
    """Per-factor launch loop over the stacked layout — the pre-fusion
    runtime, kept (as in the reference) as the fused kernel's wall-clock
    baseline and as an independent second implementation for equivalence
    tests.  One ``lcc_factor_matmul`` launch per REAL factor of each chain
    (the identity padding exists for the fused stack's benefit), the running
    vector ``[N_pad, B]`` between them; the slices' results are summed in
    slice order.  Returns ``[N_pad, B]``."""
    y = None
    for e, (c0, c1) in enumerate(col_slices):
        cur = x[c0:c1]
        for p in range(chain_lengths[e]):
            cur = lcc_factor_matmul(ds.idx[e, p], ds.exp[e, p], ds.sign[e, p],
                                    cur)
        y = cur if y is None else y + cur
    return y


def apply_packed_chain(pc: PackedChain, x: torch.Tensor, *,
                       fused: bool = True) -> torch.Tensor:
    """y[N, B] = (F_P ... F_1) @ x[K, B] — the whole chain in one fused launch
    (``fused=False``: one ``lcc_factor_matmul`` launch per factor).

    Padded rows carry sign==0 slots (value 0) so they stay exactly zero through
    the chain; the final slice recovers the true output dim.
    """
    k, _ = x.shape
    if k != pc.in_dim:
        raise ValueError(f"x has {k} rows, chain expects in_dim={pc.in_dim}")
    x = _as_f32(x)
    ds = pc.on(x.device)
    if not fused:
        slices = ((0, pc.in_dim),)
        _check_first_factor(pc.idx[None], pc.sign[None], slices, pc._dev)
        return _apply_stacked_per_factor(ds, x, slices,
                                         (pc.n_factors,))[: pc.out_dim]
    y = lcc_chain_matmul(ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w,
                         ds.chain_len)
    return y[: pc.out_dim]


def apply_packed_decomposition(packed: PackedDecomposition, x: torch.Tensor,
                               *, fused: bool = True) -> torch.Tensor:
    """y = W_hat @ x for a packed decomposition; x [K, B] (or [K] vector).

    All FP slices run in a single ``lcc_chain_matmul`` launch (``fused=True``,
    the default); ``fused=False`` runs the per-factor loop
    (:func:`_apply_stacked_per_factor`, one ``lcc_factor_matmul`` launch per
    real factor) for comparison.  Dense-fallback slices (FS programs) are
    added on top.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    k, _ = x.shape
    if k != packed.in_dim:
        raise ValueError(f"x has {k} rows, decomposition expects "
                         f"in_dim={packed.in_dim}")
    x = _as_f32(x)
    ds = packed.on(x.device)
    y = None
    if packed.col_slices and fused:
        y = lcc_chain_matmul(ds.idx, ds.exp, ds.sign, x, ds.slice_c0,
                             ds.slice_w, ds.chain_len)[: packed.out_dim]
    elif packed.col_slices:
        _check_first_factor(packed.idx, packed.sign, packed.col_slices,
                            packed._dev)
        y = _apply_stacked_per_factor(ds, x, packed.col_slices,
                                      packed.chain_lengths)[: packed.out_dim]
    for (c0, c1), w in ds.dense:
        part = w @ x[c0:c1]
        y = part if y is None else y + part
    if y is None:
        raise ValueError("empty decomposition: no FP or dense slices to apply")
    return y[:, 0] if squeeze else y


def segment_sum(labels: torch.Tensor, x: torch.Tensor,
                num_clusters: int) -> torch.Tensor:
    """Kernel segment-sum over ragged (K, C, B) — no padding: the kernel masks
    its own edges (see
    :func:`~repro_torch.kernels.shared_matmul.cluster_segment_sum`)."""
    return cluster_segment_sum(labels, _as_f32(x), num_clusters)


def shared_matmul(centroids: torch.Tensor, labels: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Eq. (10): kernel segment-sum then centroid matmul. x [K, B] -> [N, B]."""
    agg = segment_sum(labels, x, centroids.shape[1])
    return centroids.to(torch.float32) @ agg
