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
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.lcc import LCCChain, LCCDecomposition

from .lcc_chain_matmul import lcc_chain_matmul
from .lcc_group_matmul import lcc_group_matmul
from .shared_matmul import cluster_segment_sum

__all__ = [
    "PackedChain",
    "PackedDecomposition",
    "PackedGroup",
    "DeviceStreams",
    "pack_chain",
    "pack_decomposition",
    "pack_group",
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
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

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
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

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
                (cs, torch.from_numpy(np.asarray(wm, np.float32)).to(device))
                for cs, wm in self.dense)
        return self._dev[key]

    def on(self, device) -> DeviceStreams:
        device = torch.device(device)
        if device not in self._dev:
            _check_streams(self.idx, self.sign, self.exp)
            c0, w, ln = self.slice_tables()
            self._dev[device] = DeviceStreams(
                torch.from_numpy(self.idx).to(device),
                torch.from_numpy(self.exp).to(device),
                torch.from_numpy(self.sign).to(device),
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
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

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


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def apply_packed_group(pg: PackedGroup, xs) -> list[torch.Tensor]:
    """y_g = W_hat_g @ xs[g] for every group member — ONE fused launch.

    ``xs`` is a per-member list of [K_g, B] inputs (all the same B; K_g is the
    member's own in_dim).  The inputs are concatenated once; every slice
    reads its rows through its offset.  FS dense-fallback slices are added per
    member outside the launch, exactly like :func:`apply_packed_decomposition`.
    """
    if len(xs) != len(pg.members):
        raise ValueError(f"{len(pg.members)} group members, {len(xs)} inputs")
    for m, x in zip(pg.members, xs):
        if x.shape[0] != m.in_dim:
            raise ValueError(f"x has {x.shape[0]} rows, member expects "
                             f"in_dim={m.in_dim}")
    xs = [_as_f32(x) for x in xs]
    y = None
    if any(m.col_slices for m in pg.members):
        ds = pg.on(xs[0].device)
        y = lcc_group_matmul(ds.idx, ds.exp, ds.sign, torch.cat(xs, dim=0),
                             ds.slice_c0, ds.slice_w, ds.chain_len)
    outs = []
    for g, (m, x) in enumerate(zip(pg.members, xs)):
        yg = y[g, : m.out_dim] if (y is not None and m.col_slices) else None
        for (c0, c1), w in m.dense_on(x.device):
            part = w @ x[c0:c1]
            yg = part if yg is None else yg + part
        if yg is None:
            raise ValueError("empty decomposition in group: no FP or dense slices")
        outs.append(yg)
    return outs


def apply_packed_chain(pc: PackedChain, x: torch.Tensor) -> torch.Tensor:
    """y[N, B] = (F_P ... F_1) @ x[K, B] — the whole chain in one fused launch.

    Padded rows carry sign==0 slots (value 0) so they stay exactly zero through
    the chain; the final slice recovers the true output dim.
    """
    k, _ = x.shape
    if k != pc.in_dim:
        raise ValueError(f"x has {k} rows, chain expects in_dim={pc.in_dim}")
    x = _as_f32(x)
    ds = pc.on(x.device)
    y = lcc_chain_matmul(ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w,
                         ds.chain_len)
    return y[: pc.out_dim]


def apply_packed_decomposition(packed: PackedDecomposition, x: torch.Tensor
                               ) -> torch.Tensor:
    """y = W_hat @ x for a packed decomposition; x [K, B] (or [K] vector).

    All FP slices run in a single ``lcc_chain_matmul`` launch.  Dense-fallback
    slices (FS programs) are added on top.
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
    if packed.col_slices:
        y = lcc_chain_matmul(ds.idx, ds.exp, ds.sign, x, ds.slice_c0,
                             ds.slice_w, ds.chain_len)[: packed.out_dim]
    for (c0, c1), w in ds.dense:
        part = w @ x[c0:c1]
        y = part if y is None else y + part
    if y is None:
        raise ValueError("empty decomposition: no FP or dense slices to apply")
    return y[:, 0] if squeeze else y


def segment_sum(labels: torch.Tensor, x: torch.Tensor, num_clusters: int,
                *, csr=None) -> torch.Tensor:
    """Kernel segment-sum over ragged (K, C, B) — no padding: the kernel masks
    its own edges.  ``csr`` (required for CUDA tensors): see
    :func:`~repro_torch.kernels.shared_matmul.cluster_segment_sum`."""
    return cluster_segment_sum(labels, _as_f32(x), num_clusters, csr=csr)


def shared_matmul(centroids: torch.Tensor, labels: torch.Tensor,
                  x: torch.Tensor, *, csr=None) -> torch.Tensor:
    """Eq. (10): kernel segment-sum then centroid matmul. x [K, B] -> [N, B]."""
    agg = segment_sum(labels, x, centroids.shape[1], csr=csr)
    return centroids.to(torch.float32) @ agg
