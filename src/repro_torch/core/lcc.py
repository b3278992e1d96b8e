"""Linear computation coding (LCC) — the containers.

A constant matrix ``W`` (vertically sliced into tall submatrices, eq. (3)) is
approximated as a product of sparse factors whose rows hold only signed powers
of two (eq. (4)), so ``W @ x`` needs only additions and bit-shifts.  This
module holds the exchange format between the offline compressor and the
runtime — the factor, chain, program and decomposition classes with their
numpy evaluation — and the compressor's slice grid.  The decomposition
algorithms themselves are not part of this package yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["LCCFactor", "LCCChain", "FSProgram", "LCCDecomposition",
           "plan_col_slices", "EXP_RANGE"]

EXP_RANGE = (-16, 15)  # signed powers of two representable by the int8 format


@dataclass
class LCCFactor:
    """One sparse factor: row r computes  sum_s sign[r,s] * 2^exp[r,s] * prev[idx[r,s]]."""

    idx: np.ndarray  # [out_dim, S] int32
    exp: np.ndarray  # [out_dim, S] int8
    sign: np.ndarray  # [out_dim, S] int8 in {-1, 0, +1}; 0 marks an unused slot
    in_dim: int

    @property
    def out_dim(self) -> int:
        return self.idx.shape[0]

    @property
    def s_terms(self) -> int:
        return self.idx.shape[1]

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.out_dim, self.in_dim), dtype=np.float64)
        val = self.sign.astype(np.float64) * np.exp2(self.exp.astype(np.float64))
        rows = np.repeat(np.arange(self.out_dim), self.s_terms)
        np.add.at(d, (rows, self.idx.reshape(-1)), val.reshape(-1))
        return d

    def apply(self, x: np.ndarray) -> np.ndarray:
        """x: [in_dim, ...] -> [out_dim, ...] via gather/shift/add (no matmul)."""
        val = self.sign.astype(np.float64) * np.exp2(self.exp.astype(np.float64))
        gathered = x[self.idx]  # [out, S, ...]
        return np.einsum("os,os...->o...", val, gathered)

    def num_adds(self) -> int:
        nnz = (self.sign != 0).sum(axis=1)
        return int(np.maximum(nnz - 1, 0).sum())

    def storage_bytes(self) -> int:
        """Compact stream format: int16 index + int8 (sign|exp) per nonzero term."""
        return int(3 * (self.sign != 0).sum())


@dataclass
class LCCChain:
    """FP factor chain for one tall slice:  W_e ~= F_P ... F_1  (F_0 = identity wiring)."""

    factors: list[LCCFactor]
    in_dim: int

    def to_dense(self) -> np.ndarray:
        a = np.eye(self.in_dim, dtype=np.float64)
        for f in self.factors:
            a = f.to_dense() @ a
        return a

    def apply(self, x: np.ndarray) -> np.ndarray:
        for f in self.factors:
            x = f.apply(x)
        return x

    def num_adds(self) -> int:
        return sum(f.num_adds() for f in self.factors)

    def storage_bytes(self) -> int:
        return sum(f.storage_bytes() for f in self.factors)


@dataclass
class FSProgram:
    """FS computation DAG.

    Node ids 0..K-1 are the inputs.  Node K+t computes
        sign_a * 2^exp_a * v[src_a]  (+ sign_b * 2^exp_b * v[src_b]  if src_b >= 0)
    ``outputs[i]`` is the node id providing output row i (-1 => zero row).
    Additions = number of binary nodes (unary nodes are wires/shifts).
    """

    n_inputs: int
    nodes: np.ndarray  # [T, 6] int64: (src_a, exp_a, sign_a, src_b, exp_b, sign_b)
    outputs: np.ndarray  # [N] int64

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        vals: list[np.ndarray] = [x[k] for k in range(self.n_inputs)]
        for sa, ea, ga, sb, eb, gb in self.nodes:
            v = float(ga) * np.exp2(float(ea)) * vals[sa]
            if sb >= 0:
                v = v + float(gb) * np.exp2(float(eb)) * vals[sb]
            vals.append(v)
        zero = np.zeros_like(x[0])
        return np.stack([vals[o] if o >= 0 else zero for o in self.outputs])

    def to_dense(self) -> np.ndarray:
        eye = np.eye(self.n_inputs, dtype=np.float64)
        return self.apply(eye)

    def num_adds(self) -> int:
        if len(self.nodes) == 0:
            return 0
        return int((np.asarray(self.nodes)[:, 3] >= 0).sum())

    def storage_bytes(self) -> int:
        # each node: two (int16 idx + int8 sign|exp) slots
        return int(6 * len(self.nodes))


@dataclass
class LCCDecomposition:
    """Full-matrix decomposition: vertical slices (eq. (3)), one chain/program each."""

    shape: tuple[int, int]
    col_slices: list[tuple[int, int]]
    slices: list[LCCChain | FSProgram]
    algorithm: str  # 'fp' | 'fs'
    target_snr_db: float
    meta: dict = field(default_factory=dict)

    def to_dense(self) -> np.ndarray:
        n, k = self.shape
        w = np.zeros((n, k), dtype=np.float64)
        for (c0, c1), s in zip(self.col_slices, self.slices):
            w[:, c0:c1] = s.to_dense()
        return w

    def apply(self, x: np.ndarray) -> np.ndarray:
        """x: [K, ...] -> [N, ...];  W x = sum_e W_e x_e."""
        y = None
        for (c0, c1), s in zip(self.col_slices, self.slices):
            part = s.apply(x[c0:c1])
            y = part if y is None else y + part
        if y is None:
            raise ValueError("empty decomposition: no slices to apply")
        return y

    def num_adds(self) -> int:
        """Adds inside slices + combining the slice outputs (N per extra slice)."""
        n, _ = self.shape
        inner = sum(s.num_adds() for s in self.slices)
        nz = sum(1 for s in self.slices if s.num_adds() > 0 or _slice_nonzero(s))
        return inner + max(0, nz - 1) * n

    def storage_bytes(self) -> int:
        return sum(s.storage_bytes() for s in self.slices)


def _slice_nonzero(s: LCCChain | FSProgram) -> bool:
    if isinstance(s, FSProgram):
        return bool((np.asarray(s.outputs) >= 0).any())
    return any((f.sign != 0).any() for f in s.factors)


def _default_slice_width(n_rows: int) -> int:
    # LCC wants exponential aspect ratio: slice width ~ log2(N)  [paper Sec. III-A]
    return int(np.clip(round(np.log2(max(n_rows, 2))), 2, 16))


def plan_col_slices(n_rows: int, n_cols: int,
                    slice_width: int | None = None) -> list[tuple[int, int]]:
    """The vertical slice grid of eq. (3): [(c0, c1), ...] covering n_cols."""
    if slice_width is None:
        slice_width = _default_slice_width(n_rows)
    slice_width = max(1, min(slice_width, n_cols))
    return [(c0, min(c0 + slice_width, n_cols))
            for c0 in range(0, n_cols, slice_width)]
