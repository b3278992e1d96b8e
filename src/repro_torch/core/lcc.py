"""Linear computation coding (LCC) — the paper's core contribution.

A constant matrix ``W`` (vertically sliced into tall submatrices, eq. (3)) is
approximated as a product of sparse factors whose rows hold only signed powers
of two (eq. (4)).  Evaluating ``W @ x`` then needs only additions and
bit-shifts.  Two decomposition algorithms (paper Sec. III-A):

* **FP (fully parallel)** — every factor row draws at most ``S`` terms from the
  *previous factor's outputs*; ≤ S-1 adds per row per factor, rows independent.
* **FS (fully sequential)** — a growing computation DAG: every partial sum ever
  computed may be reused by later rows; better compression, sequential.

Both are greedy matching pursuit over a power-of-two-coefficient dictionary.
Decomposition is offline numpy (float64), the reference's (``repro.core.lcc``)
operation for operation -- rows ordered by energy with numpy's own argsort,
the same argmax ties -- so both packages decompose a matrix into bitwise the
same factors.  Runtime application lives in ``repro_torch.kernels`` (CUDA)
with these classes as the exchange format.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .csd import adds_csd_matrix, quantization_snr_db

__all__ = [
    "LCCFactor",
    "LCCChain",
    "FSProgram",
    "LCCDecomposition",
    "lcc_decompose",
    "lcc_decompose_slice",
    "plan_col_slices",
    "resolve_target_snr_db",
    "assemble_decomposition",
    "snr_db",
    "zero_slice_piece",
    "expand_slice_piece",
    "EXP_RANGE",
]

EXP_RANGE = (-16, 15)  # signed powers of two representable by the int8 format
_EXP_RANGE = EXP_RANGE


def snr_db(w: np.ndarray, w_hat: np.ndarray) -> float:
    err = float(np.sum((np.asarray(w, np.float64) - np.asarray(w_hat, np.float64)) ** 2))
    sig = float(np.sum(np.asarray(w, np.float64) ** 2))
    if err == 0.0:
        return np.inf
    if sig == 0.0:
        return 0.0
    return 10.0 * np.log10(sig / err)


def _quantize_po2(c: np.ndarray, exp_range: tuple[int, int]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Nearest signed power of two.  Returns (sign, exp, value); sign 0 => zero."""
    c = np.asarray(c, dtype=np.float64)
    sign = np.sign(c).astype(np.int8)
    m = np.abs(c)
    emin, emax = exp_range
    with np.errstate(divide="ignore"):
        ef = np.floor(np.log2(np.where(m > 0, m, 1.0))).astype(np.int64)
    # between 2^e and 2^{e+1} the linear midpoint is 1.5 * 2^e
    e = np.where(m > 1.5 * np.exp2(ef.astype(np.float64)), ef + 1, ef)
    e = np.clip(e, emin, emax)
    val = sign * np.exp2(e.astype(np.float64))
    # kill terms that would round to (near) zero: |c| below half the smallest grid step
    dead = m < np.exp2(float(emin)) / 2.0
    sign = np.where(dead, 0, sign).astype(np.int8)
    val = np.where(dead, 0.0, val)
    e = np.where(dead, 0, e)
    return sign, e.astype(np.int8), val


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

    def achieved_snr_db(self, w: np.ndarray) -> float:
        return snr_db(w, self.to_dense())


def _slice_nonzero(s: LCCChain | FSProgram) -> bool:
    if isinstance(s, FSProgram):
        return bool((np.asarray(s.outputs) >= 0).any())
    return any((f.sign != 0).any() for f in s.factors)


def zero_slice_piece(algorithm: str, n_rows: int, width: int) -> LCCChain | FSProgram:
    """The zero map [width] -> [n_rows] as a slice piece with 0 adds.

    For a fully-pruned slice (every column dead) the planner skips the
    decomposition job entirely and the reducer drops this in.  FP needs an
    explicit all-sign-0 factor — an *empty* chain means identity, not zero.
    FS encodes zero rows natively as ``outputs[i] = -1``.
    """
    if algorithm == "fs":
        return FSProgram(n_inputs=width,
                         nodes=np.zeros((0, 6), dtype=np.int64),
                         outputs=np.full(n_rows, -1, dtype=np.int64))
    return LCCChain(
        factors=[LCCFactor(idx=np.zeros((n_rows, 1), np.int32),
                           exp=np.zeros((n_rows, 1), np.int8),
                           sign=np.zeros((n_rows, 1), np.int8),
                           in_dim=width)],
        in_dim=width)


def expand_slice_piece(piece: LCCChain | FSProgram, keep: np.ndarray,
                       width: int) -> LCCChain | FSProgram:
    """Re-address a piece decomposed on a *compacted* slice back to full width.

    ``keep`` lists the surviving column offsets within the slice; the piece
    consumed a ``len(keep)``-wide input, the expanded piece consumes the full
    ``width``-wide slice and reads only the kept columns.  Pure re-indexing —
    adds, values, and structure are unchanged, so shrunk jobs cost exactly
    what the compacted decomposition cost.
    """
    keep = np.asarray(keep, dtype=np.int64)
    kdrop = len(keep)
    if isinstance(piece, FSProgram):
        n_in = piece.n_inputs
        assert n_in == kdrop, (n_in, kdrop)
        shift = width - kdrop

        def remap(ids: np.ndarray) -> np.ndarray:
            ids = np.asarray(ids, dtype=np.int64)
            out = np.where(ids >= kdrop, ids + shift, ids)
            is_input = (ids >= 0) & (ids < kdrop)
            out = np.where(is_input, keep[np.clip(ids, 0, kdrop - 1)], out)
            return np.where(ids < 0, ids, out)  # -1 (zero row / unary) stays

        nodes = np.asarray(piece.nodes, dtype=np.int64).copy()
        if len(nodes):
            nodes[:, 0] = remap(nodes[:, 0])
            nodes[:, 3] = remap(nodes[:, 3])
        return FSProgram(n_inputs=width, nodes=nodes,
                         outputs=remap(piece.outputs))
    assert piece.in_dim == kdrop, (piece.in_dim, kdrop)
    if not piece.factors:
        # empty chain = identity on the compacted input; expanded, that is a
        # 0-add gather of the kept columns
        gather = LCCFactor(idx=keep.astype(np.int32).reshape(-1, 1),
                           exp=np.zeros((kdrop, 1), np.int8),
                           sign=np.ones((kdrop, 1), np.int8),
                           in_dim=width)
        return LCCChain(factors=[gather], in_dim=width)
    first = piece.factors[0]
    remapped = LCCFactor(idx=keep[first.idx].astype(np.int32),
                         exp=first.exp, sign=first.sign, in_dim=width)
    return LCCChain(factors=[remapped] + piece.factors[1:], in_dim=width)


# --------------------------------------------------------------------------
# FP algorithm: vectorized matching pursuit, one factor at a time
# --------------------------------------------------------------------------


def _mp_factor(
    targets: np.ndarray,  # [N, K] rows to approximate
    dictionary: np.ndarray,  # [M, K] currently computable functionals
    s_terms: int,
    exp_range: tuple[int, int],
) -> tuple[LCCFactor, np.ndarray]:
    n, k = targets.shape
    m = dictionary.shape[0]
    dn2 = np.sum(dictionary**2, axis=1)
    ok = dn2 > 1e-30
    dn2_safe = np.where(ok, dn2, 1.0)

    idx = np.zeros((n, s_terms), dtype=np.int32)
    exp = np.zeros((n, s_terms), dtype=np.int8)
    sgn = np.zeros((n, s_terms), dtype=np.int8)

    r = targets.astype(np.float64).copy()
    for s in range(s_terms):
        corr = r @ dictionary.T  # [N, M]
        gain = np.where(ok[None, :], corr**2 / dn2_safe[None, :], -1.0)
        j = np.argmax(gain, axis=1)  # [N]
        c = corr[np.arange(n), j] / dn2_safe[j]
        sg, e, val = _quantize_po2(c, exp_range)
        r -= val[:, None] * dictionary[j]
        idx[:, s] = j
        exp[:, s] = e
        sgn[:, s] = sg
    approx = targets - r  # = F @ dictionary by construction
    return LCCFactor(idx=idx, exp=exp, sign=sgn, in_dim=m), approx


def _fp_chain_fixed_s(
    w: np.ndarray,
    s_terms: int,
    target_snr_db: float,
    max_factors: int,
    exp_range: tuple[int, int],
) -> LCCChain:
    n, k = w.shape
    factors: list[LCCFactor] = []
    dictionary = np.eye(k, dtype=np.float64)
    approx = np.zeros_like(w, dtype=np.float64)
    prev_snr = -np.inf
    for p in range(max_factors):
        f, approx = _mp_factor(w, dictionary, s_terms, exp_range)
        factors.append(f)
        dictionary = approx  # next factor draws from this factor's outputs only
        cur = snr_db(w, approx)
        if cur >= target_snr_db or cur - prev_snr < 0.1:  # met or stalled
            break
        prev_snr = cur
    return LCCChain(factors=factors, in_dim=k)


def _fp_chain(
    w: np.ndarray,
    s_terms: int,
    target_snr_db: float,
    max_factors: int,
    exp_range: tuple[int, int],
) -> LCCChain:
    """FP with S-escalation: greedy MP with quantized coefficients can stall
    below the target (quantization error ~ residual); when that happens a
    larger per-row budget S converges in far fewer factors — and empirically
    often with *fewer total adds*.  We keep the cheapest chain that meets the
    target (or the best-SNR chain if none does)."""
    best_met: LCCChain | None = None
    best_met_adds = None
    best_any: LCCChain | None = None
    best_any_snr = -np.inf
    for s in range(s_terms, s_terms + 3):
        chain = _fp_chain_fixed_s(w, s, target_snr_db, max_factors, exp_range)
        cur = snr_db(w, chain.to_dense())
        if cur >= target_snr_db and (best_met_adds is None
                                     or chain.num_adds() < best_met_adds):
            best_met, best_met_adds = chain, chain.num_adds()
        if cur > best_any_snr or best_any is None:
            best_any, best_any_snr = chain, cur
    return best_met if best_met is not None else best_any


# --------------------------------------------------------------------------
# FS algorithm: sequential matching pursuit over a growing global codebook
# --------------------------------------------------------------------------


def _fs_program(
    w: np.ndarray,
    target_snr_db: float,
    max_terms_per_row: int,
    exp_range: tuple[int, int],
) -> FSProgram:
    n, k = w.shape
    snr_lin = 10.0 ** (target_snr_db / 10.0)

    cap = k + 4 * n + 8
    book = np.zeros((cap, k), dtype=np.float64)
    book[:k] = np.eye(k)
    norms2 = np.ones(cap)
    norms2[:k] = 1.0
    m = k  # current codebook size

    nodes: list[tuple[int, int, int, int, int, int]] = []
    outputs = np.full(n, -1, dtype=np.int64)

    # process high-energy rows first: their partial sums seed the codebook
    order = np.argsort(-np.sum(w**2, axis=1))
    for i in order:
        wi = w[i].astype(np.float64)
        wn2 = float(np.sum(wi**2))
        if wn2 <= 1e-30:
            continue  # structurally zero (pruned) row
        tol2 = wn2 / snr_lin
        r = wi.copy()
        cur_node = -1
        cur_vec = np.zeros(k)
        for _ in range(max_terms_per_row):
            if float(np.sum(r**2)) <= tol2:
                break
            corr = book[:m] @ r
            gain = corr**2 / norms2[:m]
            j = int(np.argmax(gain))
            c = float(corr[j] / norms2[j])
            sg, e, val = _quantize_po2(np.array([c]), exp_range)
            if sg[0] == 0:
                break  # nothing representable improves the residual
            a = float(val[0])
            new_vec = cur_vec + a * book[j]
            if cur_node == -1:
                nodes.append((j, int(e[0]), int(sg[0]), -1, 0, 0))  # wire/shift: 0 adds
            else:
                nodes.append((cur_node, 0, 1, j, int(e[0]), int(sg[0])))  # 1 add
            node_id = k + len(nodes) - 1
            cur_node = node_id
            cur_vec = new_vec
            r = wi - cur_vec
            # codebook rows stay aligned with node ids (row id == node id) so
            # every partial sum ever computed is reusable by later rows — the
            # defining property of the FS algorithm.
            row = k + len(nodes) - 1
            if row >= book.shape[0]:
                newcap = max(2 * book.shape[0], row + 1)
                book = np.concatenate([book, np.zeros((newcap - book.shape[0], k))])
                norms2 = np.concatenate([norms2, np.ones(newcap - norms2.shape[0])])
            book[row] = new_vec
            nn = float(np.sum(new_vec**2))
            norms2[row] = nn if nn > 1e-30 else 1.0
            m = row + 1
        outputs[i] = cur_node
    return FSProgram(
        n_inputs=k,
        nodes=np.asarray(nodes, dtype=np.int64).reshape(-1, 6),
        outputs=outputs,
    )


# --------------------------------------------------------------------------
# top-level entry point
# --------------------------------------------------------------------------


def _default_slice_width(n_rows: int) -> int:
    # LCC wants exponential aspect ratio: slice width ~ log2(N)  [paper Sec. III-A]
    return int(np.clip(round(np.log2(max(n_rows, 2))), 2, 16))


def resolve_target_snr_db(w: np.ndarray, target_snr_db: float | None,
                          frac_bits: int) -> float:
    """Concrete fidelity target for ``w``: the given dB figure, or (when None)
    the SNR of ``frac_bits`` fixed-point CSD quantization of the same matrix,
    so baseline and LCC models are compared at equal precision (paper Sec. IV).
    Resolving this *before* slicing keeps per-slice jobs pure functions of
    (slice matrix, knobs) — the pipeline's cache-key contract."""
    if target_snr_db is None:
        target_snr_db = quantization_snr_db(np.asarray(w, np.float64), frac_bits)
        if not np.isfinite(target_snr_db):
            target_snr_db = 6.02 * frac_bits + 10.0
    return float(target_snr_db)


def plan_col_slices(n_rows: int, n_cols: int,
                    slice_width: int | None = None) -> list[tuple[int, int]]:
    """The vertical slice grid of eq. (3): [(c0, c1), ...] covering n_cols."""
    if slice_width is None:
        slice_width = _default_slice_width(n_rows)
    slice_width = max(1, min(slice_width, n_cols))
    return [(c0, min(c0 + slice_width, n_cols))
            for c0 in range(0, n_cols, slice_width)]


def lcc_decompose_slice(
    we: np.ndarray,
    algorithm: str,
    target_snr_db: float,
    s_terms: int = 2,
    max_factors: int = 24,
    max_terms_per_row: int = 64,
    exp_range: tuple[int, int] = _EXP_RANGE,
) -> LCCChain | FSProgram:
    """Decompose ONE tall column slice (the embarrassingly-parallel unit of
    work: slices never interact until the final sum over slice outputs)."""
    we = np.asarray(we, dtype=np.float64)
    if algorithm == "fp":
        return _fp_chain(we, s_terms, target_snr_db, max_factors, exp_range)
    if algorithm == "fs":
        return _fs_program(we, target_snr_db, max_terms_per_row, exp_range)
    raise ValueError(f"unknown LCC algorithm {algorithm!r} (want 'fp' or 'fs')")


def assemble_decomposition(
    w: np.ndarray,
    col_slices: list[tuple[int, int]],
    pieces: list[LCCChain | FSProgram],
    algorithm: str,
    target_snr_db: float,
    frac_bits: int = 8,
) -> LCCDecomposition:
    """Deterministic reduction: slice pieces (in column order) -> one
    decomposition, with the meta fields ``lcc_decompose`` records."""
    w = np.asarray(w, dtype=np.float64)
    dec = LCCDecomposition(
        shape=(w.shape[0], w.shape[1]),
        col_slices=list(col_slices),
        slices=list(pieces),
        algorithm=algorithm,
        target_snr_db=float(target_snr_db),
    )
    dec.meta["csd_adds_baseline"] = adds_csd_matrix(w, frac_bits)
    dec.meta["achieved_snr_db"] = dec.achieved_snr_db(w)
    return dec


def lcc_decompose(
    w: np.ndarray,
    algorithm: str = "fp",
    s_terms: int = 2,
    target_snr_db: float | None = None,
    frac_bits: int = 8,
    slice_width: int | None = None,
    max_factors: int = 24,
    max_terms_per_row: int = 64,
    exp_range: tuple[int, int] = _EXP_RANGE,
) -> LCCDecomposition:
    """Decompose ``w`` into an LCC representation.

    If ``target_snr_db`` is None the fidelity target is matched to the SNR of
    ``frac_bits`` fixed-point CSD quantization of the same matrix, so that
    baseline and LCC models are compared at equal precision (paper Sec. IV).

    This is the serial composition of the three pipeline stages
    (:func:`plan_col_slices` -> :func:`lcc_decompose_slice` per slice ->
    :func:`assemble_decomposition`); ``repro.pipeline`` runs the same stages
    with the slice loop fanned out over worker processes, producing bitwise
    identical results.
    """
    w = np.asarray(w, dtype=np.float64)
    if w.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got {w.shape}")
    n, k = w.shape
    target_snr_db = resolve_target_snr_db(w, target_snr_db, frac_bits)
    col_slices = plan_col_slices(n, k, slice_width)
    pieces = [
        lcc_decompose_slice(w[:, c0:c1], algorithm, target_snr_db,
                            s_terms=s_terms, max_factors=max_factors,
                            max_terms_per_row=max_terms_per_row,
                            exp_range=exp_range)
        for c0, c1 in col_slices
    ]
    return assemble_decomposition(w, col_slices, pieces, algorithm,
                                  target_snr_db, frac_bits)
