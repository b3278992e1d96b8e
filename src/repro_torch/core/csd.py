"""Canonical signed digit (CSD) recoding and addition accounting.

The paper's baseline cost model (Sec. IV): quantize weights to a fixed-point
grid, recode each weight in CSD (a.k.a. the non-adjacent form, NAF), and count
the additions needed to evaluate ``W @ x`` as shift-and-add hardware would:

    adds(row i) = (sum_j nnz_digits(w_ij)) - 1        (0 for all-zero rows)

Multiplication by a signed power of two is free (a bit-shift on an FPGA; an
exact float scale on a GPU).

Everything here is plain numpy -- offline tooling, not a hot path -- and is
the reference's (``repro.core.csd``) operation for operation, so the two give
bitwise the same counts and SNRs.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "quantize_fixed",
    "csd_digit_count",
    "csd_digits",
    "adds_csd_matrix",
    "adds_csd_rowwise",
    "quantization_snr_db",
]


def quantize_fixed(w: np.ndarray, frac_bits: int = 8, word_bits: int | None = None) -> np.ndarray:
    """Round to the fixed-point grid 2^-frac_bits (optionally saturating)."""
    w = np.asarray(w, dtype=np.float64)
    scale = float(2**frac_bits)
    q = np.round(w * scale)
    if word_bits is not None:
        lim = float(2 ** (word_bits - 1) - 1)
        q = np.clip(q, -lim, lim)
    return q / scale


def _naf_nonzero_count(n: np.ndarray) -> np.ndarray:
    """Vectorized count of nonzero digits in the NAF of integer array ``n``.

    NAF is the canonical signed-digit form: digits in {-1, 0, +1}, no two
    adjacent nonzeros, provably minimal number of nonzero digits.
    """
    n = n.astype(np.int64).copy()
    count = np.zeros(n.shape, dtype=np.int64)
    # int64 NAF needs at most ~65 iterations; loop while anything is nonzero.
    while np.any(n != 0):
        odd = (n & 1) != 0
        r = (n & 3).astype(np.int64)  # n mod 4 (two's complement safe)
        z = np.where(odd, 2 - r, 0)
        count += (z != 0).astype(np.int64)
        n = (n - z) >> 1
    return count


def csd_digit_count(w: np.ndarray, frac_bits: int = 8) -> np.ndarray:
    """Number of nonzero CSD digits of each (quantized) entry of ``w``."""
    w = np.asarray(w, dtype=np.float64)
    n = np.round(w * (2.0**frac_bits)).astype(np.int64)
    return _naf_nonzero_count(n)


def csd_digits(value: float, frac_bits: int = 8) -> list[tuple[int, int]]:
    """CSD digits of a scalar as ``[(exponent, sign), ...]`` (sign in {-1,+1}).

    ``value ~= sum_i sign_i * 2**exponent_i`` exactly on the quantized grid.
    """
    n = int(round(float(value) * (2**frac_bits)))
    digits: list[tuple[int, int]] = []
    pos = -frac_bits
    while n != 0:
        if n & 1:
            r = n & 3
            z = 2 - r  # +1 or -1
            digits.append((pos, int(z)))
            n -= z
        n >>= 1
        pos += 1
    return digits


def adds_csd_rowwise(w: np.ndarray, frac_bits: int = 8) -> np.ndarray:
    """Additions per output row for ``W @ x`` in CSD shift-add form."""
    w = np.asarray(w, dtype=np.float64)
    if w.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {w.shape}")
    digits = csd_digit_count(w, frac_bits)
    row_tot = digits.sum(axis=1)
    return np.maximum(row_tot - 1, 0)


def adds_csd_matrix(w: np.ndarray, frac_bits: int = 8) -> int:
    """Total additions to evaluate ``W @ x`` with CSD-recoded weights."""
    return int(adds_csd_rowwise(w, frac_bits).sum())


def quantization_snr_db(w: np.ndarray, frac_bits: int = 8, word_bits: int | None = None) -> float:
    """SNR (dB) of the fixed-point quantization of ``w``.

    Used as the fidelity target for LCC so baseline and compressed model are
    compared at matched precision (paper Sec. IV).
    """
    w = np.asarray(w, dtype=np.float64)
    q = quantize_fixed(w, frac_bits, word_bits)
    err = float(np.sum((w - q) ** 2))
    sig = float(np.sum(w**2))
    if err == 0.0:
        return np.inf
    if sig == 0.0:
        return 0.0
    return 10.0 * np.log10(sig / err)
