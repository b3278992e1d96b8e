"""LCC decomposition: the port's ``core.lcc`` algorithms against the
reference's on the same seeded numpy matrices, bitwise — FP (matching
pursuit, S-escalation) and FS slices, whole decompositions, the zero pieces
and the re-addressing of shrunk slices.  The matrices carry ties (equal rows,
so equal energies and equal correlations) and zero rows."""
import numpy as np
import pytest

from repro.core import lcc as jlcc
from repro_torch.core import lcc as tlcc


def assert_piece_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    if isinstance(b, tlcc.FSProgram):
        assert a.n_inputs == b.n_inputs
        assert a.nodes.dtype == b.nodes.dtype and np.array_equal(a.nodes, b.nodes)
        assert np.array_equal(a.outputs, b.outputs)
        return
    assert a.in_dim == b.in_dim and len(a.factors) == len(b.factors)
    for fa, fb in zip(a.factors, b.factors):
        assert fa.in_dim == fb.in_dim
        for f in ("idx", "exp", "sign"):
            x, y = getattr(fa, f), getattr(fb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def assert_dec_equal(a, b):
    assert a.shape == b.shape and a.col_slices == b.col_slices
    assert a.algorithm == b.algorithm and a.target_snr_db == b.target_snr_db
    assert a.meta == b.meta
    for pa, pb in zip(a.slices, b.slices, strict=True):
        assert_piece_equal(pa, pb)
    assert a.to_dense().tobytes() == b.to_dense().tobytes()
    assert a.num_adds() == b.num_adds()
    assert a.storage_bytes() == b.storage_bytes()


def _mat(seed, n, k):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k))
    w[1] = w[0]  # equal energies: the row order breaks the tie
    w[3] = 0.0  # a structurally zero (pruned) row
    w[5] = -w[4]
    return w


@pytest.mark.parametrize("alg", ["fp", "fs"])
@pytest.mark.parametrize("seed,n,k", [(0, 24, 5), (1, 40, 6), (2, 13, 3)])
def test_slice_bitwise(alg, seed, n, k):
    we = _mat(seed, n, k)
    snr = jlcc.resolve_target_snr_db(we, None, 8)
    assert tlcc.resolve_target_snr_db(we, None, 8) == snr
    a = jlcc.lcc_decompose_slice(we, alg, snr)
    b = tlcc.lcc_decompose_slice(we, alg, snr)
    assert_piece_equal(a, b)
    assert np.array_equal(a.to_dense(), b.to_dense())


@pytest.mark.parametrize("alg", ["fp", "fs"])
@pytest.mark.parametrize("kw", [{}, {"target_snr_db": 30.0, "slice_width": 4},
                                {"s_terms": 3, "frac_bits": 6, "max_factors": 3}])
def test_lcc_decompose_bitwise(alg, kw):
    w = _mat(3, 32, 21)
    assert_dec_equal(jlcc.lcc_decompose(w, alg, **kw),
                     tlcc.lcc_decompose(w, alg, **kw))


def test_helpers_bitwise():
    rng = np.random.default_rng(5)
    # exact midpoints 1.5 * 2^e, zeros, values beyond the exponent range
    c = np.concatenate([rng.standard_normal(200) * 4.0,
                        1.5 * np.exp2(np.arange(-20, 20, dtype=np.float64)),
                        [0.0, -0.0, 2.0 ** -18, 2.0 ** 17, -3.0]])
    for x, y in zip(jlcc._quantize_po2(c, jlcc._EXP_RANGE),
                    tlcc._quantize_po2(c, tlcc.EXP_RANGE)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    w = _mat(6, 10, 7)
    w_hat = w + rng.standard_normal(w.shape) * 1e-3
    assert tlcc.snr_db(w, w_hat) == jlcc.snr_db(w, w_hat)
    assert tlcc.snr_db(w, w) == np.inf and tlcc.snr_db(0 * w, w) == jlcc.snr_db(0 * w, w)
    assert tlcc.resolve_target_snr_db(np.full((2, 2), 0.5), None, 8) == \
        jlcc.resolve_target_snr_db(np.full((2, 2), 0.5), None, 8)
    for n, k, sw in ((300, 784, None), (10, 300, None), (7, 5, 2), (64, 3, 9)):
        assert tlcc.plan_col_slices(n, k, sw) == jlcc.plan_col_slices(n, k, sw)
    with pytest.raises(ValueError):
        tlcc.lcc_decompose_slice(w, "xx", 20.0)
    with pytest.raises(ValueError):
        tlcc.lcc_decompose(np.zeros(4))


@pytest.mark.parametrize("alg", ["fp", "fs"])
def test_zero_pieces(alg):
    a, b = jlcc.zero_slice_piece(alg, 6, 4), tlcc.zero_slice_piece(alg, 6, 4)
    assert_piece_equal(a, b)
    assert b.num_adds() == 0 and not b.to_dense().any()
    assert not tlcc._slice_nonzero(b)


@pytest.mark.parametrize("alg", ["fp", "fs"])
def test_expand_slice_piece(alg):
    """A shrunk slice decomposed on its live columns, re-addressed to the
    full slice width: bitwise the reference's, and its dense map is the
    compact one scattered into the kept columns."""
    w = _mat(7, 20, 8)
    keep = np.array([0, 2, 3, 6])
    compact = w[:, keep]
    snr = jlcc.resolve_target_snr_db(compact, None, 8)
    pa = jlcc.lcc_decompose_slice(compact, alg, snr)
    pb = tlcc.lcc_decompose_slice(compact, alg, snr)
    ea, eb = jlcc.expand_slice_piece(pa, keep, 8), tlcc.expand_slice_piece(pb, keep, 8)
    assert_piece_equal(ea, eb)
    full = np.zeros((20, 8))
    full[:, keep] = pb.to_dense()
    assert np.array_equal(eb.to_dense(), full)
    assert eb.num_adds() == pb.num_adds()


def test_expand_empty_chain_is_a_gather():
    keep = np.array([1, 4])
    a = jlcc.expand_slice_piece(jlcc.LCCChain(factors=[], in_dim=2), keep, 5)
    b = tlcc.expand_slice_piece(tlcc.LCCChain(factors=[], in_dim=2), keep, 5)
    assert_piece_equal(a, b)
    assert np.array_equal(b.to_dense(), np.eye(5)[keep])


def test_assemble_records_meta():
    w = _mat(8, 16, 9)
    cols = tlcc.plan_col_slices(16, 9)
    pieces_a = [jlcc.lcc_decompose_slice(w[:, c0:c1], "fp", 25.0) for c0, c1 in cols]
    pieces_b = [tlcc.lcc_decompose_slice(w[:, c0:c1], "fp", 25.0) for c0, c1 in cols]
    a = jlcc.assemble_decomposition(w, cols, pieces_a, "fp", 25.0)
    b = tlcc.assemble_decomposition(w, cols, pieces_b, "fp", 25.0)
    assert_dec_equal(a, b)
    assert b.meta["achieved_snr_db"] == b.achieved_snr_db(w)
