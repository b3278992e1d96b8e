"""Port packers against the JAX package's: the same decompositions (made by
``repro.core.lcc.lcc_decompose``, carried across as numpy) must pack into
bitwise equal kernel streams and metadata."""
import numpy as np
import pytest

from repro.core import lcc as jlcc
from repro.kernels import ops as jops

from repro_torch.convert import decomposition_from_reference
from repro_torch.core import lcc as tlcc
from repro_torch.kernels import ops as tops

CASES = {
    "fp_tall": dict(shape=(48, 20), algorithm="fp", seed=0),
    "fp_wide_slices": dict(shape=(32, 37), algorithm="fp", seed=1),
    "fp_block_multiple": dict(shape=(130, 9), algorithm="fp", seed=2),
    "fs_only": dict(shape=(24, 12), algorithm="fs", seed=3),
}


def _decompose(shape, algorithm, seed):
    w = np.random.default_rng(seed).standard_normal(shape) / np.sqrt(shape[1])
    return jlcc.lcc_decompose(w, algorithm=algorithm, target_snr_db=25.0)


@pytest.fixture(scope="module")
def decs():
    return {k: _decompose(**v) for k, v in CASES.items()}


def _assert_streams_equal(j, t):
    for f in ("idx", "exp", "sign"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_containers_carry_across(decs, case):
    jd = decs[case]
    td = decomposition_from_reference(jd)
    assert td.shape == jd.shape and td.col_slices == list(jd.col_slices)
    assert td.num_adds() == jd.num_adds()
    assert td.storage_bytes() == jd.storage_bytes()
    np.testing.assert_array_equal(td.to_dense(), jd.to_dense())
    x = np.random.default_rng(9).standard_normal((jd.shape[1], 3))
    np.testing.assert_array_equal(td.apply(x), jd.apply(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_decomposition_bitwise(decs, case):
    jd = decs[case]
    jp = jops.pack_decomposition(jd)
    tp = tops.pack_decomposition(decomposition_from_reference(jd))
    _assert_streams_equal(jp, tp)
    assert tuple(jp.col_slices) == tuple(tp.col_slices)
    assert tuple(jp.chain_lengths) == tuple(tp.chain_lengths)
    assert (jp.in_dim, jp.out_dim, jp.d_pad, jp.first_width) == \
        (tp.in_dim, tp.out_dim, tp.d_pad, tp.first_width)
    assert len(jp.dense) == len(tp.dense)
    for (jcs, jw), (tcs, tw) in zip(jp.dense, tp.dense):
        assert tuple(jcs) == tuple(tcs)
        np.testing.assert_array_equal(np.asarray(jw), tw)


@pytest.mark.parametrize("case", ["fp_tall", "fp_wide_slices", "fp_block_multiple"])
def test_pack_chain_bitwise(decs, case):
    jd = decs[case]
    td = decomposition_from_reference(jd)
    for jc, tc in zip(jd.slices, td.slices):
        jp, tp = jops.pack_chain(jc), tops.pack_chain(tc)
        _assert_streams_equal(jp, tp)
        assert (jp.in_dim, jp.out_dim, jp.d_pad, jp.first_width, jp.n_factors) \
            == (tp.in_dim, tp.out_dim, tp.d_pad, tp.first_width, tp.n_factors)
        assert jp.compact_bytes == tp.compact_bytes


def test_pack_empty_chain_is_identity_factor():
    jp = jops.pack_chain(jlcc.LCCChain(factors=[], in_dim=5))
    tp = tops.pack_chain(tlcc.LCCChain(factors=[], in_dim=5))
    _assert_streams_equal(jp, tp)
    assert (jp.first_width, jp.n_factors) == (tp.first_width, tp.n_factors) == (5, 1)


@pytest.mark.parametrize("members", [("fp_tall", "fp_wide_slices"),
                                     ("fp_tall", "fs_only", "fp_block_multiple"),
                                     ("fp_block_multiple",)])
def test_pack_group_bitwise_with_waste_report(decs, members):
    import warnings

    jm = [jops.pack_decomposition(decs[m]) for m in members]
    tm = [tops.pack_decomposition(decomposition_from_reference(decs[m]))
          for m in members]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # badly matched members warn on purpose
        jg, tg = jops.pack_group(jm), tops.pack_group(tm)
    _assert_streams_equal(jg, tg)
    assert (jg.d_pad, jg.first_width, jg.n_groups) == \
        (tg.d_pad, tg.first_width, tg.n_groups)
    assert jg.waste == tg.waste


def test_pack_group_rejects_empty():
    with pytest.raises(ValueError):
        tops.pack_group([])


def test_slice_tables_mark_dead_and_short_chains():
    """chain_len is the real factor count, 0 for an all-zero slice; a group
    member's slice offsets are shifted by the inputs before it."""
    rng = np.random.default_rng(4)
    f = lambda n, k, sign: tlcc.LCCFactor(  # noqa: E731
        rng.integers(0, k, (n, 2)).astype(np.int32), np.zeros((n, 2), np.int8),
        np.full((n, 2), sign, np.int8), in_dim=k)
    dec = tlcc.LCCDecomposition(
        shape=(6, 7), col_slices=[(0, 3), (3, 5), (5, 7)],
        slices=[tlcc.LCCChain([f(6, 3, 1), f(6, 6, 1)], 3),
                tlcc.LCCChain([f(6, 2, 0)], 2),  # dead: every sign 0
                tlcc.LCCChain([f(6, 2, -1)], 2)],
        algorithm="fp", target_snr_db=0.0)
    pk = tops.pack_decomposition(dec)
    c0, w, ln = pk.slice_tables()
    assert c0.tolist() == [0, 3, 5] and w.tolist() == [3, 2, 2]
    assert ln.tolist() == [2, 0, 1]
    ds = tops.pack_group([pk, pk]).on("cpu")
    assert ds.slice_c0.tolist() == [[0, 3, 5], [7, 10, 12]]
    assert ds.chain_len.tolist() == [[2, 0, 1], [2, 0, 1]]


def test_plan_col_slices_matches_reference():
    for n, k in [(2048, 2048), (8192, 2048), (2048, 8192), (128, 256), (3, 40)]:
        assert tlcc.plan_col_slices(n, k) == jlcc.plan_col_slices(n, k)
    assert tlcc.plan_col_slices(64, 10, slice_width=4) == \
        jlcc.plan_col_slices(64, 10, slice_width=4)
