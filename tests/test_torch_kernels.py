"""K1 (lcc_chain_matmul), K2 (lcc_group_matmul), K3 (cluster_segment_sum):
the port's plain versions (what its wrappers run for CPU tensors) against the
JAX kernels in Pallas interpret mode and against the torch oracles — the same
numpy inputs go through both packages.  Bitwise on dyadic inputs, <= 1e-5
otherwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lcc as jlcc
from repro.kernels import ops as jops

from repro_torch.convert import decomposition_from_reference
from repro_torch.kernels import dispatch, ops as tops, ref
from repro_torch.kernels.lcc_chain_matmul import (lcc_chain_matmul,
                                                  lcc_chain_matmul_plain,
                                                  plan_launch, signed_pow2)
from repro_torch.kernels.lcc_group_matmul import (lcc_group_matmul,
                                                  lcc_group_matmul_plain)
from repro_torch.kernels.shared_matmul import (cluster_segment_sum,
                                               cluster_segment_sum_plain,
                                               csr_from_labels)
from repro_torch.testing import decomposition_dense, seeded_decomposition

TOL = 1e-5  # float32 sums taken in another order than the JAX kernel's


def _decompose(shape, seed, algorithm="fp"):
    w = np.random.default_rng(seed).standard_normal(shape) / np.sqrt(shape[1])
    return jlcc.lcc_decompose(w, algorithm=algorithm, target_snr_db=25.0)


@pytest.fixture(scope="module")
def decs():
    return {"a": _decompose((48, 20), 0), "b": _decompose((40, 33), 1),
            "c": _decompose((130, 9), 2), "fs": _decompose((24, 12), 3, "fs")}


def _inputs(k, b, seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:  # multiples of 1/8: every product and partial sum is exact
        return rng.integers(-8, 9, size=(k, b)).astype(np.float32) / 8.0
    return rng.standard_normal((k, b)).astype(np.float32)


def _compare(y_t, y_j, dyadic):
    y_t, y_j = y_t.numpy(), np.asarray(y_j)
    assert y_t.shape == y_j.shape and y_t.dtype == y_j.dtype == np.float32
    if dyadic:
        np.testing.assert_array_equal(y_t, y_j)
    else:
        np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL)


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
@pytest.mark.parametrize("case,b", [("a", 8), ("b", 5), ("c", 1)])
def test_chain_plain_matches_jax_kernel(decs, case, b, dyadic):
    jd = decs[case]
    x = _inputs(jd.shape[1], b, 7, dyadic)
    y_j = jops.apply_packed_decomposition(jops.pack_decomposition(jd),
                                          jnp.asarray(x), interpret=True)
    tp = tops.pack_decomposition(decomposition_from_reference(jd))
    y_t = tops.apply_packed_decomposition(tp, torch.from_numpy(x))
    _compare(y_t, y_j, dyadic)
    # and the float64 numpy evaluation of the same decomposition
    np.testing.assert_allclose(y_t.numpy(), jd.apply(x.astype(np.float64)),
                               rtol=0, atol=1e-5)


def test_chain_plain_matches_torch_oracle(decs):
    jd = decs["b"]
    td = decomposition_from_reference(jd)
    x = torch.from_numpy(_inputs(jd.shape[1], 6, 8, dyadic=True))
    want = sum(ref.lcc_chain_apply_ref(
        [(torch.from_numpy(f.idx), torch.from_numpy(f.exp),
          torch.from_numpy(f.sign)) for f in ch.factors], x[c0:c1])
        for (c0, c1), ch in zip(td.col_slices, td.slices))
    got = tops.apply_packed_decomposition(tops.pack_decomposition(td), x)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_chain_single_packed_chain(decs):
    jd = decs["a"]
    jc = jd.slices[0]
    tc = decomposition_from_reference(jd).slices[0]
    x = _inputs(jc.in_dim, 4, 9, dyadic=True)
    y_j = jops.apply_packed_chain(jops.pack_chain(jc), jnp.asarray(x),
                                  interpret=True)
    y_t = tops.apply_packed_chain(tops.pack_chain(tc), torch.from_numpy(x))
    _compare(y_t, y_j, dyadic=True)


def test_chain_padded_rows_stay_zero_and_lengths_are_honoured(decs):
    """Rows beyond out_dim come out exactly zero; stopping at chain_len (what
    the kernel does) equals running the identity padding (what the plain
    version does)."""
    tp = tops.pack_decomposition(decomposition_from_reference(decs["c"]))
    assert tp.idx.shape[2] > tp.out_dim  # 130 rows pad to 256
    assert len(set(tp.chain_lengths)) > 1 or tp.idx.shape[1] >= 1
    ds = tp.on("cpu")
    x = torch.from_numpy(_inputs(tp.in_dim, 3, 10, dyadic=False))
    y = lcc_chain_matmul(ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w,
                         ds.chain_len)
    assert y.shape == (tp.idx.shape[2], 3)
    assert torch.count_nonzero(y[tp.out_dim:]) == 0
    # explicit early stop, slice by slice
    want = torch.zeros_like(y)
    for e, ((c0, c1), ln) in enumerate(zip(tp.col_slices, tp.chain_lengths)):
        cur = x[c0:c1]
        for p in range(ln):
            coef = signed_pow2(ds.sign[e, p], ds.exp[e, p])
            cur = (coef[..., None] * cur[ds.idx[e, p].long()]).sum(1)
        want += cur
    torch.testing.assert_close(y, want, rtol=0, atol=TOL)


def test_chain_fs_dense_fallback_and_vector_input(decs):
    jd = decs["fs"]
    tp = tops.pack_decomposition(decomposition_from_reference(jd))
    assert tp.dense and not tp.col_slices  # FS programs: dense fallback only
    x = _inputs(jd.shape[1], 1, 11, dyadic=False)[:, 0]
    y_j = jops.apply_packed_decomposition(jops.pack_decomposition(jd),
                                          jnp.asarray(x), interpret=True)
    y_t = tops.apply_packed_decomposition(tp, torch.from_numpy(x))
    assert y_t.shape == (jd.shape[0],)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=TOL)


def test_chain_rejects_wrong_input_width(decs):
    tp = tops.pack_decomposition(decomposition_from_reference(decs["a"]))
    with pytest.raises(ValueError):
        tops.apply_packed_decomposition(tp, torch.zeros(tp.in_dim + 1, 2))


@pytest.mark.parametrize("n,k", [(64, 30), (128, 128), (96, 200)])
def test_seeded_fixture_chains_equal_dense(n, k):
    """The fixture's chains are valid: kernel layout == to_dense() @ x, and
    the per-slice dense equivalent agrees with the numpy containers."""
    dec = seeded_decomposition(n, k, np.random.default_rng(n + k))
    assert {len(s.factors) for s in dec.slices} - {6} and \
        any(len(s.factors) == 6 for s in dec.slices)  # short chains present
    pk = tops.pack_decomposition(dec)
    w = dec.to_dense()
    np.testing.assert_allclose(decomposition_dense(pk, "cpu").numpy(), w,
                               rtol=0, atol=1e-6)
    x = _inputs(k, 8, 12, dyadic=False)
    y = tops.apply_packed_decomposition(pk, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), w @ x.astype(np.float64), rtol=0,
                               atol=2e-5)


# ------------------------------------------------------------------ K2


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
@pytest.mark.parametrize("members,b", [(("a", "b"), 8), (("a", "fs", "c"), 3),
                                       (("c",), 5)])
def test_group_plain_matches_jax_kernel(decs, members, b, dyadic):
    import warnings

    xs = [_inputs(decs[m].shape[1], b, 20 + i, dyadic)
          for i, m in enumerate(members)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jg = jops.pack_group([jops.pack_decomposition(decs[m]) for m in members])
        tg = tops.pack_group([tops.pack_decomposition(
            decomposition_from_reference(decs[m])) for m in members])
    ys_j = jops.apply_packed_group(jg, [jnp.asarray(x) for x in xs],
                                   interpret=True)
    ys_t = tops.apply_packed_group(tg, [torch.from_numpy(x) for x in xs])
    assert len(ys_t) == len(ys_j) == len(members)
    for y_t, y_j in zip(ys_t, ys_j):
        _compare(y_t, y_j, dyadic)


def test_group_equals_members_one_by_one(decs):
    tps = [tops.pack_decomposition(decomposition_from_reference(decs[m]))
           for m in ("a", "b")]
    xs = [torch.from_numpy(_inputs(tp.in_dim, 4, 30 + i, dyadic=True))
          for i, tp in enumerate(tps)]
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ys = tops.apply_packed_group(tops.pack_group(tps), xs)
    for tp, x, y in zip(tps, xs, ys):
        assert torch.equal(y, tops.apply_packed_decomposition(tp, x))


def test_group_rejects_wrong_member_count(decs):
    tp = tops.pack_decomposition(decomposition_from_reference(decs["a"]))
    with pytest.raises(ValueError):
        tops.apply_packed_group(tops.pack_group([tp]), [])


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
@pytest.mark.parametrize("k,c,b", [(64, 16, 8), (130, 37, 5), (200, 128, 1),
                                   (300, 129, 3)])
def test_segment_sum_matches_jax_kernel(k, c, b, dyadic):
    rng = np.random.default_rng(k + c)
    labels = np.concatenate([rng.permutation(c), rng.integers(0, c, k - c)])
    labels = labels[rng.permutation(k)].astype(np.int32)
    x = _inputs(k, b, 40, dyadic)
    y_j = jops.segment_sum_tpu(jnp.asarray(labels), jnp.asarray(x), c,
                               interpret=True)
    lt, xt = torch.from_numpy(labels), torch.from_numpy(x)
    y_t = tops.segment_sum(lt, xt, c)
    _compare(y_t, y_j, dyadic)
    torch.testing.assert_close(y_t, ref.cluster_segment_sum_ref(lt, xt, c),
                               rtol=0, atol=TOL)
    assert torch.equal(y_t, cluster_segment_sum_plain(lt, xt, c))
    # the CSR form the kernel walks: ascending rows inside a cluster
    order, offsets = csr_from_labels(labels, c)
    want = torch.stack([xt[order[offsets[i]:offsets[i + 1]].long()].sum(0)
                        for i in range(c)])
    torch.testing.assert_close(y_t, want, rtol=0, atol=TOL)
    assert all((np.diff(order[offsets[i]:offsets[i + 1]].numpy()) > 0).all()
               for i in range(c))


def test_shared_matmul_is_centroids_times_segment_sum():
    rng = np.random.default_rng(5)
    labels = torch.from_numpy(rng.integers(0, 6, 20).astype(np.int64))
    g = torch.from_numpy(rng.standard_normal((9, 6)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((20, 4)).astype(np.float32))
    y_j = jops.shared_matmul_tpu(jnp.asarray(g.numpy()),
                                 jnp.asarray(labels.numpy().astype(np.int32)),
                                 jnp.asarray(x.numpy()), interpret=True)
    y_t = tops.shared_matmul(g, labels, x)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=TOL)
    torch.testing.assert_close(y_t, g[:, labels] @ x, rtol=0, atol=TOL)


def test_segment_sum_rejects_bad_labels():
    with pytest.raises(ValueError):
        csr_from_labels(np.array([0, 3]), 3)
    with pytest.raises(ValueError):
        cluster_segment_sum(torch.zeros(3, dtype=torch.long), torch.zeros(4, 2), 2)


# ------------------------------------------------------- dispatch and plan


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(decs):
    tp = tops.pack_decomposition(decomposition_from_reference(decs["a"]))
    ds = tp.on("cpu")
    x = torch.from_numpy(_inputs(tp.in_dim, 2, 50, dyadic=True))
    dispatch.reset_launch_count()
    args = (ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w, ds.chain_len)
    assert torch.equal(lcc_chain_matmul(*args), lcc_chain_matmul_plain(*args))
    gargs = tuple(t[None] if i != 3 else t for i, t in enumerate(args))
    assert torch.equal(lcc_group_matmul(*gargs), lcc_group_matmul_plain(*gargs))
    cluster_segment_sum(torch.zeros(4, dtype=torch.long), torch.ones(4, 2), 1)
    assert dispatch.launch_count() == 0 and dispatch.launch_counts() == {}
    dispatch.record_launch("lcc_chain_matmul")
    dispatch.record_launch("cluster_segment_sum", 2, shape=(4, 1, 2))
    assert dispatch.launch_count() == 3
    assert dispatch.launch_count("cluster_segment_sum") == 2
    assert dispatch.launch_counts_by_shape() == {
        ("cluster_segment_sum", (4, 1, 2)): 2}
    dispatch.reset_launch_count()
    assert dispatch.launch_count() == 0
    assert dispatch.launch_counts_by_shape() == {}


def test_dispatch_refuses_other_devices():
    with pytest.raises(NotImplementedError):
        dispatch.on_device(torch.empty(1, device="meta"))
    with pytest.raises(RuntimeError):
        dispatch.check_launch(9, "some_kernel")
    dispatch.check_launch(0, "some_kernel")


@pytest.mark.parametrize("n,b,g,e,want_bb", [
    (2048, 8, 1, 187, 8), (2048, 8, 1, 745, 8), (2048, 8, 3, 187, 8),
    (8192, 8, 2, 158, 2), (128, 5, 1, 19, 8), (128, 1, 1, 19, 1),
    (4096, 8, 1, 10, 4)])
def test_plan_launch_geometry(n, b, g, e, want_bb):
    bb, threads, chunks, spb = plan_launch(n, b, g, e, sm_count=132)
    assert bb == want_bb
    assert 2 * n * bb * 4 <= 232448  # two [N, bb] float32 buffers fit
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert chunks * spb >= e > (chunks - 1) * spb  # every slice, no empty block
    assert chunks <= e


def test_plan_launch_refuses_rows_beyond_shared_memory():
    with pytest.raises(NotImplementedError):
        plan_launch(40000, 8, 1, 4, sm_count=132)


def test_signed_pow2_is_exact():
    exp = torch.arange(-16, 16, dtype=torch.int8)
    for s in (-1, 1):
        sign = torch.full_like(exp, s)
        want = s * np.exp2(exp.numpy().astype(np.float64))
        np.testing.assert_array_equal(signed_pow2(sign, exp).numpy(),
                                      want.astype(np.float32))
    assert signed_pow2(torch.zeros(1, dtype=torch.int8),
                       torch.zeros(1, dtype=torch.int8)).item() == 0.0
