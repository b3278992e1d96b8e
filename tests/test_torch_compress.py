"""Algorithm 1, steps 2-3: the port's ``core.compress`` against the
reference's on the same seeded numpy weights, bitwise — dense units with
pruning (dropped and kept in place) and weight sharing (affinity propagation
and a fixed cluster count), conv kernels (FK and PK, a pruned channel,
subsampling) and ``compress_model_params`` with its cost report."""
import os

import numpy as np
import pytest

from repro.core import compress as jc
from repro.core.cost import ModelCostReport as JReport
from repro_torch.core import compress as tc
from repro_torch.core.cost import ModelCostReport as TReport


def report_rows(rep):
    return [(l.name, l.baseline_adds, l.stage_adds, l.stage_bytes, l.extra)
            for l in rep.layers]


def assert_dense_equal(a, b, check_name=True):
    assert a.name == b.name or not check_name
    assert np.array_equal(a.kept_columns, b.kept_columns)
    assert a.effective.tobytes() == b.effective.tobytes()
    assert (a.shared is None) == (b.shared is None)
    if a.shared is not None:
        assert a.shared.labels.dtype == b.shared.labels.dtype
        assert a.shared.labels.tobytes() == b.shared.labels.tobytes()
        assert a.shared.centroids.tobytes() == b.shared.centroids.tobytes()
    da, db = a.decomposition, b.decomposition
    assert da.col_slices == db.col_slices and da.meta == db.meta
    assert da.target_snr_db == db.target_snr_db
    assert da.to_dense().tobytes() == db.to_dense().tobytes()
    assert da.num_adds() == db.num_adds()


def assert_conv_equal(a, b):
    assert a["lcc_adds"] == b["lcc_adds"] and a["scale"] == b["scale"]
    assert a["channels_nonzero"] == b["channels_nonzero"]
    assert a["baseline_adds"] == b["baseline_adds"]
    assert sorted(a["decompositions"]) == sorted(b["decompositions"])
    for ch, d in a["decompositions"].items():
        assert d.to_dense().tobytes() == b["decompositions"][ch].to_dense().tobytes()
        assert d.meta == b["decompositions"][ch].meta


def _weight(seed, shape=(24, 30), dead=6):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape)
    w[:, rng.choice(shape[1], dead, replace=False)] = 0.0  # prox-dead inputs
    w[:, 7] = w[:, 8]  # a cluster the sharing must find
    return w


DENSE_CFGS = {
    "fp_shared": dict(algorithm="fp", weight_sharing=True),
    "fs_shared": dict(algorithm="fs", weight_sharing=True, share_damping=0.8),
    "fp_share_bound": dict(algorithm="fp", max_share_rel_err=0.06),
    "fixed_clusters": dict(algorithm="fp", share_clusters=9),
    "keep_in_place": dict(algorithm="fp", weight_sharing=False, prune_tol=-1e-9),
    "fs_keep_in_place": dict(algorithm="fs", prune_tol=-1e-9, s_terms=3),
}


@pytest.mark.parametrize("name", list(DENSE_CFGS))
def test_dense_bitwise(name):
    w = _weight(1)
    ra, rb = JReport(), TReport()
    a = jc.compress_dense_matrix("u", w, jc.CompressionConfig(**DENSE_CFGS[name]), ra)
    b = tc.compress_dense_matrix("u", w, tc.CompressionConfig(**DENSE_CFGS[name]), rb)
    assert_dense_equal(a, b)
    assert report_rows(ra) == report_rows(rb)
    x = np.random.default_rng(2).standard_normal((30, 3))
    assert np.array_equal(a.apply(x), b.apply(x))


def test_prepare_and_slice_plan_bitwise():
    w = _weight(3, dead=9)
    for kw in (dict(prune_tol=-1e-9, weight_sharing=False), {}):
        ca, cb = jc.CompressionConfig(**kw), tc.CompressionConfig(**kw)
        pa, pb = jc.prepare_dense("u", w, ca), tc.prepare_dense("u", w, cb)
        assert pa.target.tobytes() == pb.target.tobytes()
        assert pa.col_slices == pb.col_slices
        assert (pa.target_snr_db, pa.baseline_adds, pa.pruned_adds, pa.pre_agg) == \
            (pb.target_snr_db, pb.baseline_adds, pb.pruned_adds, pb.pre_agg)
        ja, jb = jc.slice_job_plan(pa, ca), tc.slice_job_plan(pb, cb)
        assert [(i, cs) for i, cs, _, _ in ja] == [(i, cs) for i, cs, _, _ in jb]
        for (_, _, ma, ka), (_, _, mb, kb) in zip(ja, jb):
            assert ma.tobytes() == mb.tobytes()
            assert (ka is None and kb is None) or np.array_equal(ka, kb)
    for tol in (1e-8, -1e-8, 1e9):
        (wa, ka), (wb, kb) = jc.prune_columns(w, tol), tc.prune_columns(w, tol)
        assert wa.tobytes() == wb.tobytes() and np.array_equal(ka, kb)


@pytest.mark.parametrize("method", ["fk", "pk"])
@pytest.mark.parametrize("sub", [None, 2])
def test_conv_bitwise(method, sub):
    rng = np.random.default_rng(4)
    kern = rng.standard_normal((6, 5, 3, 3))
    kern[:, 2] = 0.0  # a group-lasso-pruned input channel
    kw = dict(algorithm="fp", conv_method=method)
    ra, rb = JReport(), TReport()
    a = jc.compress_conv_kernel("c", kern, jc.CompressionConfig(**kw), ra, sub)
    b = tc.compress_conv_kernel("c", kern, tc.CompressionConfig(**kw), rb, sub)
    assert_conv_equal(a, b)
    assert report_rows(ra) == report_rows(rb)


def test_compress_model_params_and_report(tmp_path):
    rng = np.random.default_rng(5)
    units_a = [jc.CompressibleDense("d0", _weight(6)),
               jc.CompressibleDense("d1", rng.standard_normal((16, 12))),
               jc.CompressibleConv("c0", rng.standard_normal((4, 3, 3, 3)))]
    units_b = [tc.CompressibleDense(u.name, u.weight) if hasattr(u, "weight")
               else tc.CompressibleConv(u.name, u.kernel) for u in units_a]
    cfg = dict(algorithm="fp", max_share_rel_err=0.06)
    ra, repa = jc.compress_model_params(units_a, jc.CompressionConfig(**cfg))
    rb, repb = tc.compress_model_params(units_b, tc.CompressionConfig(**cfg))
    assert list(ra) == list(rb)
    assert_dense_equal(ra["d0"], rb["d0"])
    assert_dense_equal(ra["d1"], rb["d1"])
    assert_conv_equal(ra["c0"], rb["c0"])
    assert report_rows(repa) == report_rows(repb)
    assert repb.table() == repa.table()
    for stage in ("pruned", "shared", "lcc"):
        assert repb.total_stage(stage) == repa.total_stage(stage)
        assert repb.ratio(stage) == repa.ratio(stage)
    assert repb.total_baseline() == repa.total_baseline()
    # cache_dir: the durable slice cache, the same records from a warm cache
    cache = str(tmp_path / "cache")
    rc, repc = tc.compress_model_params(units_b, tc.CompressionConfig(**cfg),
                                        cache_dir=cache)
    assert os.listdir(cache) and report_rows(repc) == report_rows(repb)
    rw, _ = tc.compress_model_params(units_b, tc.CompressionConfig(**cfg),
                                     cache_dir=cache)
    assert_dense_equal(rw["d0"], rb["d0"])
    assert_conv_equal(rw["c0"], rb["c0"])
