"""The compression pipeline: the port's ``run_pipeline`` against the
reference's serial run, bitwise; its worker pool (``n_workers=2``, a
forkserver pool) against its serial run; tied-weight cache hits; the
allocator's chosen plans against the reference's; the event kinds in order;
and the metrics registry the reference's ``metrics=`` feeds.
The durable cache and resumable runs are ``test_torch_pipeline_resume.py``'s."""
import numpy as np
import pytest

from repro.core import compress as jc
from repro.pipeline import allocator as jalloc
from repro.pipeline import cache as jcache
from repro.pipeline import run_pipeline as jrun
from repro_torch.core import compress as tc
from repro_torch.core.lcc import LCCChain
from repro_torch.models import api as tapi
from repro_torch.pipeline import allocator as talloc
from repro_torch.pipeline import cache as tcache
from repro_torch.pipeline import run_pipeline as trun

from test_torch_compress import assert_conv_equal, assert_dense_equal, report_rows


def _units(pkg, seed=0, shape=(40, 20), sparse=False):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(shape) for _ in range(3)]
    if sparse:  # an all-dead slice (skipped) and partly dead ones (shrunk)
        ws[0][:, :6] = 0.0
        ws[0][:, rng.choice(np.arange(6, shape[1]), 5, replace=False)] = 0.0
    kern = rng.standard_normal((6, 3, 3, 3))
    units = [pkg.CompressibleDense(name=f"d{i}", weight=w) for i, w in enumerate(ws)]
    return units + [pkg.CompressibleConv(name="c0", kernel=kern)]


def _cfg(pkg, **kw):
    return pkg.CompressionConfig(**{"algorithm": "fp", "max_share_rel_err": 0.06,
                                    **kw})


def assert_results_equal(a, b):
    assert list(a.records) == list(b.records)
    for n, ra in a.records.items():
        (assert_conv_equal if isinstance(ra, dict) else assert_dense_equal)(
            ra, b.records[n])
    assert report_rows(a.report) == report_rows(b.report)
    for k in ("units", "jobs", "dead_groups", "skipped_jobs", "shrunk_jobs",
              "cache_hits", "cache_misses"):
        assert a.stats[k] == b.stats[k], k


@pytest.mark.parametrize("cfg", [{}, {"prune_tol": -1e-9, "weight_sharing": False},
                                 {"algorithm": "fs", "share_clusters": 6}],
                         ids=["drop", "keep_in_place", "fs_fixed_clusters"])
def test_serial_equals_reference_serial(cfg):
    ja = jrun(_units(jc, sparse=True), _cfg(jc, **cfg), n_workers=1)
    tb = trun(_units(tc, sparse=True), _cfg(tc, **cfg), n_workers=1)
    assert_results_equal(ja, tb)
    if cfg.get("prune_tol", 0) < 0:
        assert tb.stats["skipped_jobs"] + tb.stats["shrunk_jobs"] >= 1


def test_two_workers_equal_serial():
    units = _units(tc, sparse=True)
    cfg = _cfg(tc, prune_tol=-1e-9, weight_sharing=False)
    serial = trun(units, cfg, n_workers=1)
    parallel = trun(units, cfg, n_workers=2)
    assert parallel.stats["workers"] == 2
    assert_results_equal(serial, parallel)


def test_tied_weights_hit_the_cache():
    w = np.random.default_rng(3).standard_normal((40, 20))
    units = [tc.CompressibleDense("tied_a", w), tc.CompressibleDense("tied_b", w.copy())]
    res = trun(units, _cfg(tc))
    n = len(res.records["tied_a"].decomposition.col_slices)
    assert res.stats["cache_hits"] >= n and res.stats["cache_misses"] == n
    assert_dense_equal(res.records["tied_a"], res.records["tied_b"],
                       check_name=False)
    ja = jrun([jc.CompressibleDense(u.name, u.weight) for u in units], _cfg(jc))
    assert (ja.stats["cache_hits"], ja.stats["cache_misses"]) == \
        (res.stats["cache_hits"], res.stats["cache_misses"])


def test_cache_keys_and_fresh_pieces():
    rng = np.random.default_rng(4)
    mat = rng.standard_normal((12, 5))
    knobs = {"kind": "dense_slice", "algorithm": "fp", "target_snr_db": 31.5,
             "s_terms": 2, "max_factors": 24, "max_terms_per_row": 64}
    assert tcache.job_key(mat, knobs) == jcache.job_key(mat, knobs)
    assert tcache.job_key(mat.astype(np.float32), knobs) == jcache.job_key(mat, knobs) \
        or mat.astype(np.float32).astype(np.float64).tobytes() != mat.tobytes()
    from repro_torch.core.lcc import lcc_decompose, lcc_decompose_slice
    cache = tcache.SliceCache()
    for piece in (lcc_decompose_slice(mat, "fp", 30.0),
                  lcc_decompose_slice(mat, "fs", 30.0), lcc_decompose(mat)):
        cache.put("k", piece)
        got = cache.get("k")
        assert got is not piece and type(got) is type(piece)
        assert got.to_dense().tobytes() == piece.to_dense().tobytes()
        if isinstance(piece, LCCChain):
            assert all(np.array_equal(a.idx, b.idx) and a.idx.dtype == b.idx.dtype
                       for a, b in zip(got.factors, piece.factors))
    assert cache.get("missing") is None and (cache.hits, cache.misses) == (3, 1)
    assert len(cache) == 1


def test_allocator_chooses_the_reference_plans():
    base_j, base_t = _cfg(jc), _cfg(tc)
    assert [vars(c) for c in jalloc.candidate_ladder(base_j)] == \
        [vars(c) for c in talloc.candidate_ladder(base_t)]
    units_j, units_t = _units(jc, shape=(24, 16))[:2], _units(tc, shape=(24, 16))[:2]
    floor = trun(units_t, talloc.candidate_ladder(base_t)[0]).report.total_stage("lcc")
    budget = int(floor * 1.6)
    ja = jrun(units_j, base_j, budget_adds=budget)
    tb = trun(units_t, base_t, budget_adds=budget)
    assert {n: vars(c) for n, c in ja.unit_configs.items()} == \
        {n: vars(c) for n, c in tb.unit_configs.items()}
    assert ja.budget_info == tb.budget_info
    assert_results_equal(ja, tb)
    assert tb.report.total_stage("lcc") <= budget


def test_events_in_order():
    ej, et = [], []
    jrun(_units(jc, sparse=True), _cfg(jc, prune_tol=-1e-9), progress=ej.append)
    trun(_units(tc, sparse=True), _cfg(tc, prune_tol=-1e-9), progress=et.append)
    assert [(e.kind, e.unit, e.detail) for e in ej] == \
        [(e.kind, e.unit, e.detail) for e in et]
    kinds = [e.kind for e in et]
    assert kinds.index("plan") < kinds.index("slice_done") < kinds.index("unit_done")
    assert "skip" in kinds
    done = [e for e in et if e.kind == "unit_done"]
    assert [e.unit for e in done] == ["d0", "d1", "d2", "c0"]
    assert [(e.adds_before, e.adds_after) for e in done] == \
        [(e.adds_before, e.adds_after) for e in ej if e.kind == "unit_done"]
    assert all(e.unit in str(e) for e in done)


OPTIONS = [("metrics", "pipeline_events_total")]


@pytest.mark.parametrize("entry", ["run_pipeline", "compress_model"])
@pytest.mark.parametrize("kw,metric", OPTIONS, ids=[r[0] for r in OPTIONS])
def test_unported_options_are_refused(entry, kw, metric):
    """The reference's options, each taken now: ``metrics=`` (a
    ``MetricsRegistry``) receives the event stream and the run stats."""
    from repro_torch.models.mlp import MLPConfig, init_mlp
    from repro_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    if entry == "run_pipeline":
        res = trun(_units(tc), _cfg(tc), **{kw: reg})
        stats = res.stats
    else:
        params = init_mlp(0, in_dim=8, hidden=6, classes=3, device="cpu")
        stats = tapi.compress_model(params, MLPConfig(8, 6, 3),
                                    **{kw: reg}).pipeline_stats
    assert reg.get(metric).get(kind="unit_done") == stats["units"]
    assert reg.get("pipeline_run").get(stat="jobs") == stats["jobs"]
