"""The port's compressed executor against the JAX package's per-region route:
an artifact from the real compressor (``repro.models.api.compress_model``,
reduced olmo-1b) is carried across; decode through the port's executor with
``use_plans=False`` (the K1-K3 route) == JAX decode with
``CompressedExecutor(art, use_plans=False)`` == the dense-effective weights,
<= 1e-4 including the KV state and a second step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import artifact_from_reference
from repro_torch.kernels import dispatch
from repro_torch.models import api as tapi
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import (CompressedExecutor, GroupedLCCMatvec,
                                          LCCMatvec, matvecs_from_artifact)
from repro_torch.testing import dense_sites, seeded_artifact

TOL = 1e-4
SHARED = ("attn.o.l0", "attn.k.l1", "ffn.up.l0", "ffn.down.l1")


@pytest.fixture(scope="module")
def arts():
    """(jax artifact, port artifact): every site compressed by the real FP
    compressor; the SHARED sites are compressed again with weight sharing
    forced on, so the segment-sum kernel's sites exist on both sides."""
    cfg = jreduced(jget_arch("olmo-1b"), vocab=256)
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    art = japi.compress_model(
        params, cfg, jcore.CompressionConfig(algorithm="fp", max_share_rel_err=0.06))
    forced = japi.compress_model(
        art.params, cfg,
        jcore.CompressionConfig(algorithm="fp", weight_sharing=True,
                                max_share_rel_err=None),
        include=lambda n: n in SHARED)
    for name in SHARED:
        assert forced.records[name].shared is not None
        art.records[name] = forced.records[name]
        art.packed[name] = forced.packed[name]
    art.params = forced.params
    return art, artifact_from_reference(art, "cpu")


def _np(t):
    return t.detach().to(torch.float32).numpy()


def test_artifact_carries_across(arts):
    jart, tart = arts
    assert set(tart.records) == set(jart.records) and len(tart.records) == 14
    assert tart.dense_unit_names() == list(jart.records)
    assert tart.family == "dense"
    for name, jr in jart.records.items():
        tr = tart.records[name]
        np.testing.assert_array_equal(tr.kept_columns, jr.kept_columns)
        np.testing.assert_array_equal(tr.effective, jr.effective)
        assert (tr.shared is None) == (jr.shared is None)
        if jr.shared is not None:
            np.testing.assert_array_equal(tr.shared.labels, jr.shared.labels)
            np.testing.assert_array_equal(tr.shared.centroids, jr.shared.centroids)
            assert tr.shared.n_clusters == jr.shared.n_clusters
            assert tr.shared.pre_aggregation_adds() == jr.shared.pre_aggregation_adds()
        x = np.random.default_rng(0).standard_normal((jr.decomposition.shape[1]
                                                      if jr.shared is None else
                                                      jr.kept_columns.size, 2))
        xo = np.zeros((int(jr.kept_columns.max()) + 1, 2))
        xo[jr.kept_columns] = x[: jr.kept_columns.size]
        np.testing.assert_array_equal(tr.apply(xo), jr.apply(xo))
    assert tart.compression.algorithm == "fp"
    assert tart.unit_config_for("attn.q.l0") == tart.compression
    # the cost report and the packed kernel buffers cross too
    assert tart.report.table() == jart.report.table()
    assert list(tart.packed) == list(jart.packed)
    for name, jp in jart.packed.items():
        assert np.array_equal(tart.packed[name].idx, np.asarray(jp.idx))


@pytest.mark.parametrize("name", ["attn.o.l0", "ffn.down.l1", "attn.q.l0"])
def test_site_matvec_matches_reference_and_dense(arts, name):
    jart, tart = arts
    from repro.serving.executor import LCCMatvec as JMatvec
    rec = tart.records[name]
    k = int(rec.kept_columns.max()) + 1
    x = np.random.default_rng(1).standard_normal((k, 5)).astype(np.float32)
    y_j = JMatvec(jart.records[name], packed=jart.packed[name],
                  interpret=True)(jnp.asarray(x))
    mv = LCCMatvec(rec, device="cpu")
    y_t = mv(torch.from_numpy(x))
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(y_t), rec.effective @ x[rec.kept_columns],
                               rtol=0, atol=1e-5)
    assert mv(torch.from_numpy(x[:, 0])).shape == (y_t.shape[0],)


def test_grouped_matvec_matches_members(arts):
    _, tart = arts
    names = ("attn.q.l1", "attn.k.l1", "attn.v.l1")  # k is weight-shared
    recs = [tart.records[n] for n in names]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((128, 3))
                         .astype(np.float32))
    ys = GroupedLCCMatvec(recs, device="cpu")([x] * 3)
    for rec, y in zip(recs, ys):
        torch.testing.assert_close(y, LCCMatvec(rec, device="cpu")(x),
                                   rtol=0, atol=1e-6)


def test_two_decode_steps_port_equals_reference_equals_dense(arts):
    jart, tart = arts
    jcfg, tcfg = jart.config, tart.config
    jex = JExecutor(jart, interpret=True, use_plans=False)
    tex = CompressedExecutor(tart, use_plans=False, device="cpu")
    b, smax = 2, 16
    js = japi.init_decode_state(jcfg, b, smax)
    ts_k = tapi.init_decode_state(tcfg, b, smax, device="cpu")
    ts_d = tapi.init_decode_state(tcfg, b, smax, device="cpu")
    toks = np.array([[3, 200], [77, 5]], np.int32)
    for t in range(2):
        tok, pos = toks[t][:, None], np.full(b, t, np.int32)
        lj, js = japi.decode(jart.params, jcfg, js, jnp.asarray(tok),
                             jnp.asarray(pos), executor=jex)
        with torch.no_grad():
            lk, ts_k = tapi.decode(tart.params, tcfg, ts_k, torch.from_numpy(tok),
                                   torch.from_numpy(pos), executor=tex)
            ld, ts_d = tapi.decode(tart.params, tcfg, ts_d, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(_np(lk), np.asarray(lj), rtol=0, atol=TOL)
        np.testing.assert_allclose(_np(lk), _np(ld), rtol=0, atol=TOL)
    for name in ("k", "v", "kpos"):
        np.testing.assert_allclose(_np(ts_k[name]), np.asarray(js[name]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(_np(ts_k[name]), _np(ts_d[name]),
                                   rtol=0, atol=TOL)
    assert tex.routed == tex.sites == set(tart.records)
    assert jex.routed == jex.sites == tex.sites
    assert tex.plan_fallbacks == {"step": "plans_disabled"}
    assert tex.step_plan(tcfg) is None and tex.conv("attn.q.l0") is None
    assert tex.n_layer_plans == 0
    assert "attn.q.l0" in tex and "nope" not in tex
    assert tex.matvec("nope") is None and tex.grouped(("attn.q.l0", "nope")) is None
    waste = tart.pipeline_stats["padding_waste"]
    assert "ffn.gate.l0+ffn.up.l0" in waste and "attn.q.l1+attn.k.l1+attn.v.l1" in waste


def test_matvecs_from_artifact_filters(arts):
    _, tart = arts
    assert set(matvecs_from_artifact(tart, include="ffn.", device="cpu")) == \
        {n for n in tart.records if n.startswith("ffn.")}
    assert set(matvecs_from_artifact(
        tart, include=lambda n: n.endswith(".l1"), device="cpu")) == \
        {n for n in tart.records if n.endswith(".l1")}


class _CountingExecutor(CompressedExecutor):
    """Counts the wrapper calls a CUDA tensor would turn into launches (the
    CPU tests run the plain versions, which never count)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.calls = {"lcc_chain_matmul": 0, "lcc_group_matmul": 0,
                      "region_prep": 0}

    def matvec(self, name):
        fn = super().matvec(name)

        def counted(x):
            self.calls["lcc_chain_matmul"] += 1
            self.calls["region_prep"] += fn.prep.launches(x)
            return fn(x)
        return counted if fn is not None else None

    def grouped(self, names):
        g = super().grouped(names)

        def counted(xs):
            self.calls["lcc_group_matmul"] += 1
            self.calls["region_prep"] += g.prep.launches(xs)
            return g(xs)
        return counted if g is not None else None


def test_launches_per_step_follow_the_site_table(arts):
    """4 launches a layer (q/k/v group, o chain, gate/up group, down chain)
    plus one region prep a group and one a site that prunes or shares."""
    _, tart = arts
    cfg = tart.config
    ex = _CountingExecutor(tart, use_plans=False, device="cpu")
    st = tapi.init_decode_state(cfg, 2, 8, device="cpu")
    with torch.no_grad():
        tapi.decode(tart.params, cfg, st, torch.tensor([[1], [2]]),
                    torch.tensor([0, 0]), executor=ex)
    n_shared = sum(r.shared is not None for r in tart.records.values())
    assert n_shared == len(SHARED)
    n_single_prep = sum(
        r.shared is not None
        or not np.array_equal(r.kept_columns, np.arange(r.kept_columns.size))
        for n, r in tart.records.items() if n.startswith(("attn.o", "ffn.down")))
    assert ex.calls == {"lcc_chain_matmul": 2 * cfg.n_layers,
                        "lcc_group_matmul": 2 * cfg.n_layers,
                        "region_prep": 2 * cfg.n_layers + n_single_prep}
    assert sum(ex.calls.values()) == 6 * cfg.n_layers + n_single_prep
    # on the CPU nothing is a launch: the engine's measured count stays 0
    # (the engine's executor takes the whole-step plan: f32 config)
    dispatch.reset_launch_count()
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=16, device="cpu")
    eng.submit([1, 2, 3], max_new=2)
    eng.step()
    assert eng.kernel_launches_per_step == 0 == dispatch.launch_count()
    assert eng.plan_stats() == {"n_layer_plans": 1, "kernel_launches_per_step": 0,
                                "fallbacks": {}}


def test_group_members_keep_their_streams_off_the_device(arts):
    """A site reached only through its group uploads nothing of its own: only
    o/down (LCCMatvec sites) and the group copies hold device streams."""
    _, tart = arts
    ex = CompressedExecutor(tart, use_plans=False, device="cpu")
    st = tapi.init_decode_state(tart.config, 1, 8, device="cpu")
    with torch.no_grad():
        tapi.decode(tart.params, tart.config, st, torch.tensor([[1]]),
                    torch.tensor([0]), executor=ex)
    uploaded = {n for n, mv in ex._matvecs.items()
                if torch.device("cpu") in mv.packed._dev}
    assert uploaded == {n for n in tart.records
                        if n.startswith(("attn.o", "ffn.down"))}


def test_seeded_artifact_kernel_route_equals_dense():
    from repro_torch.configs import get_arch, reduced_config
    cfg = reduced_config(get_arch("olmo-1b"), vocab=256)
    art = seeded_artifact(cfg, seed=5, device="cpu")
    again = seeded_artifact(cfg, seed=5, device="cpu")
    assert len(art.records) == 7 * cfg.n_layers == len(art.packed)
    prefixes = {p for p, *_ in dense_sites(cfg)}
    assert {n.rsplit(".", 1)[0] for n in art.records} == prefixes
    for name, rec in art.records.items():
        assert torch.equal(torch.from_numpy(rec.effective),
                           torch.from_numpy(again.records[name].effective))
        assert (rec.shared is not None) == name.startswith(("attn.k", "attn.o", "ffn.up"))
        k_in = {p: k for p, _, _, k in dense_sites(cfg)}[name.rsplit(".", 1)[0]]
        assert rec.kept_columns.size == k_in - 2  # pruned columns
        lens = {len(s.factors) for s in rec.decomposition.slices}
        assert lens <= {4, 5, 6} and 6 in lens
    ex = CompressedExecutor(art, device="cpu")
    st_k = tapi.init_decode_state(cfg, 2, 8, device="cpu")
    st_d = tapi.init_decode_state(cfg, 2, 8, device="cpu")
    tok, pos = torch.tensor([[9], [100]]), torch.tensor([0, 0])
    with torch.no_grad():
        lk, _ = tapi.decode(art.params, cfg, st_k, tok, pos, executor=ex)
        ld, _ = tapi.decode(art.params, cfg, st_d, tok, pos)
    assert torch.isfinite(lk).all() and float(lk.std()) > 0.05
    torch.testing.assert_close(lk, ld, rtol=0, atol=TOL)
    assert ex.routed == ex.sites
