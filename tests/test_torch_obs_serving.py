"""Telemetry wired through the port's engine and scheduler, against the
reference's on the same converted params (the reference's ``tiny_model``
of ``tests/test_obs.py``): the cases of its span-lifecycle, pool-exhaustion
and pool-stats tests plus a prefix hit, each run by both packages' engines
and schedulers with ``tracer=True``.  Every counter and gauge equals the
reference's (histograms, which hold times, by count only; the launch
gauge against the port's own run-time count); span statuses, errors,
token counts, decode marks and the non-time span meta are equal.
``metrics=False`` leaves no registry, profiler or tracer, ``metrics=None``
builds one (as the reference), and one registry can be shared by two
engines."""
import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kvpool import POOL_STAT_KEYS as J_POOL_STAT_KEYS
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.obs import MetricsRegistry, RequestTracer, StepProfiler
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvpool import POOL_STAT_KEYS
from repro_torch.serving.scheduler import Scheduler

LAUNCHES = "serving_kernel_launches_per_step"


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = jreduced(jget_arch("olmo-1b"), d_model=32, n_heads=2, n_kv_heads=2,
                    head_dim=16, d_ff=48, vocab=64, n_layers=2)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_reference(jcfg)
    return (jcfg, jp), (tcfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                                tcfg, "cpu"))


def _pair(tiny_model, **kw):
    """(reference engine and scheduler, port engine and scheduler)."""
    (jcfg, jp), (tcfg, tp) = tiny_model
    je = JEngine(jp, jcfg, **kw)
    te = ServingEngine(tp, tcfg, device="cpu", **kw)
    return (je, JScheduler(je)), (te, Scheduler(te))


def _values(reg) -> dict:
    """``{(name, labels): value}``, histograms by count, the reference's
    launch gauge under the port's name."""
    out = {}
    for name, m in reg.snapshot().items():
        name = name.replace("pallas", "kernel")
        for row in m["values"]:
            key = (name, tuple(sorted(row["labels"].items())))
            out[key] = row["count"] if m["type"] == "histogram" else row["value"]
    return out


def _kinds(reg) -> dict:
    return {name.replace("pallas", "kernel"): (m["type"], m["help"])
            for name, m in reg.snapshot().items()}


def _assert_same_metrics(jeng, teng):
    want, got = _values(jeng.metrics), _values(teng.metrics)
    launches = {k: got.pop(k) for k in list(got) if k[0] == LAUNCHES}
    want = {k: v for k, v in want.items() if k[0] != LAUNCHES}
    assert got == want
    # the reference counts launches once per traced step; the port counts
    # them at run time (none on the CPU, where the plain versions run)
    assert launches == {(LAUNCHES, (("bucket", f"{teng.n_slots}x1"),)):
                        teng.kernel_launches_per_step}
    jk, tk = _kinds(jeng.metrics), _kinds(teng.metrics)
    assert set(tk) == set(jk)
    assert {k: v for k, v in tk.items() if k != LAUNCHES} == \
        {k: v for k, v in jk.items() if k != LAUNCHES}


def _spans(tracer) -> list:
    """Each span's statuses, counts and marks; its meta but the prefill's
    wall time."""
    return [(s.sid, s.rid, s.prompt_len, s.status, s.error, s.n_tokens,
             [n for n, _ in s.marks], s.admit_t is not None,
             {k: v for k, v in s.meta.items() if k != "prefill_s"})
            for s in sorted(tracer.spans(), key=lambda s: s.sid)]


def _all_paths(eng, sched):
    """``tests/test_obs.py::test_span_lifecycle_serving_all_paths``."""
    def broken_consumer(rid, tok):
        raise RuntimeError("consumer died")

    ok = [sched.enqueue([1, 2, 3, 4], max_new=6) for _ in range(3)]
    bad = sched.enqueue([], max_new=4)  # invalid prompt -> error span
    boom = sched.enqueue([5, 6, 7], max_new=32, on_token=broken_consumer)
    sched.run()
    results = [sched.take_result(r) for r in ok + [bad, boom]]
    # explicit engine-side cancel mid-decode also closes the span
    rid = sched.enqueue([1, 2, 3], max_new=50)
    sched.step()
    eng.cancel(next(iter(sched._inflight)))
    sched.run()
    results.append(sched.take_result(rid))
    return results


def _exhaustion(eng, sched):
    """``tests/test_obs.py::test_span_pool_exhaustion_path``."""
    rid = sched.enqueue(list(range(2, 50)), max_new=40)  # 6 blocks + reserve
    sched.run()
    return [sched.take_result(rid)]


def _prefix_hit(eng, sched):
    """Three requests on one 16-token head: the later ones map its block."""
    head = list(range(3, 19))
    rids = [sched.enqueue(head + tail, max_new=5)
            for tail in ([40, 41], [42], [43, 44, 45])]
    sched.run()
    return [sched.take_result(r) for r in rids]


CASES = {
    "all_paths": (_all_paths, dict(n_slots=2, max_len=64)),
    "exhaustion": (_exhaustion, dict(n_slots=2, max_len=128, kv_block=8,
                                     kv_blocks=7, prefix_cache=False)),
    "prefix_hit": (_prefix_hit, dict(n_slots=2, max_len=64)),
    "contiguous": (_all_paths, dict(n_slots=2, max_len=64, kv_block=None)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_serving_telemetry_equals_the_reference(tiny_model, case):
    drive, kw = CASES[case]
    (je, js), (te, ts) = _pair(tiny_model, tracer=True, **kw)
    jres, tres = drive(je, js), drive(te, ts)
    assert [(r.tokens, r.error is None, r.stats.get("cancelled"))
            for r in tres] == \
        [(r.tokens, r.error is None, r.stats.get("cancelled")) for r in jres]
    assert te.pool_stats() == je.pool_stats()  # mirrored into the registry
    _assert_same_metrics(je, te)
    assert _spans(te.tracer) == _spans(je.tracer)
    assert te.tracer.open_count == 0
    summ = te.tracer.summary()
    assert summ["by_status"] == je.tracer.summary()["by_status"]
    m = te.metrics
    assert m.get("serving_decode_steps_total").value == te.step_dispatches \
        == te.profiler.total_steps
    assert m.get("sched_pending").value == m.get("sched_inflight").value == 0
    if case == "exhaustion":
        assert m.get("serving_pool_exhausted_total").value == 1
    if case == "prefix_hit":
        assert te.pool_stats()["prefix_hit_tokens"] == 32
        assert [s.meta["cached_tokens"] for s in te.tracer.completed] == \
            [0, 16, 16]


def test_pool_stats_unified_key_set(tiny_model):
    (jcfg, jp), (tcfg, tp) = tiny_model
    assert POOL_STAT_KEYS == J_POOL_STAT_KEYS
    for kv_block in (16, None):
        je = JEngine(jp, jcfg, n_slots=1, max_len=32, kv_block=kv_block)
        te = ServingEngine(tp, tcfg, n_slots=1, max_len=32, kv_block=kv_block,
                           device="cpu")
        ps = te.pool_stats()
        assert tuple(ps) == POOL_STAT_KEYS and ps == je.pool_stats()
        assert (ps["n_blocks"] > 0) == (kv_block is not None)
        assert _values(te.metrics) == _values(je.metrics)


def test_metrics_false_none_and_a_shared_registry(tiny_model):
    (jcfg, jp), (tcfg, tp) = tiny_model
    off = ServingEngine(tp, tcfg, n_slots=1, max_len=32, metrics=False,
                        device="cpu")
    assert off.metrics is None and off.profiler is None and off.tracer is None
    rid = off.submit([1, 2, 3], max_new=4)
    while off.active.any():
        off.step()
    assert off.results[rid].finished  # plain serving path is untouched
    # metrics=None builds a registry per engine, as the reference
    a = ServingEngine(tp, tcfg, n_slots=1, max_len=32, device="cpu")
    b = ServingEngine(tp, tcfg, n_slots=1, max_len=32, device="cpu")
    assert isinstance(a.metrics, MetricsRegistry) and a.metrics is not b.metrics
    assert isinstance(a.profiler, StepProfiler) and a.tracer is None
    assert a.profiler.fence_every == 32  # the reference's default
    # one registry, two engines: their counters add up, on both sides
    regs = []
    for reg, eng_cls, cfg, p, kw in (
            (None, JEngine, jcfg, jp, {}),
            (MetricsRegistry(), ServingEngine, tcfg, tp, {"device": "cpu"})):
        if reg is None:
            from repro.obs import MetricsRegistry as JRegistry
            reg = JRegistry()
        tracer = (RequestTracer(metrics=reg) if eng_cls is ServingEngine
                  else True)
        e1 = eng_cls(p, cfg, n_slots=1, max_len=32, metrics=reg, **kw)
        e2 = eng_cls(p, cfg, n_slots=2, max_len=32, metrics=reg,
                     tracer=tracer, **kw)
        assert e1.metrics is reg and e2.metrics is reg
        e1.generate([[1, 2, 3]], max_new_tokens=3)
        e2.generate([[4, 5], [6, 7, 8]], max_new_tokens=2)
        regs.append(reg)
    assert _values(regs[1])[("serving_tokens_total", ())] == 3 + 4
    want = {k: v for k, v in _values(regs[0]).items() if k[0] != LAUNCHES}
    got = {k: v for k, v in _values(regs[1]).items() if k[0] != LAUNCHES}
    assert got == want
