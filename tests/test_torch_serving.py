"""The slice as a whole: ``Scheduler`` over ``ServingEngine(artifact=...)`` on
the CPU (plain kernel versions), against the JAX engine on the same artifact
and prompts — greedy token streams must be identical."""
import json

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.convert import artifact_from_reference
from repro_torch.data.synthetic import MarkovLM
from repro_torch.serving.engine import GenerationResult, ServingEngine
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.scheduler import Scheduler


@pytest.fixture(scope="module")
def arts():
    cfg = jreduced(jget_arch("olmo-1b"), vocab=256)
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    art = japi.compress_model(
        params, cfg, jcore.CompressionConfig(algorithm="fp", max_share_rel_err=0.06))
    return art, artifact_from_reference(art, "cpu")


def _prompts(n, vocab=256):
    lm = MarkovLM(vocab=vocab, k=8, seed=0)
    return [lm.sample(1, 8, seed=100 + i)[0, :8].tolist() for i in range(n)]


def test_markov_prompts_are_the_reference_prompts():
    jl, tl = JMarkovLM(vocab=256, k=8, seed=0), MarkovLM(vocab=256, k=8, seed=0)
    np.testing.assert_array_equal(jl.sample(2, 9, seed=5), tl.sample(2, 9, seed=5))
    assert jl.entropy == tl.entropy
    b = tl.batch(2, 4, seed=1)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def _run(engine_cls, sched_cls, art, prompts, max_new, **kw):
    eng = engine_cls(artifact=art, n_slots=2, max_len=32, kv_block=4, **kw)
    sched = sched_cls(eng)
    rids = [sched.enqueue(p, max_new=max_new, priority=len(prompts) - i)
            for i, p in enumerate(prompts)]
    sched.run()
    return eng, sched, [sched.take_result(r) for r in rids]


def test_greedy_token_streams_identical_to_the_reference_engine(arts):
    jart, tart = arts
    prompts = _prompts(3)
    # both engines at their default, the prefix cache on
    jeng, _, jres = _run(JEngine, JScheduler, jart, prompts, 6, metrics=False)
    eng, sched, tres = _run(ServingEngine, Scheduler, tart, prompts, 6,
                            device="cpu")
    for jr, tr in zip(jres, tres):
        assert tr.finished and tr.error is None
        assert tr.prompt_len == jr.prompt_len == 8
        assert tr.tokens == jr.tokens and len(tr.tokens) == 14
    # 3 requests on 2 slots: one joined the live batch; blocks grew mid-decode
    assert sched.admitted_while_running >= 1
    assert sum(r.stats.get("blocks_grown", 0) for r in tres) >= 1
    assert tres[0].stats["prefill_kind"] == "paged"
    assert eng.executor.routed == eng.executor.sites
    assert eng.pool.in_use_blocks == 0 and not eng.active.any()
    ps = eng.pool_stats()
    # every block is back: free, or kept by the prefix cache for a later hit
    assert ps["peak_in_use_blocks"] > 0 and ps["cached_blocks"] > 0
    assert ps["free_blocks"] + ps["cached_blocks"] == ps["n_blocks"]
    assert ps == jeng.pool_stats()


def test_routes_agree_kernel_dense_contiguous(arts):
    _, tart = arts
    prompts = _prompts(3)
    want = [r.tokens for r in _run(ServingEngine, Scheduler, tart, prompts, 5,
                                   device="cpu")[2]]
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=32, kv_block=None,
                        use_kernel=False, device="cpu")
    assert eng.executor is None and eng.pool is None
    assert eng.pool_stats()["n_blocks"] == 0
    got = [r.tokens for r in eng.generate(prompts, max_new_tokens=5)]
    assert got == want


def test_params_and_cfg_engine_without_artifact(arts):
    _, tart = arts
    eng = ServingEngine(tart.params, tart.config, n_slots=1, max_len=16,
                        device="cpu")
    (r,) = eng.generate([[5, 6, 7]], max_new_tokens=3)
    assert r.finished and len(r.tokens) == 6 and eng.executor is None
    with pytest.raises(ValueError):
        ServingEngine(device="cpu")


def test_admission_validation_and_errors(arts):
    _, tart = arts
    eng = ServingEngine(artifact=tart, n_slots=1, max_len=16, kv_block=4,
                        device="cpu")
    sched = Scheduler(eng)
    bad_empty = sched.enqueue([])
    bad_long = sched.enqueue(list(range(17)))
    ok = sched.enqueue([1, 2, 3], max_new=2)
    assert sched.pending == 1
    sched.run()
    assert "empty prompt" in sched.results[bad_empty].error
    assert "exceeds" in sched.results[bad_long].error
    assert sched.results[ok].error is None and len(sched.results[ok].tokens) == 5
    with pytest.raises(KeyError):
        sched.take_result(999)
    with pytest.raises(ValueError):
        eng.submit([])
    eng.submit([1, 2], max_new=4)
    with pytest.raises(RuntimeError):
        eng.submit([3, 4])  # no free slot
    assert not eng.can_admit([3, 4])
    assert eng.cancel(eng.slot_req[0]) and not eng.cancel(12345)
    assert not eng.active.any() and eng.pool.in_use_blocks == 0


def test_pool_exhaustion_becomes_an_errored_result(arts):
    _, tart = arts
    # 3 usable blocks of 4 tokens: two 4-token prompts fit (1 block + 1
    # reserve each would need 4) -> the second waits; growth then exhausts
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=32, kv_block=4,
                        kv_blocks=3, device="cpu")
    assert eng.pool.n_blocks >= 3
    eng.pool._free = eng.pool._free[-3:]  # leave exactly 3 free blocks
    eng.pool.n_blocks = 3
    sched = Scheduler(eng)
    a = sched.enqueue([1, 2, 3, 4], max_new=20)
    b = sched.enqueue([5, 6, 7, 8], max_new=20)
    sched.run()
    ra, rb = sched.results[a], sched.results[b]
    assert ra.finished and rb.finished
    errs = [r.error for r in (ra, rb) if r.error]
    assert errs and all("exhausted" in e for e in errs)
    assert any(r.stats.get("exhausted") for r in (ra, rb))
    assert sched.mem_stalls >= 1  # b waited for blocks, not for a slot
    assert eng.pool.in_use_blocks == 0
    never = sched.enqueue(list(range(1, 14)))  # 4 blocks + reserve > pool
    assert "can never fit" in sched.results[never].error


def test_streaming_callbacks_and_isolation(arts):
    _, tart = arts
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=32, device="cpu")
    sched = Scheduler(eng)
    seen = []

    def boom(rid, tok):
        raise RuntimeError("consumer died")

    good = sched.enqueue([1, 2, 3], max_new=4,
                         on_token=lambda rid, tok: seen.append((rid, tok)))
    bad = sched.enqueue([4, 5, 6], max_new=4, on_token=boom)
    sched.run()
    rg, rb = sched.results[good], sched.results[bad]
    assert [t for _, t in seen] == rg.tokens[3:] and len(seen) == 4
    assert rg.error is None
    assert "streaming callback failed" in rb.error and rb.stats["cancelled"]
    assert sched.inflight == 0


def test_budgets_eos_and_max_len(arts):
    _, tart = arts
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=12, device="cpu")
    res = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12, 13]],
                       max_new_tokens=50)
    assert [len(r.tokens) for r in res] == [12, 12]  # capped by max_len
    zero = ServingEngine(artifact=tart, n_slots=1, max_len=12, device="cpu")
    (r,) = zero.generate([[1, 2, 3]], max_new_tokens=0)
    assert r.finished and r.tokens == [1, 2, 3]
    first = res[0].tokens[3]
    eos = ServingEngine(artifact=tart, n_slots=1, max_len=12, eos_id=first,
                        device="cpu")
    (r,) = eos.generate([[1, 2, 3]], max_new_tokens=5)
    assert r.tokens == [1, 2, 3, first]


def test_sampling_is_independent_of_slot_placement(arts):
    """Temperature draws are keyed by (seed, request id, token count): the
    same request gives the same stream alone or beside others, in any slot."""
    _, tart = arts
    p = [9, 8, 7, 6]

    def stream(n_slots, others_first):
        eng = ServingEngine(artifact=tart, n_slots=n_slots, max_len=32,
                            temperature=0.9, seed=3, device="cpu")
        if others_first:  # occupy slot 0 with an unrelated engine-level request
            eng._next_req = 5
            eng.submit([1, 2, 3], max_new=2)
            eng._next_req = 0
        rid = eng.submit(p, max_new=6)
        assert rid == 0
        res = eng.results[rid]
        while not res.finished:
            eng.step()
        return res.tokens

    alone = stream(1, False)
    beside = stream(3, True)
    assert alone == beside and len(alone) == 10
    other_seed = ServingEngine(artifact=tart, n_slots=1, max_len=32,
                               temperature=0.9, seed=4, device="cpu")
    (r,) = other_seed.generate([p], max_new_tokens=6)
    assert r.tokens != alone
    greedy = ServingEngine(artifact=tart, n_slots=1, max_len=32, device="cpu")
    (g,) = greedy.generate([p], max_new_tokens=6, temperature=0.9)
    assert len(g.tokens) == 10


ENGINE_OPTIONS = [("mesh", "mesh"), ("metrics", None), ("tracer", None)]


def _one_rank_mesh_serves(tart, tmp_path):
    """``mesh=`` over a 1 x 1 mesh of this process's one-rank gloo group:
    the unsharded engine's tokens; a mesh on another device type is
    refused, and so is a mesh whose process group is gone."""
    from repro_torch.distributed import device_mesh

    prompts = _prompts(2)
    want = [r.tokens for r in ServingEngine(
        artifact=tart, n_slots=2, max_len=32, device="cpu").generate(
            prompts, max_new_tokens=3)]
    device_mesh.join(0, 1, backend="gloo",
                     init_method=f"file://{tmp_path / 'store'}")
    try:
        mesh = device_mesh.make_mesh((1, 1), ("data", "model"))
        eng = ServingEngine(artifact=tart, n_slots=2, max_len=32,
                            device="cpu", mesh=mesh)
        got = [r.tokens for r in eng.generate(prompts, max_new_tokens=3)]
        assert got == want
        st = eng.plan_stats()
        assert st["n_layer_plans"] == 1 and st["fallbacks"] == {}
        assert st["mesh"]["fallbacks"] == {}
        with pytest.raises(ValueError, match="engine was given"):
            ServingEngine(artifact=tart, device="cuda", mesh=mesh)
    finally:
        device_mesh.leave()
    with pytest.raises(RuntimeError, match="process group is not up"):
        ServingEngine(artifact=tart, device="cpu", mesh=mesh)


@pytest.mark.parametrize("name,msg", ENGINE_OPTIONS,
                         ids=["kw0-mesh", "kw1-telemetry", "kw2-telemetry"])
def test_refused_options_raise(arts, name, msg, tmp_path):
    """``mesh=`` serves over a mesh (here one rank's, bit for bit the
    unsharded engine; ``tests/test_torch_sharded_serving.py`` at 2 ranks);
    the telemetry options work as in the reference: a ``MetricsRegistry``
    passed as ``metrics=`` is the engine's (shared, not copied),
    ``tracer=True`` adds a tracer on that registry."""
    from repro_torch.obs import MetricsRegistry, RequestTracer

    _, tart = arts
    if msg is not None:
        _one_rank_mesh_serves(tart, tmp_path)
        return
    reg = MetricsRegistry()
    kw = {"metrics": reg} if name == "metrics" else {"tracer": True}
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=32, device="cpu",
                        **kw)
    res = eng.generate(_prompts(2), max_new_tokens=3)
    assert all(r.error is None and len(r.tokens) == 11 for r in res)
    if name == "metrics":
        assert eng.metrics is reg and eng.tracer is None
    else:
        assert isinstance(eng.tracer, RequestTracer)
        assert [s.status for s in eng.tracer.spans()] == ["ok", "ok"]
    assert eng.metrics.get("serving_tokens_total").value == 6
    assert eng.metrics.get("serving_decode_steps_total").value == \
        eng.step_dispatches == eng.profiler.total_steps


REFERENCE_OPTIONS = [
    ("launcher", ["--dp", "2", "--compress", "--kernel"], "mesh"),
    ("launcher", ["--tp", "2"], "mesh"),
    ("launcher", ["--dp", "2", "--tp", "2", "--kernel"], "mesh"),
    ("launcher", ["--metrics-out", "m.json"], None),
    ("launcher", ["--trace-out", "t.jsonl"], None),
    ("launcher", ["--metrics-port", "0"], None),
    ("engine", dict(fence_every=32), None),
]


@pytest.mark.parametrize("where,option,entry", REFERENCE_OPTIONS,
                         ids=[str(o[1]) for o in REFERENCE_OPTIONS])
def test_reference_options_are_refused_by_name(arts, where, option, entry,
                                               tmp_path, monkeypatch, capsys):
    """The reference serve launcher's flags and the engine's
    ``fence_every=``: those of a slice still to come are refused naming it
    (argparse does not reject them as unknown); the telemetry ones work;
    ``--dp``/``--tp`` serve over that many gloo ranks, rank 0 printing the
    unsharded launcher's request tokens (with ``--compress`` every rank
    compresses the same parameters)."""
    if where == "engine":
        _, tart = arts
        eng = ServingEngine(artifact=tart, device="cpu", **option)
        assert eng.profiler.fence_every == option["fence_every"]
        return
    from repro_torch.launch import serve

    argv = ["--reduced", "--device", "cpu", "--requests", "2", "--max-new",
            "3", *option]
    if entry == "mesh":
        serve.main(argv)
        meshed = capsys.readouterr().out
        serve.main(argv[:7] + [o for o in option
                                if o in ("--kernel", "--compress")])
        plain = capsys.readouterr().out

        def reqs(out):
            return [ln for ln in out.splitlines() if ln.startswith("req")]

        assert reqs(meshed) == reqs(plain) and len(reqs(plain)) == 2
        dp = option[option.index("--dp") + 1] if "--dp" in option else "1"
        tp = option[option.index("--tp") + 1] if "--tp" in option else "1"
        assert f", mesh {dp}x{tp})" in meshed
        return
    if entry is not None:
        with pytest.raises(SystemExit, match=f"{option[0]} .*{entry}"):
            serve.main(argv)
        return
    monkeypatch.chdir(tmp_path)
    serve.main(argv)
    out = capsys.readouterr().out
    assert "telemetry summary" in out and "{'ok': 2} (0 unclosed)" in out
    if option[0] == "--metrics-out":
        metrics = json.loads((tmp_path / "m.json").read_text())["metrics"]
        assert metrics["serving_tokens_total"]["values"][0]["value"] == 6
    elif option[0] == "--trace-out":
        spans = (tmp_path / "t.jsonl").read_text().splitlines()
        assert [json.loads(l)["status"] for l in spans] == ["ok", "ok"]
    else:
        assert "metrics: http://127.0.0.1:" in out


def test_launcher_compressor_output_is_the_reference_launchers(arts):
    """``--compress --kernel``'s artifact: the compressor over the
    reference launcher's parameters (``init_params(PRNGKey(0))``, converted)
    under its config (FP, ``max_share_rel_err=0.06``, packed) gives the
    reference launcher's records and packed buffers bit for bit."""
    from repro.configs import get_arch as jga
    from repro_torch.convert import config_from_reference, params_from_numpy
    from repro_torch.launch import serve
    from test_torch_compress import assert_dense_equal, report_rows

    jart, _ = arts
    jcfg = jreduced(jga("olmo-1b"), vocab=256)
    tcfg = config_from_reference(jcfg)
    tparams = params_from_numpy(jax.tree.map(
        np.asarray, japi.init_params(jax.random.PRNGKey(0), jcfg)), tcfg, "cpu")
    tart = serve.compressed_artifact(tparams, tcfg, kernel=True)
    assert list(tart.records) == list(jart.records)
    for name, jr in jart.records.items():
        assert_dense_equal(jr, tart.records[name])
        jp, tp = jart.packed[name], tart.packed[name]
        for f in ("idx", "exp", "sign"):
            assert np.array_equal(np.asarray(getattr(jp, f)), getattr(tp, f))
        assert tuple(map(tuple, jp.col_slices)) == tp.col_slices
    assert report_rows(tart.report) == report_rows(jart.report)
    assert tart.compression.algorithm == "fp"


def test_launcher_compress_kernel_serves_the_compressed_artifact(tmp_path,
                                                                 capsys):
    """``--reduced --device cpu --compress --kernel`` with telemetry: the
    report table printed, every site routed through the layer plan, the
    live roofline there (the artifact carries its cost report), 2 spans
    ``ok``; on the CPU the wrappers run their plain versions, which count
    no launch."""
    from repro_torch.launch import serve

    m, t = tmp_path / "m.json", tmp_path / "t.jsonl"
    eng = serve.main(["--reduced", "--device", "cpu", "--compress", "--kernel",
                      "--requests", "2", "--max-new", "8", "--slots", "2",
                      "--metrics-out", str(m), "--trace-out", str(t)])
    out = capsys.readouterr().out
    art = eng.artifact
    assert out.startswith(art.report.table())
    assert "compressed artifact: 14 sites, 2 layers" in out
    assert "routed 14/14 sites through fused kernels, 1 layer plan(s)" in out
    assert eng.executor.routed == eng.executor.sites
    assert all(p.col_slices for p in art.packed.values())
    payload = json.loads(m.read_text())
    roof = payload["live_roofline"]
    assert roof and roof["sites"] and roof["achieved_adds_per_s"] > 0
    assert roof["total_lcc_adds"] == art.report.total_stage("lcc")
    metrics = payload["metrics"]
    assert metrics["serving_layer_plans"]["values"][0]["value"] == 1
    assert metrics["serving_requests_total"]["values"] == [
        {"labels": {"status": "ok"}, "value": 2}]
    assert eng.kernel_launches_per_step == 0
    spans = [json.loads(line) for line in t.read_text().splitlines()]
    assert [s["status"] for s in spans] == ["ok", "ok"]


def test_launcher_compress_without_kernel_serves_the_fs_artifact(capsys):
    """``--compress`` alone: FS, no packed buffers, served on the
    dense-effective weights (no executor), as the reference launcher."""
    from repro_torch.launch import serve

    eng = serve.main(["--reduced", "--device", "cpu", "--compress",
                      "--layers", "1", "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    art = eng.artifact
    assert "compressed artifact: 7 sites, 1 layers" in out
    assert art.compression.algorithm == "fs" and not art.packed
    assert eng.executor is None
    assert "live roofline: " in out  # the FS artifact carries its report too
    assert len([ln for ln in out.splitlines() if ln.startswith("req")]) == 2
    assert "{'ok': 2} (0 unclosed)" in out


def test_windowed_engine_serves_through_the_ring(arts):
    from dataclasses import replace
    _, tart = arts
    cfg = replace(tart.config, attn_window=8)
    for kv_block in (None, 4):
        eng = ServingEngine(tart.params, cfg, n_slots=2, max_len=32,
                            kv_block=kv_block, device="cpu")
        res = eng.generate([list(range(1, 13)), [3, 4]], max_new_tokens=10)
        assert all(r.finished and r.error is None for r in res)
        assert [len(r.tokens) for r in res] == [22, 12]
    # both layouts hold the same ring, so they agree token for token
    a = ServingEngine(tart.params, cfg, n_slots=1, max_len=32, kv_block=None,
                      device="cpu").generate([list(range(1, 13))], 10)
    b = ServingEngine(tart.params, cfg, n_slots=1, max_len=32, kv_block=4,
                      device="cpu").generate([list(range(1, 13))], 10)
    assert a[0].tokens == b[0].tokens


def test_kvpool_is_the_reference_allocator():
    from repro.serving.kvpool import KVPool as JPool
    for cls in (JPool, KVPool):
        pool = cls(n_slots=2, n_blocks=6, block_size=4, view_blocks=4,
                   prefix_cache=False)
        plan = pool.admit(0, list(range(6)))
        assert plan.table.tolist() == [1, 2, 3, 0] and plan.cached_tokens == 0
        assert pool.append_block(0) == 4 and pool.append_block(0) is None
        assert pool.admit(1, list(range(9))) is None  # 3 + reserve > 2 free
        pool.release(0)
        assert pool.in_use_blocks == 0 and pool.free_blocks == 6
    assert isinstance(GenerationResult([1], 1, False).stats, dict)
