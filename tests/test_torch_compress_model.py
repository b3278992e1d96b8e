"""The slice as a whole on the CPU: ``models.api.compress_model`` on the
reference launcher's quickstart olmo-1b (vocab 64, 2 layers, d 32, d_ff 48,
2 heads, head_dim 16), params converted from the JAX package's, against the
reference's ``compress_model`` — records, packed buffers, effective params,
the cost report and ``compressed_adds`` bitwise; the port's engine decoding
that artifact (plain kernel versions) against the JAX engine and executor on
the reference's artifact: the same greedy tokens, logits within 1e-4; and
``mlp_forward_compressed`` at 48-64-10 within 1e-5 of the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import flops as jflops
from repro.models import mlp as jmlp
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.executor import CompressedExecutor as JExecutor
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.convert import (config_from_reference, mlp_params_from_numpy,
                                 params_from_numpy)
from repro_torch.core import CompressionConfig
from repro_torch.core.lcc import lcc_decompose
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import compress_adapters as tca
from repro_torch.models import flops as tflops
from repro_torch.models import mlp as tmlp
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import CompressedExecutor
from repro_torch.serving.scheduler import Scheduler

from test_torch_compress import assert_dense_equal, report_rows

TOL = 1e-4
MLP_TOL = 1e-5
QUICKSTART = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
                  n_kv_heads=2, head_dim=16)
CONFIGS = {"default": None,  # the compress launcher's: fp, sharing bounded
           "shared": dict(algorithm="fp", max_share_rel_err=None),
           "keep_in_place": dict(algorithm="fp", prune_tol=-1e-6,
                                 weight_sharing=False)}


def _leaves(t, pre=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{pre}/{k}")
    else:
        yield pre, t


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    t = t.detach()
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


@pytest.fixture(scope="module", params=list(CONFIGS))
def arts(request):
    jcfg = jreduced(jget_arch("olmo-1b"), **QUICKSTART)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_reference(jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    kw = CONFIGS[request.param]
    jart = japi.compress_model(jp, jcfg, None if kw is None
                               else jcore.CompressionConfig(**kw))
    tart = tapi.compress_model(tp, tcfg, None if kw is None
                               else CompressionConfig(**kw))
    return jcfg, jart, tcfg, tart, request.param


def test_artifact_bitwise_the_reference(arts):
    jcfg, jart, tcfg, tart, _ = arts
    assert list(tart.records) == list(jart.records)
    for name, jr in jart.records.items():
        assert_dense_equal(jr, tart.records[name])
        jp, tp = jart.packed[name], tart.packed[name]
        for f in ("idx", "exp", "sign"):
            a, b = np.asarray(getattr(jp, f)), getattr(tp, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
        assert tuple(map(tuple, jp.col_slices)) == tp.col_slices
        assert tuple(jp.chain_lengths) == tp.chain_lengths
        assert (jp.in_dim, jp.out_dim, jp.d_pad, jp.first_width) == \
            (tp.in_dim, tp.out_dim, tp.d_pad, tp.first_width)
        assert len(jp.dense) == len(tp.dense)
    jl, tl = dict(_leaves(jart.params)), dict(_leaves(tart.params))
    assert sorted(jl) == sorted(tl)
    for k, v in jl.items():
        assert np.array_equal(_bits(v), _tbits(tl[k])), k
        assert tl[k].device.type == "cpu"
    assert report_rows(jart.report) == report_rows(tart.report)
    assert tart.report.table() == jart.report.table()
    assert tflops.compressed_adds(tcfg, tart) == jflops.compressed_adds(jcfg, jart)
    assert {n: vars(c) for n, c in tart.unit_configs.items()} == \
        {n: vars(c) for n, c in jart.unit_configs.items()}
    for k in ("units", "jobs", "dead_groups", "skipped_jobs", "shrunk_jobs",
              "cache_hits", "cache_misses"):
        assert tart.pipeline_stats[k] == jart.pipeline_stats[k], k
    assert tart.family == "dense" and tart.config is tcfg


def test_units_and_rebind_bitwise(arts):
    jcfg, jart, tcfg, tart, _ = arts
    tp = params_from_numpy(jax.tree.map(np.asarray, jart.params), tcfg, "cpu")
    ju = japi.compressible_units(jart.params, jcfg)
    tu = tapi.compressible_units(tp, tcfg)
    assert [u.name for u in ju] == [u.name for u in tu]
    for a, b in zip(ju, tu):
        assert a.weight.tobytes() == b.weight.tobytes()
    eff = np.random.default_rng(0).standard_normal(ju[3].weight.shape)
    jnew = japi.rebind(jart.params, jcfg, ju[3].name, eff)
    tnew = dict(_leaves(tapi.rebind(tp, tcfg, tu[3].name, eff)))
    for k, v in _leaves(jnew):
        assert np.array_equal(_bits(v), _tbits(tnew[k])), k
    with pytest.raises(KeyError):
        tapi.rebind(tp, tcfg, "nope", eff)


def test_bf16_leaves_read_and_written_as_the_reference():
    """A bf16 leaf reaches the compressor through float32 (exactly) and the
    effective map returns to bf16 as ``jnp.asarray(x, bfloat16)`` rounds."""
    jcfg = dataclasses.replace(jreduced(jget_arch("olmo-1b"), **QUICKSTART),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = japi.init_params(jax.random.PRNGKey(1), jcfg)
    tcfg = config_from_reference(jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    inc = "ffn."
    jart = japi.compress_model(jp, jcfg, include=inc)
    tart = tapi.compress_model(tp, tcfg, include=inc)
    for name, jr in jart.records.items():
        assert_dense_equal(jr, tart.records[name])
    tl, t0 = dict(_leaves(tart.params)), dict(_leaves(tp))
    for k, v in _leaves(jart.params):
        assert np.array_equal(_bits(v), _tbits(tl[k])), k
        assert tl[k].dtype == t0[k].dtype


def _prompts(n, vocab=64):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, 6).tolist() for _ in range(n)]


def _serve(engine_cls, sched_cls, art, prompts, **kw):
    eng = engine_cls(artifact=art, n_slots=2, max_len=24, kv_block=4, **kw)
    sched = sched_cls(eng)
    rids = [sched.enqueue(p, max_new=5) for p in prompts]
    sched.run()
    return eng, [sched.take_result(r) for r in rids]


def test_engine_decodes_as_the_reference(arts, monkeypatch):
    jcfg, jart, tcfg, tart, name = arts
    # with sharing the layers' slice counts differ, and the reference's plan
    # route refuses such stages (its segment path captures constants; ROADMAP
    # Queue C): the reference runs its per-region route there
    ref_plans = name != "shared"
    if not ref_plans:
        monkeypatch.setattr(JEngine, "_build_executor", staticmethod(
            lambda art, interpret, mesh=None: JExecutor(
                art, interpret=interpret, use_plans=False)))
    prompts = _prompts(3)
    _, jres = _serve(JEngine, JScheduler, jart, prompts, prefix_cache=False,
                     metrics=False)
    eng, tres = _serve(ServingEngine, Scheduler, tart, prompts, device="cpu")
    for jr, tr in zip(jres, tres):
        assert tr.finished and tr.error is None and tr.tokens == jr.tokens
    assert eng.executor.routed == eng.executor.sites == set(tart.records)
    # one step's logits: the JAX executor on its artifact vs the port's on its own
    b = 2
    tok = np.array([[3], [41]], np.int32)
    pos = np.zeros(b, np.int32)
    js = japi.init_decode_state(jcfg, b, 8)
    lj, _ = japi.decode(jart.params, jcfg, js, jnp.asarray(tok), jnp.asarray(pos),
                        executor=JExecutor(jart, interpret=True,
                                           use_plans=ref_plans))
    for use_plans in (True, False):
        ts = tapi.init_decode_state(tcfg, b, 8, device="cpu")
        with torch.no_grad():
            lt, _ = tapi.decode(tart.params, tcfg, ts, torch.from_numpy(tok),
                                torch.from_numpy(pos),
                                executor=CompressedExecutor(tart, use_plans=use_plans,
                                                            device="cpu"))
        np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj), rtol=0, atol=TOL)


def _mlp_params(in_dim=48, hidden=64, classes=10, dead=()):
    jp = jmlp.init_mlp(jax.random.PRNGKey(0), in_dim=in_dim, hidden=hidden,
                       classes=classes)
    np_tree = jax.tree.map(np.array, jp)
    np_tree["fc1"]["w"][:, list(dead)] = 0.0  # prox-dead input groups
    jp = jax.tree.map(jnp.asarray, np_tree)
    return jp, mlp_params_from_numpy(np_tree, "cpu")


def test_mlp_forward_compressed_matches_the_reference():
    jp, tp = _mlp_params()
    w = np.asarray(jp["fc1"]["w"], np.float64)
    jpk = jops.pack_decomposition(jcore.lcc_decompose(w, algorithm="fp",
                                                      target_snr_db=50.0))
    tpk = tops.pack_decomposition(lcc_decompose(w, algorithm="fp",
                                                target_snr_db=50.0))
    for f in ("idx", "exp", "sign"):
        assert np.array_equal(np.asarray(getattr(jpk, f)), getattr(tpk, f))
    x = np.random.default_rng(26).standard_normal((5, 48)).astype(np.float32)
    want = np.asarray(jmlp.mlp_forward_compressed(jp, jpk, jnp.asarray(x),
                                                  interpret=True))
    got = tmlp.mlp_forward_compressed(tp, tpk, torch.from_numpy(x))
    assert tuple(got.shape) == (5, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MLP_TOL)
    dense = tmlp.mlp_forward(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.argmax(got.numpy(), -1), np.argmax(dense, -1))


def test_mlp_compressed_artifact_serves_fc1():
    """The card's configuration at 48-64-10: prox-dead columns kept in place,
    no sharing, so fc1's decomposition takes all 48 inputs; skipped and
    shrunk slice jobs occur; the packed fc1 forward equals the reference's
    within 1e-5 and the dense-effective forward within 1e-4."""
    dead = list(range(0, 8)) + [11, 13, 30]
    jp, tp = _mlp_params(dead=dead)
    kw = dict(algorithm="fp", prune_tol=-1e-6, weight_sharing=False)
    jart = japi.compress_model(jp, jmlp.MLPConfig(48, 64, 10),
                               jcore.CompressionConfig(**kw))
    tart = tapi.compress_model(tp, tmlp.MLPConfig(48, 64, 10), CompressionConfig(**kw))
    assert tart.pipeline_stats["skipped_jobs"] >= 1
    assert tart.pipeline_stats["shrunk_jobs"] >= 1
    assert tart.pipeline_stats == {**jart.pipeline_stats,
                                   "wall_s": tart.pipeline_stats["wall_s"],
                                   "units_per_s": tart.pipeline_stats["units_per_s"]}
    for name, jr in jart.records.items():
        assert_dense_equal(jr, tart.records[name])
    assert tart.packed["fc1"].in_dim == 48
    x = np.random.default_rng(3).standard_normal((7, 48)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, jart.params)
    want = np.asarray(jmlp.mlp_forward_compressed(jparams, jart.packed["fc1"],
                                                  jnp.asarray(x), interpret=True))
    got = tmlp.mlp_forward_compressed(tart.params, tart.packed["fc1"],
                                      torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_TOL)
    eff = tmlp.mlp_forward(tart.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, eff, rtol=0, atol=TOL)
    assert tca.sites_for(tart.params, tmlp.MLPConfig())[0].name == "fc1"
