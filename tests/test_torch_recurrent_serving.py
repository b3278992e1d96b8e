"""Serving the recurrent families on the port against the JAX package's
engine, at reduced widths (rwkv6-1.6b: d 64, 2 layers; zamba2-7b: d 64,
period 2 over 5 layers, so two insertions of the shared block and a tail
layer), parameters from the reference's ``init_params`` through
``convert.params_from_numpy``.

* the prefill kind: bulk only where the state holds ``k`` or ``c_kv`` (the
  reference's rule), so both families prefill token by token on a default
  engine (``bulk_prefill=True``, ``kv_block=16``), contiguous, no pool;
  the state's leaves the reference's, the tail-extend prefill refused,
  a slot's reset zeroing its recurrent leaves alone;
* slot isolation (the counterpart of the reference's
  ``test_recurrent_state_slot_isolation``): a reused slot (one slot, three
  requests in turn) and concurrent slots give each request a fresh
  engine's tokens;
* greedy tokens equal to the reference engine's on the same parameters,
  dense and on a compressed artifact (the port's per-region route, the
  plain K1/K2/K3, against the reference engine's dense-effective weights);
* the plan refusal ``family:ssm`` / ``family:hybrid`` in ``plan_stats()``
  and counted once in ``serving_plan_fallbacks_total{reason=...}`` (the
  counterpart of the reference's ``test_engine_plan_stats_and_fallback_metric``)."""
import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import SSMSpec as JSSMSpec
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine

from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.core import CompressionConfig
from repro_torch.models import api as tapi
from repro_torch.serving.engine import ServingEngine

SMALL = {"rwkv6-1.6b": dict(d_model=64, head_dim=16, d_ff=96, vocab=64),
         "zamba2-7b": dict(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                           head_dim=16, d_ff=96, vocab=64,
                           ssm=JSSMSpec(d_inner=64, d_state=16, head_dim=16,
                                        d_conv=4))}
PROMPTS = [[5, 9, 2, 7], [1, 33, 8], [60, 4, 4, 12, 3]]


@pytest.fixture(scope="module", params=tuple(SMALL))
def model(request):
    jcfg = jreduced(jget_arch(request.param), **SMALL[request.param])
    jp = japi.init_params(jax.random.PRNGKey(1), jcfg)
    tcfg = config_from_reference(jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.array, jp),
                                             tcfg, "cpu")


def _engine(tp, tcfg, n_slots, **kw):
    return ServingEngine(tp, tcfg, n_slots=n_slots, max_len=32, device="cpu",
                         **kw)


def test_recurrent_state_slot_isolation(model):
    _, _, tcfg, tp = model
    seq = _engine(tp, tcfg, 1)
    r_seq = seq.generate(PROMPTS, max_new_tokens=4)  # slot 0 reused
    par = _engine(tp, tcfg, 2)
    r_par = par.generate(PROMPTS, max_new_tokens=4)  # concurrent slots
    assert seq.pool is None and par.pool is None  # contiguous state
    for i, p in enumerate(PROMPTS):
        fresh = _engine(tp, tcfg, 1).generate([p], max_new_tokens=4)[0]
        assert r_seq[i].tokens == fresh.tokens == r_par[i].tokens, i
        assert r_seq[i].stats["prefill_kind"] == "tokenwise"
        assert r_par[i].stats["prefill_kind"] == "tokenwise"
    counts = par.metrics.to_prometheus()
    assert 'serving_prefills_total{kind="tokenwise"} 3' in counts


def test_recurrent_state_is_contiguous_and_resets(model):
    """``kv_block`` leaves the recurrent state contiguous (the reference's
    ``api.init_decode_state``), the tail-extend prefill refuses the family,
    and a slot's reset zeroes its recurrent leaves (``attn_kpos`` to -1)
    without touching the other slots."""
    jcfg, _, tcfg, tp = model
    st = tapi.init_decode_state(tcfg, 2, 16, kv_block=4, device="cpu")
    want = japi.init_decode_state(jcfg, 2, 16, kv_block=4)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    with pytest.raises(ValueError, match="not paged"):
        tapi.prefill_extend(tp, tcfg, None, None, None, None)
    eng = _engine(tp, tcfg, 2)
    eng.generate([[5, 9, 2], [1, 2]], max_new_tokens=2)
    before = {k: v.clone() for k, v in eng.state.items()}
    eng._reset_slot_state(0)
    for name, v in eng.state.items():
        assert (v[:, 0] == (-1 if "kpos" in name else 0)).all(), name
        assert torch.equal(v[:, 1], before[name][:, 1]), name
        assert before[name][:, 0].ne(v[:, 0]).any(), name  # it held a state


def test_greedy_tokens_equal_the_reference_engine(model):
    jcfg, jp, tcfg, tp = model
    jeng = JEngine(jp, jcfg, n_slots=2, max_len=32, metrics=False)
    want = [r.tokens for r in jeng.generate(PROMPTS, max_new_tokens=6)]
    got = [r.tokens for r in _engine(tp, tcfg, 2).generate(PROMPTS,
                                                           max_new_tokens=6)]
    assert got == want


@pytest.fixture(scope="module")
def arts(model):
    jcfg, jp, tcfg, tp = model
    kw = dict(algorithm="fp", max_share_rel_err=0.06)
    return (japi.compress_model(jp, jcfg, jcore.CompressionConfig(**kw)),
            tapi.compress_model(tp, tcfg, CompressionConfig(**kw)))


def test_compressed_engine_tokens_equal_the_reference(arts):
    jart, tart = arts
    jeng = JEngine(artifact=jart, n_slots=2, max_len=32, use_kernel=False,
                   metrics=False)
    want = [r.tokens for r in jeng.generate(PROMPTS, max_new_tokens=6)]
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=32, device="cpu")
    got = [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=6)]
    assert got == want
    ex = eng.executor
    assert ex.routed == ex.sites == set(tart.records)
    assert eng.n_layer_plans == 0


def test_plan_refusal_reaches_the_fallback_metric(arts):
    _, tart = arts
    family = tart.config.family
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=16, device="cpu")
    eng.generate([[5, 9]], max_new_tokens=4, temperature=0.0)
    st = eng.plan_stats()
    assert st["n_layer_plans"] == 0
    assert st["fallbacks"] == {"step": f"family:{family}"}
    assert "kernel_launches_per_step" in st
    metric = eng.metrics.to_prometheus()
    assert f'serving_plan_fallbacks_total{{reason="family:{family}"}} 1' in metric
