"""The prefix cache's model and engine half against the reference.

* ``attention_extend``, ``mla_extend`` and ``api.prefill_extend`` (the
  tail-extend prefill) on the same inputs as the JAX functions, on
  converted reduced olmo-1b, mixtral-8x22b (capacity drops occurring) and
  deepseek-v2-lite params: outputs and tails within ``TOL``, padded tail
  rows finite.
* The engine cases of the reference's ``tests/test_kvpool.py`` (COW
  divergence, a partial tail that pays only the tail, zero leaked blocks)
  run by the port's engine and by the JAX engine on the same converted
  params: identical greedy tokens and pool stats — on raw weights, on MLA,
  and on a compressed artifact through the plan and per-region routes.
* The tokenwise prefill (``bulk_prefill=False``, contiguous) == the bulk
  prefill; the engine's and the launcher's prefix-cache defaults.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models import attention as jattn
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import (artifact_from_reference,
                                 config_from_reference, params_from_numpy)
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttrans
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import CompressedExecutor

TOL = 1e-4
QUICKSTART = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
                  n_kv_heads=2, head_dim=16)


def _model(arch, **over):
    jcfg = jreduced(jget_arch(arch), vocab=128, **over)
    if jcfg.moe is not None and arch.startswith("mixtral"):
        # scarce capacity, so that the tail's padded rows compete for it
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=0.5))
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_reference(jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             tcfg, "cpu")


@pytest.fixture(scope="module")
def dense_model():
    return _model("olmo-1b")


@pytest.fixture(scope="module")
def mla_model():
    return _model("deepseek-v2-lite-16b")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, what):
    got = got.detach().float().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=TOL, err_msg=what)


def _tail_inputs(rng, d, c=24, cached=13, tl=5, t_pad=8):
    """A prefix view of ``c`` slots (``cached`` real), ``tl`` tail tokens
    padded to ``t_pad`` at position -1."""
    x = rng.standard_normal((1, t_pad, d)).astype(np.float32)
    pos = np.full((1, t_pad), -1, np.int32)
    pos[0, :tl] = np.arange(cached, cached + tl)
    kpos = np.full((1, c), -1, np.int32)
    kpos[0, :cached] = np.arange(cached)
    return x, pos, kpos


def test_attention_extend_matches_the_reference(dense_model):
    jcfg, jp, tcfg, tp = dense_model
    rng = np.random.default_rng(0)
    x, pos, kpos = _tail_inputs(rng, jcfg.d_model)
    hkv, hd = jcfg.n_kv_heads, jcfg.hd
    pk = rng.standard_normal((1, 24, hkv, hd)).astype(np.float32)
    pv = rng.standard_normal((1, 24, hkv, hd)).astype(np.float32)
    jap = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tap = {k: {n: v[0] for n, v in d.items()} for k, d in
           tp["blocks"]["attn"].items()}
    kw = dict(n_heads=jcfg.n_heads, n_kv=hkv, head_dim=hd,
              rope_theta=jcfg.rope_theta)
    jo = jattn.attention_extend(jap, jnp.asarray(x), jnp.asarray(pos),
                                jnp.asarray(pk), jnp.asarray(pv),
                                jnp.asarray(kpos), **kw)
    to = tattn.attention_extend(tap, _t(x), _t(pos), _t(pk), _t(pv), _t(kpos),
                                **kw)
    for got, want, what in zip(to, jo, ("out", "k_tail", "v_tail")):
        _close(got, want, what)


def test_mla_extend_matches_the_reference(mla_model):
    jcfg, jp, tcfg, tp = mla_model
    m = jcfg.mla
    rng = np.random.default_rng(1)
    x, pos, kpos = _tail_inputs(rng, jcfg.d_model)
    pc = rng.standard_normal((1, 24, m.kv_lora)).astype(np.float32)
    pr = rng.standard_normal((1, 24, m.qk_rope)).astype(np.float32)
    jap = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tap = {k: {n: v[0] for n, v in d.items()} for k, d in
           tp["blocks"]["attn"].items()}
    kw = dict(n_heads=jcfg.n_heads, qk_nope=m.qk_nope, qk_rope=m.qk_rope,
              v_dim=m.v_dim, rope_theta=jcfg.rope_theta)
    jo = jattn.mla_extend(jap, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(pc),
                          jnp.asarray(pr), jnp.asarray(kpos), **kw)
    to = tattn.mla_extend(tap, _t(x), _t(pos), _t(pc), _t(pr), _t(kpos), **kw)
    for got, want, what in zip(to, jo, ("out", "c_tail", "kr_tail")):
        _close(got, want, what)


def _past(jcfg, jp, cached, view, rng):
    """A gathered resident prefix from the reference's prefill of ``cached``
    tokens, padded to ``view`` slots (kpos -1 beyond it), and the prompt."""
    prompt = rng.integers(0, jcfg.vocab, cached + 20)
    toks = jnp.asarray(prompt[None, :cached], jnp.int32)
    _h, caches = japi.prefill(jp, jcfg, {"tokens": toks}, collect_cache=True)
    names = ("c_kv", "k_rope") if jcfg.mla is not None else ("k", "v")
    past = {}
    for n, c in zip(names, caches):
        c = np.asarray(c)  # [L, 1, cached, ...]
        pad = np.zeros(c.shape[:2] + (view - cached,) + c.shape[3:], c.dtype)
        past[n] = np.concatenate([c, pad], axis=2)
    kp = np.full((1, view), -1, np.int32)
    kp[0, :cached] = np.arange(cached)
    past["kpos"] = np.broadcast_to(kp[None], (jcfg.n_layers, 1, view)).copy()
    return past, prompt


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b",
                                  "deepseek-v2-lite-16b"])
def test_prefill_extend_matches_the_reference(arch, monkeypatch):
    jcfg, jp, tcfg, tp = _model(arch, **({"attn_window": None}
                                         if arch.startswith("mixtral") else {}))
    rng = np.random.default_rng(2)
    cached, view, tl = 16, 48, 20
    t_pad = max(8, 1 << (tl - 1).bit_length())
    past, prompt = _past(jcfg, jp, cached, view, rng)
    toks = np.zeros((1, t_pad), np.int32)
    toks[0, :tl] = prompt[cached:cached + tl]
    pos = np.full((1, t_pad), -1, np.int32)
    pos[0, :tl] = np.arange(cached, cached + tl)
    last = np.array([tl - 1], np.int32)
    jl, jt = japi.prefill_extend(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                                 jax.tree.map(jnp.asarray, past),
                                 jnp.asarray(last))
    drops = []
    if tcfg.moe is not None:
        real = ttrans.moe_ffn

        def spy(*a, **k):
            y, aux = real(*a, **k)
            drops.append(float(aux["dropped_frac"]))
            return y, aux

        monkeypatch.setattr(ttrans, "moe_ffn", spy)
    with torch.no_grad():
        tl_, tt = tapi.prefill_extend(tp, tcfg, _t(toks), _t(pos),
                                      {k: _t(v) for k, v in past.items()},
                                      _t(last))
    _close(tl_, jl, "logits")
    assert sorted(tt) == sorted(jt)
    for name, tail in tt.items():
        assert tuple(tail.shape[:3]) == (jcfg.n_layers, 1, t_pad)
        _close(tail, jt[name], name)  # padded rows included: finite, equal
    if arch.startswith("mixtral"):
        assert max(drops) > 0  # the padded rows took capacity: drops occur
    if tcfg.moe is None:
        # the last real token's logits are those of a cold prefill
        with torch.no_grad():
            h, _ = ttrans.forward(tp, tcfg, tokens=_t(prompt[None, :cached + tl]))
            cold = ttrans.logits_from_hidden(tp, tcfg, h[:, -1])
        _close(tl_, cold.numpy(), "logits vs cold prefill")


# ----------------------------------------------------------- engine cases


def _engines(params_j, jcfg, params_t, tcfg, **kw):
    return (JEngine(params_j, jcfg, metrics=False, **kw),
            ServingEngine(params_t, tcfg, device="cpu", **kw))


def _both(engs, prompts, n):
    je, te = engs
    jr = je.generate(prompts, max_new_tokens=n)
    tr = te.generate(prompts, max_new_tokens=n)
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert [r.stats["cached_tokens"] for r in tr] == \
        [r.stats["cached_tokens"] for r in jr]
    assert te.pool_stats() == je.pool_stats()
    return tr


def _cow_and_partial_tail(engs, ref_tokens, vocab):
    """The reference's ``test_prefix_hit_and_cow_divergence`` and
    ``test_prefix_partial_tail_pays_only_tail`` on one pair of engines."""
    a = [(11 * i + 5) % vocab for i in range(24)]  # 3 full 8-blocks
    b = a[:20]  # shares 2 full blocks + half of a's block 2 -> COW
    ra0 = _both(engs, [a], 8)[0]
    s = engs[1].pool_stats()
    assert s["prefix_hit_blocks"] == 0 and s["in_use_blocks"] == 0
    rb = _both(engs, [b], 8)[0]
    s = engs[1].pool_stats()
    assert s["cow_copies"] == 1 and s["prefix_hit_tokens"] >= 20
    assert rb.stats["cached_tokens"] >= 16
    assert rb.tokens == ref_tokens(b, 8)  # COW: a cold engine's tokens
    ra1 = _both(engs, [a], 8)[0]
    assert ra1.tokens == ra0.tokens  # a's cached blocks are intact
    assert engs[1].pool_stats()["in_use_blocks"] == 0  # zero leaks
    head = [(3 * i + 1) % vocab for i in range(16)]  # 2 full blocks
    p1, p2 = head + [40, 41, 42], head + [50, 51, 52, 53, 54]
    q0 = engs[1].pool_stats()["prefix_hit_tokens"]
    _both(engs, [p1], 6)
    r2 = _both(engs, [p2], 6)[0]
    s = engs[1].pool_stats()
    assert s["prefix_hit_tokens"] - q0 == 16 and r2.stats["cached_tokens"] == 16
    assert r2.tokens == ref_tokens(p2, 6)  # the tail-extend prefill is exact
    assert s["in_use_blocks"] == 0


@pytest.mark.parametrize("which", ["dense", "mla"])
def test_engine_prefix_cases_match_the_reference(which, dense_model, mla_model):
    jcfg, jp, tcfg, tp = dense_model if which == "dense" else mla_model
    engs = _engines(jp, jcfg, tp, tcfg, n_slots=2, max_len=128, kv_block=8)
    cold = ServingEngine(tp, tcfg, n_slots=2, max_len=128, kv_block=None,
                         device="cpu")

    def ref_tokens(p, n):
        return cold.generate([p], max_new_tokens=n)[0].tokens

    _cow_and_partial_tail(engs, ref_tokens, jcfg.vocab)
    # four requests in one batch on one head: later ones hit while the
    # first is in flight
    head = [(7 * i + 2) % jcfg.vocab for i in range(16)]
    tails = [[60 + i, 61 + i] for i in range(4)]
    engs4 = _engines(jp, jcfg, tp, tcfg, n_slots=4, max_len=64, kv_block=8)
    res = _both(engs4, [head + t for t in tails], 5)
    assert [r.stats["cached_tokens"] for r in res] == [0, 16, 16, 16]
    assert engs4[1].pool_stats()["in_use_blocks"] == 0


@pytest.fixture(scope="module")
def compressed():
    jcfg = jreduced(jget_arch("olmo-1b"), **QUICKSTART)
    jart = japi.compress_model(
        japi.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
        jcore.CompressionConfig(algorithm="fp", prune_tol=-1e-6,
                                weight_sharing=False))
    return jcfg, jart, artifact_from_reference(jart, "cpu")


@pytest.mark.parametrize("route", ["plan", "per-region"])
def test_compressed_artifact_prefix_cases_match_the_reference(
        route, compressed, monkeypatch):
    jcfg, jart, tart = compressed
    plans = route == "plan"
    monkeypatch.setattr(JEngine, "_build_executor", staticmethod(
        lambda art, interpret, mesh=None: JExecutor(
            art, interpret=interpret, use_plans=plans)))
    monkeypatch.setattr(ServingEngine, "_build_executor", staticmethod(
        lambda art, device: CompressedExecutor(art, use_plans=plans,
                                               device=device)))
    kw = dict(n_slots=2, max_len=64, kv_block=8)
    engs = (JEngine(artifact=jart, metrics=False, **kw),
            ServingEngine(artifact=tart, device="cpu", **kw))
    cold = ServingEngine(artifact=tart, device="cpu", n_slots=2, max_len=64,
                         kv_block=None)

    def ref_tokens(p, n):
        return cold.generate([p], max_new_tokens=n)[0].tokens

    _cow_and_partial_tail(engs, ref_tokens, jcfg.vocab)
    assert engs[1].n_layer_plans == (1 if plans else 0)
    assert engs[1].executor.routed == engs[1].executor.sites


def test_windowed_and_mrope_configs_turn_sharing_off(dense_model):
    _, _, tcfg, tp = dense_model
    eng = ServingEngine(tp, tcfg, n_slots=2, max_len=64, device="cpu")
    assert eng.pool.prefix_cache is True  # the default, as the reference's
    win = ServingEngine(tp, dataclasses.replace(tcfg, attn_window=16),
                        n_slots=2, max_len=64, device="cpu")
    assert win.pool.prefix_cache is False
    off = ServingEngine(tp, tcfg, n_slots=2, max_len=64, prefix_cache=False,
                        device="cpu")
    p = [(5 * i + 3) % tcfg.vocab for i in range(20)]
    r1 = off.generate([p, p], max_new_tokens=3)
    assert off.pool_stats()["prefix_hit_tokens"] == 0
    assert [r.stats["cached_tokens"] for r in r1] == [0, 0]


@pytest.mark.parametrize("which", ["dense", "mla", "compressed"])
def test_tokenwise_prefill_equals_bulk(which, dense_model, mla_model,
                                       compressed):
    if which == "compressed":
        _, _, tart = compressed
        mk = lambda **kw: ServingEngine(artifact=tart, device="cpu", **kw)  # noqa: E731
        vocab = tart.config.vocab
    else:
        _, _, tcfg, tp = dense_model if which == "dense" else mla_model
        mk = lambda **kw: ServingEngine(tp, tcfg, device="cpu", **kw)  # noqa: E731
        vocab = tcfg.vocab
    prompts = [[(3 * i + 7 * j + 1) % vocab for i in range(9 + 4 * j)]
               for j in range(3)]
    bulk = mk(n_slots=2, max_len=48, kv_block=None)
    tok = mk(n_slots=2, max_len=48, kv_block=None, bulk_prefill=False)
    paged_req = mk(n_slots=2, max_len=48, bulk_prefill=False)
    assert not tok.paged and not paged_req.paged  # tokenwise is contiguous
    rb = bulk.generate(prompts, max_new_tokens=6)
    rt = tok.generate(prompts, max_new_tokens=6)
    assert [r.tokens for r in rt] == [r.tokens for r in rb]
    assert {r.stats["prefill_kind"] for r in rt} == {"tokenwise"}
    assert {r.stats["prefill_kind"] for r in rb} == {"bulk"}


def test_tokenwise_prefill_matches_the_reference_engine(dense_model):
    jcfg, jp, tcfg, tp = dense_model
    prompts = [[(5 * i + j) % jcfg.vocab for i in range(7 + j)] for j in range(3)]
    kw = dict(n_slots=2, max_len=32, kv_block=None, bulk_prefill=False)
    je, te = _engines(jp, jcfg, tp, tcfg, **kw)
    jr = je.generate(prompts, max_new_tokens=5)
    tr = te.generate(prompts, max_new_tokens=5)
    assert [r.tokens for r in tr] == [r.tokens for r in jr]


def test_serve_launcher_prints_the_pool_stats():
    from repro_torch.launch import serve

    for flag in ([], ["--no-prefix-cache"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                        "--max-new", "2", *flag])
        line = next(l for l in out.getvalue().splitlines()
                    if l.startswith("kv pool:"))
        assert "prefix hit-rate 0.00 (0 tok), 0 COW, 0 evictions" in line
