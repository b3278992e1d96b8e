"""deepseek-v2-lite on the port — MLA attention, shared experts and the
per-layer MoE plan route (K9) — against the JAX package at reduced widths.

The configuration is the reference's, field for field.  ``moe_ffn`` with
shared experts agrees with the reference's within 1e-5 * max(1, max|y|),
with the same routing and the same kept choices (capacity drops occur).
An artifact from the JAX package's real compressor (every MLA, expert and
shared-expert site, float32) is carried across: decode on the K9 route
(float32: the whole-step plan is refused with ``"mla"``, each layer's
experts run through ``moe_plan_matmul``'s plain version) and on the
per-region route (``use_plans=False``) agrees with the reference's executor
in interpret mode and with the dense-effective weights — logits and the
latent state within 1e-4, contiguous and paged, with an idle slot; every
site is routed and ``plan_fallbacks`` equal the reference's.  The bf16
per-region route records ``"cdtype"`` for every layer's plan, as the
reference does.  Greedy engine tokens equal the JAX engine's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import MoESpec as JMoESpec
from repro.configs.base import arch_to_dict as jarch_to_dict
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models.moe import moe_ffn as jmoe_ffn
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.configs import arch_to_dict, get_arch, reduced_config
from repro_torch.convert import artifact_from_reference, config_from_reference
from repro_torch.kernels import dispatch
from repro_torch.kernels.moe_route import capacity
from repro_torch.models import api as tapi
from repro_torch.models.moe import moe_ffn
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import CompressedExecutor, MoEPlan
from repro_torch.testing import seeded_artifact

TOL = 1e-5
DECODE_TOL = 1e-4


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _cfg():
    return jreduced(jget_arch("deepseek-v2-lite-16b"), d_model=32, n_heads=2,
                    n_kv_heads=2, vocab=64, n_layers=2,
                    moe=JMoESpec(n_experts=4, top_k=2, d_ff_expert=16,
                                 n_shared=1, capacity_factor=1.25))


@pytest.fixture(scope="module")
def arts():
    cfg = _cfg()
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    art = japi.compress_model(
        params, cfg, jcore.CompressionConfig(algorithm="fp",
                                             max_share_rel_err=0.06))
    return art, artifact_from_reference(art, "cpu")


def test_deepseek_config_agrees_with_the_reference():
    for red in (False, True):
        j, t = jget_arch("deepseek-v2-lite-16b"), get_arch("deepseek-v2-lite-16b")
        if red:
            j, t = jreduced(j), reduced_config(t)
        assert jarch_to_dict(j) == arch_to_dict(t)
        assert config_from_reference(j) == t
    cfg = get_arch("deepseek-v2-lite-16b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.vocab,
            cfg.rope_theta, cfg.norm) == (27, 2048, 16, 128, 102400, 1e4, "rms")
    assert (cfg.mla.kv_lora, cfg.mla.qk_nope, cfg.mla.qk_rope,
            cfg.mla.v_dim) == (512, 128, 64, 128)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.moe.n_shared, cfg.moe.capacity_factor,
            cfg.moe.norm_topk) == (64, 6, 1408, 2, 1.25, True)
    # the serves' traffic: 8 slots x top-6 over 64 experts -> 4 columns
    assert capacity(8, 6, 1.25, 64) == 4


@pytest.mark.parametrize("case", ["no_drops", "drops"])
def test_moe_ffn_with_shared_experts_matches_reference(case):
    rng = np.random.default_rng(["no_drops", "drops"].index(case) + 40)
    d, n_exp, dff, k, sff = 32, 4, 16, 2, 32
    b, s = 2, 16
    cf = {"no_drops": 8.0, "drops": 0.5}[case]

    def tn(shape, fan):
        return (np.clip(rng.standard_normal(shape), -2, 2)
                / np.sqrt(fan)).astype(np.float32)
    p = {"router": tn((d, n_exp), d), "gate": tn((n_exp, d, dff), d),
         "up": tn((n_exp, d, dff), d), "down": tn((n_exp, dff, d), dff),
         "shared": {"gate": {"w": tn((d, sff), d)}, "up": {"w": tn((d, sff), d)},
                    "down": {"w": tn((sff, d), sff)}}}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(n_experts=n_exp, top_k=k, capacity_factor=cf, norm_topk=True)
    jy, jaux = jmoe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), **kw)
    ty, taux = moe_ffn(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
                       **kw)
    np.testing.assert_array_equal(taux["sel"].numpy(), np.asarray(jaux["sel"]))
    assert float(taux["dropped_frac"]) == pytest.approx(
        float(jaux["dropped_frac"]), abs=1e-7)
    assert (int((~taux["keep"]).sum()) > 0) == (case == "drops")
    want = np.asarray(jy)
    np.testing.assert_allclose(_np(ty), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _states(jcfg, tcfg, b, smax, paged):
    kw = dict(kv_block=4) if paged else {}
    js = japi.init_decode_state(jcfg, b, smax, **kw)
    ts = tapi.init_decode_state(tcfg, b, smax, device="cpu", **kw)
    ds = tapi.init_decode_state(tcfg, b, smax, device="cpu", **kw)
    if paged:  # give every row its own blocks (block 0 is the null block)
        mb = ts["block_tbl"].shape[1]
        tbl = (1 + np.arange(b * mb)).reshape(b, mb).astype(np.int32)
        js["block_tbl"] = jnp.asarray(tbl)
        ts["block_tbl"].copy_(torch.from_numpy(tbl))
        ds["block_tbl"].copy_(torch.from_numpy(tbl))
    return js, ts, ds


@pytest.mark.parametrize("use_plans,paged", [
    (True, False), (True, True), (False, False), (False, True)],
    ids=["moe_plan-contiguous", "moe_plan-paged", "per_region-contiguous",
         "per_region-paged"])
def test_decode_matches_reference_and_dense(arts, use_plans, paged):
    jart, tart = arts
    jcfg, tcfg = jart.config, tart.config
    jex = JExecutor(jart, interpret=True, use_plans=use_plans)
    tex = CompressedExecutor(tart, use_plans=use_plans, device="cpu")
    b, smax = 6, 16
    js, ts, ds = _states(jcfg, tcfg, b, smax, paged)
    rng = np.random.default_rng(int(use_plans) * 2 + int(paged) + 50)
    toks = rng.integers(0, jcfg.vocab, (3, b)).astype(np.int32)
    poss = np.array([[0] * b, [1, -1, 1, 1, 1, 1], [2, -1, 2, 2, 2, 2]],
                    np.int32)  # an idle slot
    dispatch.reset_launch_count()
    for t in range(3):
        tok, pos = toks[t][:, None], poss[t]
        lj, js = japi.decode(jart.params, jcfg, js, jnp.asarray(tok),
                             jnp.asarray(pos), executor=jex)
        with torch.no_grad():
            lt, ts = tapi.decode(tart.params, tcfg, ts, torch.from_numpy(tok),
                                 torch.from_numpy(pos), executor=tex)
            ld, ds = tapi.decode(tart.params, tcfg, ds, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0,
                                   atol=DECODE_TOL)
        np.testing.assert_allclose(_np(lt), _np(ld), rtol=0, atol=DECODE_TOL)
    assert dispatch.launch_count() == 0  # CPU tensors: the plain versions
    for name in ("c_kv", "k_rope", "kpos"):
        np.testing.assert_allclose(_np(ts[name]), np.asarray(js[name], np.float32),
                                   rtol=0, atol=DECODE_TOL)
    assert tex.routed == tex.sites == set(tart.records)
    assert tex.plan_fallbacks == jex.plan_fallbacks
    assert tex.n_layer_plans == jex.n_layer_plans == (2 if use_plans else 0)
    if use_plans:
        assert tex.plan_fallbacks == {"step": "mla"}
        assert isinstance(tex.moe_plan("l1", n_experts=4, d_model=32, d_ff=16),
                          MoEPlan)
    else:
        # MLA decode never asks for the step plan
        assert tex.plan_fallbacks == {"moe:l0": "plans_disabled",
                                      "moe:l1": "plans_disabled"}


def test_bf16_per_region_route_records_cdtype_as_the_reference():
    """bf16 compute refuses the whole-step plan with "mla" and every layer's
    expert plan with "cdtype"; the grouped per-region route serves every
    site.  The seeded fixture has weight-shared attention and expert sites."""
    jcfg = jreduced(jget_arch("deepseek-v2-lite-16b"), vocab=64,
                    param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = config_from_reference(jcfg)
    art = seeded_artifact(tcfg, seed=4, device="cpu")
    ex = CompressedExecutor(art, device="cpu")
    st = tapi.init_decode_state(tcfg, 3, 8, kv_block=4, device="cpu")
    st["block_tbl"].copy_(torch.arange(1, 7, dtype=torch.int32).reshape(3, 2))
    with torch.no_grad():
        lg, _ = tapi.decode(art.params, tcfg, st, torch.tensor([[3], [9], [1]]),
                            torch.tensor([0, 0, -1]), executor=ex)
    assert lg.dtype == torch.bfloat16 and torch.isfinite(lg.float()).all()
    assert ex.plan_fallbacks == {"step": "mla", "moe:l0": "cdtype",
                                 "moe:l1": "cdtype"}
    assert ex.n_layer_plans == 0 and ex.routed == ex.sites == set(art.records)
    shared = {".".join(n.split(".")[:2]) for n, r in art.records.items()
              if r.shared is not None}
    assert shared == {"attn.o", "moe.up"}


def test_engine_tokens_equal_the_reference_engine(arts):
    jart, tart = arts
    prompts = [[5, 9, 2, 7], [1, 33, 8], [60, 4, 4, 4, 12]]
    jeng = JEngine(artifact=jart, n_slots=4, max_len=32, kv_block=4,
                   prefix_cache=False, metrics=False)
    want = [r.tokens for r in jeng.generate(prompts, max_new_tokens=6,
                                            temperature=0.0)]
    eng = ServingEngine(artifact=tart, n_slots=4, max_len=32, kv_block=4,
                        device="cpu")
    got = [r.tokens for r in eng.generate(prompts, max_new_tokens=6)]
    dense = ServingEngine(artifact=tart, n_slots=4, max_len=32, kv_block=4,
                          use_kernel=False, device="cpu")
    assert got == want == [r.tokens for r in dense.generate(prompts,
                                                            max_new_tokens=6)]
    assert jeng.n_layer_plans == eng.n_layer_plans == 2
    assert eng.executor.routed == eng.executor.sites
    assert eng.plan_stats()["fallbacks"] == {"step": "mla"}


def test_prefill_logits_equal_the_reference(arts):
    jart, tart = arts
    toks = np.random.default_rng(3).integers(0, 64, (2, 12)).astype(np.int32)
    jh, (jc, jr) = japi.prefill(jart.params, jart.config,
                                {"tokens": jnp.asarray(toks)},
                                collect_cache=True)
    with torch.no_grad():
        th, (tc, tr) = tapi.prefill(tart.params, tart.config,
                                    {"tokens": torch.from_numpy(toks)},
                                    collect_cache=True)
    for got, want in ((th, jh), (tc, jc), (tr, jr)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-4)


def test_a_plan_that_does_not_fit_raises(arts):
    """No quiet per-region fallback: a layer plan whose stages do not fit
    the layer raises where the plan runs."""
    _, tart = arts
    own = dataclasses.replace(tart, plans={})
    good = CompressedExecutor(own, device="cpu").moe_plan(
        "l0", n_experts=4, d_model=32, d_ff=16).stages
    bad = dataclasses.replace(tart, plans={"moe:l0": {"a": good["b"],
                                                      "b": good["a"]}})
    ex = CompressedExecutor(bad, device="cpu")
    st = tapi.init_decode_state(bad.config, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="stage A emits"):
        with torch.no_grad():
            tapi.decode(bad.params, bad.config, st, torch.tensor([[1], [2]]),
                        torch.tensor([0, 0]), executor=ex)
