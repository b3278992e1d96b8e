"""K8 — the routed FFN inside the whole-step plan — and the MoE decode routes
of the port, against the JAX package at reduced mixtral-8x22b widths.

An artifact from the JAX package's real compressor (every attention and
expert site, float32) is carried across.  The port packs the plan's
expert super-stages ``eg``/``ed`` bitwise as the reference does.  The
step's plain version (what its wrapper runs for CPU tensors) is held
against ``repro.kernels.layer_plan.step_plan_matmul(moe=...)`` in interpret
mode on the stages the reference packed — rms norm, GQA, a window of 5 or
none, contiguous and paged caches, an idle slot, with and without capacity
drops — within 1e-4 * max(1, max|ref|) (float32, other op order through
routing, two expert stages and the combine).  Decode on the plan route ==
the reference's plan == the dense-effective weights, and the per-region
route (grouped expert launches) == the reference's per-region route, logits
and KV state <= 1e-4; greedy engine tokens equal the JAX engine's."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.kernels import layer_plan as jlp
from repro.models import api as japi
from repro.models.layers import _rope_sincos as j_rope_sincos
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import artifact_from_reference, stage_from_reference
from repro_torch.kernels import dispatch
from repro_torch.kernels.layer_plan import step_plan_matmul_plain
from repro_torch.models import api as tapi
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import CompressedExecutor, StepPlan

STEP_TOL = 1e-4
DECODE_TOL = 1e-4


def _cfg():
    return jreduced(jget_arch("mixtral-8x22b"), d_model=32, n_heads=4,
                    n_kv_heads=2, head_dim=16, vocab=64, n_layers=2,
                    moe=jget_arch("mixtral-8x22b").moe.__class__(
                        n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=1.25))


@pytest.fixture(scope="module")
def arts():
    cfg = _cfg()
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    art = japi.compress_model(
        params, cfg, jcore.CompressionConfig(algorithm="fp", max_share_rel_err=0.06))
    return art, artifact_from_reference(art, "cpu")


@pytest.fixture(scope="module")
def plans(arts):
    """(reference plan, port plan packed by the port from the carried
    artifact without the reference's stages)."""
    jart, tart = arts
    jplan = JExecutor(jart, interpret=True).step_plan(jart.config)
    own = dataclasses.replace(tart, plans={})
    tplan = CompressedExecutor(own, device="cpu").step_plan(own.config)
    return jplan, tplan


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_expert_stages_pack_bitwise_as_the_reference(plans):
    jplan, tplan = plans
    assert set(tplan.stages) == set(jplan.stages) == {"qkv", "o", "eg", "ed"}
    for name, jps in jplan.stages.items():
        tps = tplan.stages[name]
        for f in ("prep_src", "prep_tgt", "gidx", "gexp", "gsgn", "outg",
                  "fs_mat", "dw_mat", "bias", "segs"):
            a, b = getattr(tps, f), getattr(jps, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name}.{f}")
                assert a.dtype == np.asarray(b).dtype
        assert (tps.k_alloc, tps.d_src, tps.out_dim, tps.site_names) == \
            (jps.k_alloc, jps.d_src, jps.out_dim, tuple(jps.site_names))
    moe = tplan.moe
    assert {k: v for k, v in moe.items() if k not in ("router", "dropped")} == \
        {k: v for k, v in jplan.moe.items() if k != "router"}
    np.testing.assert_array_equal(moe["router"].numpy(), jplan.moe["router"])


@pytest.mark.parametrize("window,paged,cf", [
    (None, False, 1.25), (5, False, 1.25), (None, True, 1.25), (5, True, 0.5),
    (None, False, 0.5)])
def test_moe_step_plain_matches_reference(arts, plans, window, paged, cf):
    jplan, _ = plans
    jst = jplan.stages
    tst = {n: stage_from_reference(ps) for n, ps in jst.items()}
    cfg = arts[1].config
    n_l, d, nkv, hd = cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd
    b, smax = 8, 8
    rng = np.random.default_rng(zlib.crc32(repr((window, paged, cf)).encode()))
    x0 = rng.standard_normal((d, b)).astype(np.float32)
    pos = np.array([5, -1, 12, 3, 7, 0, 9, 2], np.int32)  # row 1 is idle
    kpos = rng.integers(-1, 14, (n_l, b, smax)).astype(np.int32)
    kc = rng.standard_normal((n_l, b, smax, nkv, hd)).astype(np.float32)
    vc = rng.standard_normal((n_l, b, smax, nkv, hd)).astype(np.float32)
    ln1 = (1.0 + 0.1 * rng.standard_normal((n_l, d))).astype(np.float32)
    ln2 = (1.0 + 0.1 * rng.standard_normal((n_l, d))).astype(np.float32)
    sin, cos = (np.array(a) for a in j_rope_sincos(jnp.asarray(pos), hd,
                                                      cfg.rope_theta))
    jmoe = dict(jplan.moe, capacity_factor=cf)
    common = dict(n_heads=cfg.n_heads, n_kv_heads=nkv, head_dim=hd,
                  d_ff=cfg.d_ff, norm="rms", rope=True, window=window)
    want = jlp.step_plan_matmul(
        jst, **common, x0=jnp.asarray(x0), pos=jnp.asarray(pos),
        cos=jnp.asarray(cos), sin=jnp.asarray(sin), ln1=ln1, ln2=ln2,
        kc=jnp.asarray(kc), vc=jnp.asarray(vc), kpos=jnp.asarray(kpos),
        moe=jmoe, interpret=True)
    t = torch.from_numpy
    tbl = None
    kc_t, vc_t = t(kc), t(vc)
    if paged:  # the same view, held in a block pool behind a block table
        bs, mb = 4, smax // 4
        tbl_np = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
        pool_k = np.zeros((n_l, b * mb + 1, bs, nkv, hd), np.float32)
        pool_v = np.zeros_like(pool_k)
        for r in range(b):
            for j in range(mb):
                pool_k[:, tbl_np[r, j]] = kc[:, r, j * bs:(j + 1) * bs]
                pool_v[:, tbl_np[r, j]] = vc[:, r, j * bs:(j + 1) * bs]
        kc_t, vc_t, tbl = t(pool_k), t(pool_v), t(tbl_np)
    dropped = torch.zeros(1, dtype=torch.int32)
    tmoe = dict(jmoe, router=t(np.array(jmoe["router"])), dropped=dropped)
    dispatch.reset_launch_count()
    got = step_plan_matmul_plain(
        tst, **common, x0=t(x0), pos=t(pos), cos=t(cos), sin=t(sin),
        ln1=t(ln1), ln2=t(ln2), kc=kc_t, vc=vc_t, kpos=t(kpos),
        block_tbl=tbl, moe=tmoe)
    assert dispatch.launch_count() == 0
    for g, w in zip(got, want):
        _close(g, w, STEP_TOL)
    if cf < 1:  # capacity 4 for 8 rows x 2 choices over 4 experts
        assert int(dropped) > 0


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
    ids=["plan-contiguous", "plan-paged", "per_region-contiguous",
         "per_region-paged"])
def test_moe_decode_matches_reference_and_dense(arts, use_plans, paged):
    jart, tart = arts
    jcfg, tcfg = jart.config, tart.config
    jex = JExecutor(jart, interpret=True, use_plans=use_plans)
    tex = CompressedExecutor(tart, use_plans=use_plans, device="cpu")
    b, smax = 6, 16
    js, ts, ds = _states(jcfg, tcfg, b, smax, paged)
    rng = np.random.default_rng(int(use_plans) * 2 + int(paged))
    toks = rng.integers(0, jcfg.vocab, (2, b)).astype(np.int32)
    poss = np.array([[0] * b, [1, -1, 1, 1, 1, 1]], np.int32)  # an idle slot
    for t in range(2):
        tok, pos = toks[t][:, None], poss[t]
        lj, js = japi.decode(jart.params, jcfg, js, jnp.asarray(tok),
                             jnp.asarray(pos), executor=jex)
        with torch.no_grad():
            lt, ts = tapi.decode(tart.params, tcfg, ts, torch.from_numpy(tok),
                                 torch.from_numpy(pos), executor=tex)
            ld, ds = tapi.decode(tart.params, tcfg, ds, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=DECODE_TOL)
        np.testing.assert_allclose(_np(lt), _np(ld), rtol=0, atol=DECODE_TOL)
    for name in ("k", "v", "kpos"):
        np.testing.assert_allclose(_np(ts[name]), np.asarray(js[name], np.float32),
                                   rtol=0, atol=DECODE_TOL)
    assert tex.n_layer_plans == jex.n_layer_plans == int(use_plans)
    assert tex.routed == tex.sites == set(tart.records)
    assert int(tex.moe_dropped) >= 0
    if use_plans:
        assert tex.plan_fallbacks == jex.plan_fallbacks == {}
        assert isinstance(tex.step_plan(tcfg), StepPlan)
    else:
        assert tex.plan_fallbacks == jex.plan_fallbacks == {
            "step": "plans_disabled", "moe:l0": "plans_disabled",
            "moe:l1": "plans_disabled"}


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
    assert got == want == [r.tokens for r in dense.generate(prompts, max_new_tokens=6)]
    assert jeng.n_layer_plans == eng.n_layer_plans == 1
    assert eng.executor.routed == eng.executor.sites
