"""K7 (step_plan_matmul, dense branch), the executor's ``StepPlan`` and the
engine on the plan route, against the JAX package.

An artifact from the JAX package's real compressor (reduced olmo-1b with GQA,
float32) is carried across.  The step's plain version (what its wrapper runs
for CPU tensors) is held against ``repro.kernels.layer_plan.
step_plan_matmul`` in interpret mode on the same stages and numpy inputs —
rms and non-parametric norm, RoPE on and off, a sliding window, an idle slot,
contiguous and paged caches — within 1e-5 * max(1, max|ref|) (float32, other
op order).  Decode through the port's plan == JAX decode through its plan ==
the dense-effective weights, logits and KV state <= 1e-4 over two steps."""
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

from repro_torch.configs import get_arch as tget_arch, reduced_config as treduced
from repro_torch.convert import artifact_from_reference
from repro_torch.kernels import dispatch, ops as tops
from repro_torch.kernels.layer_plan import step_plan_matmul, step_plan_matmul_plain
from repro_torch.models import api as tapi
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import CompressedExecutor, StepPlan
from repro_torch.testing import seeded_artifact

STEP_TOL = 1e-5
DECODE_TOL = 1e-4


def _cfg(**kw):
    return jreduced(jget_arch("olmo-1b"), d_model=32, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=48, vocab=64, n_layers=2, **kw)


def _compress(cfg, include=None):
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    return japi.compress_model(
        params, cfg, jcore.CompressionConfig(algorithm="fp", max_share_rel_err=0.06),
        include=include)


@pytest.fixture(scope="module")
def arts():
    art = _compress(_cfg())
    return art, artifact_from_reference(art, "cpu")


@pytest.fixture(scope="module")
def stages(arts):
    """The plan's stages, packed by the port (bitwise the reference's:
    tests/test_torch_stage.py) and, for the reference, carried back as is."""
    jart, tart = arts
    plan = CompressedExecutor(tart, device="cpu").step_plan(tart.config)
    jstages = JExecutor(jart, interpret=True).step_plan(jart.config).stages
    return plan.stages, jstages


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ----------------------------------------------------------------- K7


@pytest.mark.parametrize("norm,rope,window,paged", [
    ("nonparam", True, None, False),
    ("rms", True, None, False),
    ("rms", True, 5, False),
    ("nonparam", False, 5, False),
    ("nonparam", True, None, True),
    ("rms", True, 5, True),
])
def test_step_plain_matches_reference(arts, stages, norm, rope, window, paged):
    tst, jst = stages
    cfg = arts[1].config
    n_l, d, nkv, hd = cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd
    b, smax = 3, 8
    rng = np.random.default_rng(zlib.crc32(repr((norm, rope, window, paged)).encode()))
    x0 = rng.standard_normal((d, b)).astype(np.float32)
    pos = np.array([5, -1, 12], np.int32)  # row 1 is an idle slot
    kpos = rng.integers(-1, 14, (n_l, b, smax)).astype(np.int32)
    kc = rng.standard_normal((n_l, b, smax, nkv, hd)).astype(np.float32)
    vc = rng.standard_normal((n_l, b, smax, nkv, hd)).astype(np.float32)
    ln1 = (1.0 + 0.1 * rng.standard_normal((n_l, d))).astype(np.float32)
    ln2 = (1.0 + 0.1 * rng.standard_normal((n_l, d))).astype(np.float32)
    sin, cos = (np.array(a) for a in j_rope_sincos(jnp.asarray(pos), hd,
                                                      cfg.rope_theta))
    common = dict(n_heads=cfg.n_heads, n_kv_heads=nkv, head_dim=hd,
                  d_ff=cfg.d_ff, norm=norm, rope=rope, window=window)
    want = jlp.step_plan_matmul(
        jst, **common, x0=jnp.asarray(x0), pos=jnp.asarray(pos),
        cos=jnp.asarray(cos) if rope else None,
        sin=jnp.asarray(sin) if rope else None,
        ln1=ln1 if norm == "rms" else None, ln2=ln2 if norm == "rms" else None,
        kc=jnp.asarray(kc), vc=jnp.asarray(vc), kpos=jnp.asarray(kpos),
        interpret=True)
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
    got = step_plan_matmul_plain(
        tst, **common, x0=t(x0), pos=t(pos), cos=t(cos) if rope else None,
        sin=t(sin) if rope else None,
        ln1=t(ln1) if norm == "rms" else None,
        ln2=t(ln2) if norm == "rms" else None,
        kc=kc_t, vc=vc_t, kpos=t(kpos), block_tbl=tbl)
    for g, w in zip(got, want):
        _close(g, w, STEP_TOL)


def test_step_wrapper_takes_the_plain_version_on_the_cpu(arts, stages):
    tst, _ = stages
    cfg = arts[1].config
    n_l, d, nkv, hd = cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(3)
    args = dict(n_heads=cfg.n_heads, n_kv_heads=nkv, head_dim=hd,
                d_ff=cfg.d_ff, norm="nonparam", rope=False, cos=None, sin=None,
                ln1=None, ln2=None,
                x0=torch.from_numpy(rng.standard_normal((d, 2)).astype(np.float32)),
                pos=torch.tensor([0, 3], dtype=torch.int32),
                kc=torch.zeros((n_l, 2, 4, nkv, hd)),
                vc=torch.zeros((n_l, 2, 4, nkv, hd)),
                kpos=torch.full((n_l, 2, 4), -1, dtype=torch.int32))
    dispatch.reset_launch_count()
    for a, b in zip(step_plan_matmul(tst, **args), step_plan_matmul_plain(tst, **args)):
        assert torch.equal(a, b)
    assert dispatch.launch_count() == 0
    # the MoE branch (K8) as well: a reduced mixtral plan's stages and router
    mcfg = treduced(tget_arch("mixtral-8x22b"), d_model=32, n_heads=4,
                    head_dim=16, vocab=64)
    plan = CompressedExecutor(seeded_artifact(mcfg, seed=2, device="cpu"),
                              device="cpu").step_plan(mcfg)
    n_l, d, nkv, hd = mcfg.n_layers, mcfg.d_model, mcfg.n_kv_heads, mcfg.hd
    margs = dict(args, n_kv_heads=nkv, head_dim=hd, d_ff=mcfg.d_ff,
                 x0=torch.from_numpy(rng.standard_normal((d, 2)).astype(np.float32)),
                 kc=torch.zeros((n_l, 2, 4, nkv, hd)),
                 vc=torch.zeros((n_l, 2, 4, nkv, hd)),
                 kpos=torch.full((n_l, 2, 4), -1, dtype=torch.int32),
                 moe={k: v for k, v in plan.moe.items() if k != "dropped"})
    got = step_plan_matmul(plan.stages, **margs)
    for a, b in zip(got, step_plan_matmul_plain(plan.stages, **margs)):
        assert torch.equal(a, b)
    assert dispatch.launch_count() == 0 and torch.isfinite(got[0]).all()


# ----------------------------------------------------- executor / decode


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


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_plan_decode_matches_reference_plan_and_dense(arts, paged):
    jart, tart = arts
    jcfg, tcfg = jart.config, tart.config
    jex = JExecutor(jart, interpret=True)
    tex = CompressedExecutor(tart, device="cpu")
    b, smax = 3, 16
    js, ts, ds = _states(jcfg, tcfg, b, smax, paged)
    toks = np.array([[3, 40, 7], [11, 2, 60]], np.int32)
    poss = np.array([[0, 0, 0], [1, -1, 1]], np.int32)  # an idle slot next
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
        np.testing.assert_allclose(_np(ts[name]), _np(ds[name]), rtol=0,
                                   atol=DECODE_TOL)
    assert tex.n_layer_plans == jex.n_layer_plans == 1
    assert tex.routed == tex.sites == set(tart.records)
    assert tex.plan_fallbacks == jex.plan_fallbacks == {}
    plan = tex.step_plan(tcfg)
    assert isinstance(plan, StepPlan) and plan.stages is tart.plans["step"]
    stats = tart.pipeline_stats
    assert {f"plan.{n}" for n in ("qkv", "o", "gu", "dn")} <= \
        set(stats["padding_waste"]) & set(stats["segment_layout"])


def test_per_region_route_still_matches_the_plan(arts):
    _, tart = arts
    cfg = tart.config
    outs = []
    for use_plans in (True, False):
        ex = CompressedExecutor(tart, use_plans=use_plans, device="cpu")
        st = tapi.init_decode_state(cfg, 2, 8, device="cpu")
        with torch.no_grad():
            lg, _ = tapi.decode(tart.params, cfg, st, torch.tensor([[5], [9]]),
                                torch.tensor([0, 0]), executor=ex)
        outs.append(lg)
        assert ex.n_layer_plans == int(use_plans)
        assert ex.routed == ex.sites
    np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), rtol=0, atol=DECODE_TOL)


def test_bf16_config_records_cdtype_as_the_reference_does(arts):
    jart, tart = arts
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jex = JExecutor(dataclasses.replace(jart, config=dataclasses.replace(
        jart.config, **bf16)), interpret=True)
    tcfg = dataclasses.replace(tart.config, **bf16)
    tex = CompressedExecutor(dataclasses.replace(tart, config=tcfg), device="cpu")
    assert tex.plan_fallbacks == jex.plan_fallbacks == {"step": "cdtype"}
    assert tex.step_plan(tcfg) is None and tex.n_layer_plans == 0
    off = CompressedExecutor(tart, use_plans=False, device="cpu")
    assert off.step_plan(tart.config) is None
    assert off.plan_fallbacks == {"step": "plans_disabled"}


def test_engine_tokens_plan_equal_dense_equal_reference(arts):
    jart, tart = arts
    prompts = [[5, 9, 2, 7], [1, 33, 8]]
    jeng = JEngine(artifact=jart, n_slots=2, max_len=32, kv_block=4,
                   prefix_cache=False, metrics=False)
    want = [r.tokens for r in jeng.generate(prompts, max_new_tokens=6,
                                            temperature=0.0)]
    eng = ServingEngine(artifact=tart, n_slots=2, max_len=32, kv_block=4,
                        device="cpu")
    got = [r.tokens for r in eng.generate(prompts, max_new_tokens=6)]
    dense = ServingEngine(artifact=tart, n_slots=2, max_len=32, kv_block=4,
                          use_kernel=False, device="cpu")
    assert got == want == [r.tokens for r in dense.generate(prompts, max_new_tokens=6)]
    assert jeng.n_layer_plans == eng.n_layer_plans == 1
    assert eng.plan_stats()["fallbacks"] == {}
    assert eng.executor.routed == eng.executor.sites


def test_plan_built_by_the_reference_is_carried_across_and_reused(arts):
    jart, tart = arts
    jart = dataclasses.replace(jart, plans={})
    JExecutor(jart, interpret=True).step_plan(jart.config)  # packs into plans
    carried = artifact_from_reference(jart, "cpu")
    assert set(carried.plans["step"]) == {"qkv", "o", "gu", "dn"}
    ex = CompressedExecutor(carried, device="cpu")
    plan = ex.step_plan(carried.config)
    assert plan.stages is carried.plans["step"] and plan.pack_s == 0.0
    own = CompressedExecutor(dataclasses.replace(tart, plans={}), device="cpu")
    cfg = tart.config
    outs = []
    for e, a in ((ex, carried), (own, tart)):
        st = tapi.init_decode_state(cfg, 2, 8, device="cpu")
        with torch.no_grad():
            outs.append(tapi.decode(a.params, cfg, st, torch.tensor([[4], [6]]),
                                    torch.tensor([0, 0]), executor=e)[0])
    assert torch.equal(outs[0], outs[1])  # the same stages, bit for bit


def test_a_plan_that_fails_to_build_raises(arts, monkeypatch):
    _, tart = arts
    art = dataclasses.replace(tart, plans={})

    def boom(specs):
        raise RuntimeError("packing failed")

    monkeypatch.setattr(tops, "pack_layer", boom)
    ex = CompressedExecutor(art, device="cpu")
    with pytest.raises(RuntimeError, match="packing failed"):
        ex.step_plan(art.config)
    assert ex.plan_fallbacks == {}  # no silent per-region fallback


def test_uncovered_sites_ride_along_as_dense_blocks():
    """An FFN-only artifact still gets a whole-step plan: attention q/k/v/o
    are baked dense into the stages."""
    jart = _compress(_cfg(), include=lambda n: n.startswith("ffn."))
    tart = artifact_from_reference(jart, "cpu")
    cfg = tart.config
    ex = CompressedExecutor(tart, device="cpu")
    st_k = tapi.init_decode_state(cfg, 2, 8, device="cpu")
    st_d = tapi.init_decode_state(cfg, 2, 8, device="cpu")
    tok, pos = torch.tensor([[3], [8]]), torch.tensor([0, 0])
    with torch.no_grad():
        lk, _ = tapi.decode(tart.params, cfg, st_k, tok, pos, executor=ex)
        ld, _ = tapi.decode(tart.params, cfg, st_d, tok, pos)
    assert ex.n_layer_plans == 1
    plan = ex.step_plan(cfg)
    assert plan.stages["qkv"].dw_mat is not None and plan.stages["qkv"].gidx is None
    np.testing.assert_allclose(_np(lk), _np(ld), rtol=0, atol=DECODE_TOL)
    assert ex.routed == ex.sites == set(tart.records)
