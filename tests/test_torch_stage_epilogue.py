"""The stage epilogue's two output modes (K6's gated and combining modes,
which take the place of K7's SwiGLU and K8's combine kernels), against the
JAX package on the CPU.

The plans are packed from the artifacts that the JAX package's real
compressor makes of reduced olmo-1b and mixtral-8x22b, as in
``tests/test_torch_plan.py`` and ``tests/test_torch_moe_plan.py``.

* Gated: ``stage_matmul_plain(gated=True)`` is ``F.silu(out[:n]) * out[n:]``
  of the plain stage bit for bit, and within 2e-5 * max(1, max|plain|) of
  the reference's ``stage_matmul`` (interpret mode) followed by
  ``jax.nn.silu(y[:n]) * y[n:]``.
* Combining: ``stage_matmul_plain(combine=...)`` is ``moe_combine_plain``
  after the plain stage bit for bit, with a dropped choice and empty slots;
  the MoE step through it is within 1e-4 of the reference's
  ``step_plan_matmul(moe=...)`` with capacity drops.
* ``chip_smoke.ordered_stage_plain`` (what the card's results are held to
  bit for bit) is within 1e-6 of the plain version in both modes.
* The refusals raise on the CPU too.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.kernels import layer_plan as jlp
from repro.models import api as japi
from repro.models.layers import _rope_sincos as j_rope_sincos
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import artifact_from_reference
from repro_torch.kernels import dispatch
from repro_torch.kernels.layer_plan import (_stage_input, _stage_mode,
                                            device_stage, stage_matmul,
                                            stage_matmul_plain,
                                            step_plan_matmul_plain)
from repro_torch.kernels.moe_route import moe_combine_plain
from repro_torch.serving.executor import CompressedExecutor

ROOT = Path(__file__).resolve().parents[1]
SUM_TOL = 2e-5  # one stage in float32, sums in another order
STEP_TOL = 1e-4  # the whole step: routing, two expert stages, the combine
ORDER_TOL = 1e-6  # the kernels' order against PyTorch's, one stage
SM = 132  # H100 SXM


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _olmo_cfg():
    return jreduced(jget_arch("olmo-1b"), d_model=32, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=48, vocab=64, n_layers=2)


def _mixtral_cfg():
    return jreduced(jget_arch("mixtral-8x22b"), d_model=32, n_heads=4,
                    n_kv_heads=2, head_dim=16, vocab=64, n_layers=2,
                    moe=jget_arch("mixtral-8x22b").moe.__class__(
                        n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=1.25))


@pytest.fixture(scope="module")
def plans():
    """arch -> (reference plan, port plan packed by the port from the
    carried artifact), both from the reference's compressor."""
    out = {}
    for arch, cfg in (("olmo", _olmo_cfg()), ("mixtral", _mixtral_cfg())):
        params = japi.init_params(jax.random.PRNGKey(0), cfg)
        jart = japi.compress_model(params, cfg, jcore.CompressionConfig(
            algorithm="fp", max_share_rel_err=0.06))
        tart = dataclasses.replace(artifact_from_reference(jart, "cpu"),
                                   plans={})
        out[arch] = (JExecutor(jart, interpret=True).step_plan(jart.config),
                     CompressedExecutor(tart, device="cpu").step_plan(
                         tart.config), tart.config)
    return out


# (arch, stage) launched in the gated mode on the plan route
GATED = [("olmo", "gu"), ("mixtral", "eg")]


def _src(ps, b, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((ps.d_src, b))
                            .astype(np.float32))


def _combine_args(ps, cfg, cs, seed=5):
    """mixtral ed at 8 tokens, cap 4: x, slot, wgt with token 1's last
    choice dropped and empty slots (chip_smoke.combine_inputs)."""
    n_exp, k = cfg.moe.n_experts, cfg.moe.top_k
    return cs.combine_inputs(ps.out_dim // n_exp, 8, k, n_exp, 4, seed, "cpu")


@pytest.mark.parametrize("arch,name", GATED)
@pytest.mark.parametrize("b", [8, 3])
def test_gated_plain_is_silu_of_the_halves(plans, arch, name, b):
    ps = plans[arch][1].stages[name]
    n = ps.out_dim // 2
    for layer in range(ps.n_layers):
        src = _src(ps, b, layer)
        out = stage_matmul_plain(ps, src, layer=layer)
        got = stage_matmul_plain(ps, src, layer=layer, gated=True)
        assert got.shape == (n, b)
        assert torch.equal(got, F.silu(out[:n]) * out[n:])
        # on a CPU tensor the wrapper takes the plain version, launching nothing
        dispatch.reset_launch_count()
        assert torch.equal(stage_matmul(ps, src, layer=layer, gated=True), got)
        assert dispatch.launch_count() == 0


@pytest.mark.parametrize("arch,name", GATED)
def test_gated_matches_the_reference_stage_and_silu(plans, arch, name):
    jplan, tplan, _ = plans[arch]
    jps, ps = jplan.stages[name], tplan.stages[name]
    n = ps.out_dim // 2
    rng = np.random.default_rng(11)
    src = rng.standard_normal((ps.n_layers, ps.d_src, 8)).astype(np.float32)
    y = jlp.stage_matmul(jps, jnp.asarray(src), interpret=True)
    for layer in range(ps.n_layers):
        want = np.asarray(jax.nn.silu(y[layer, :n]) * y[layer, n:])
        got = stage_matmul_plain(ps, torch.from_numpy(src[layer]), layer=layer,
                                 gated=True).numpy()
        np.testing.assert_allclose(
            got, want, rtol=0, atol=SUM_TOL * max(1.0, float(np.abs(got).max())))


def test_combine_plain_is_the_combine_after_the_stage(plans):
    cs = _chip_smoke()
    _, tplan, cfg = plans["mixtral"]
    ps = tplan.stages["ed"]
    n_exp = cfg.moe.n_experts
    x, slot, wgt = _combine_args(ps, cfg, cs)
    assert int((slot == n_exp * 4).sum()) >= 1  # a dropped choice
    kept = slot[slot < n_exp * 4]
    assert kept.unique().numel() == kept.numel() < n_exp * 4  # empty slots
    for layer in range(ps.n_layers):
        src = _src(ps, 4, layer)
        ob = stage_matmul_plain(ps, src, layer=layer)
        got = stage_matmul_plain(ps, src, layer=layer, combine=(x, slot, wgt))
        assert got.shape == x.shape
        assert torch.equal(got, moe_combine_plain(x, ob, slot, wgt, n_exp, 4))
        assert torch.equal(stage_matmul(ps, src, layer=layer,
                                        combine=(x, slot, wgt)), got)


def test_moe_step_through_the_modes_matches_the_reference(plans):
    """The MoE step's plain version, whose FFN is stage eg gated and stage
    ed combining, against the reference's step with capacity drops."""
    jplan, tplan, cfg = plans["mixtral"]
    n_l, d, nkv, hd = cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd
    b, smax = 8, 8
    rng = np.random.default_rng(21)
    x0 = rng.standard_normal((d, b)).astype(np.float32)
    pos = np.array([5, -1, 12, 3, 7, 0, 9, 2], np.int32)  # row 1 is idle
    kpos = rng.integers(-1, 14, (n_l, b, smax)).astype(np.int32)
    kc = rng.standard_normal((n_l, b, smax, nkv, hd)).astype(np.float32)
    vc = rng.standard_normal((n_l, b, smax, nkv, hd)).astype(np.float32)
    ln1 = (1.0 + 0.1 * rng.standard_normal((n_l, d))).astype(np.float32)
    ln2 = (1.0 + 0.1 * rng.standard_normal((n_l, d))).astype(np.float32)
    sin, cos = (np.array(a) for a in j_rope_sincos(jnp.asarray(pos), hd,
                                                      cfg.rope_theta))
    jmoe = dict(jplan.moe, capacity_factor=0.5)  # capacity 4: drops occur
    common = dict(n_heads=cfg.n_heads, n_kv_heads=nkv, head_dim=hd,
                  d_ff=cfg.d_ff, norm="rms", rope=True, window=None)
    want = jlp.step_plan_matmul(
        jplan.stages, **common, x0=jnp.asarray(x0), pos=jnp.asarray(pos),
        cos=jnp.asarray(cos), sin=jnp.asarray(sin), ln1=ln1, ln2=ln2,
        kc=jnp.asarray(kc), vc=jnp.asarray(vc), kpos=jnp.asarray(kpos),
        moe=jmoe, interpret=True)
    t = torch.from_numpy
    dropped = torch.zeros(1, dtype=torch.int32)
    got = step_plan_matmul_plain(
        tplan.stages, **common, x0=t(x0), pos=t(pos), cos=t(cos), sin=t(sin),
        ln1=t(ln1), ln2=t(ln2), kc=t(kc), vc=t(vc), kpos=t(kpos),
        moe=dict(jmoe, router=t(np.array(jmoe["router"])), dropped=dropped))
    assert int(dropped) > 0
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=STEP_TOL * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("sm", [8, SM])
@pytest.mark.parametrize("arch,name", GATED + [("mixtral", "ed")])
def test_ordered_reference_in_each_mode_matches_plain(plans, arch, name, sm):
    cs = _chip_smoke()
    _, tplan, cfg = plans[arch]
    ps = tplan.stages[name]
    b = 4 if name == "ed" else 8
    kw = ({"gated": True} if name != "ed"
          else {"combine": _combine_args(ps, cfg, cs)})
    for layer in range(ps.n_layers):
        src = _src(ps, b, 100 + layer)
        got = cs.ordered_stage_plain(ps, src, layer, sm, **kw)
        want = stage_matmul_plain(ps, src, layer=layer, **kw)
        assert got.shape == want.shape
        torch.testing.assert_close(
            got, want, rtol=0,
            atol=ORDER_TOL * max(1.0, float(want.abs().max())))


def test_chip_smoke_modes_match_the_wrapper(plans):
    """The shape key a mode row of chip_smoke.py is counted under is the one
    the wrapper records, and each plan-route stage's mode is the serve's."""
    cs = _chip_smoke()
    _, oplan, ocfg = plans["olmo"]
    _, mplan, mcfg = plans["mixtral"]
    cases = [(oplan.stages["gu"], 8, cs.serve_mode(ocfg, "gu")),
             (mplan.stages["eg"], 4, cs.serve_mode(mcfg, "eg")),
             (mplan.stages["ed"], 4, cs.serve_mode(mcfg, "ed"))]
    assert [m if isinstance(m, str) else m[0] for _, _, m in cases] == [
        "gated", "gather", "combine"]
    assert cases[1][2][-1] == "gated"  # mixtral's eg: gathered and gated
    assert cs.serve_mode(ocfg, "dn") is None and cs.serve_mode(mcfg, "a") == "gated"
    # K9's stage A is gated only and its stage B plain: its caller
    # dispatches and combines, as in the reference
    deepseek = cs.get_arch("deepseek-v2-lite-16b")
    assert cs.serve_mode(deepseek, "ed") is None
    assert cs.serve_mode(deepseek, "eg") == "gated"
    for ps, b, mode in cases:
        kw, key_mode = cs.mode_kwargs(ps, b, mode, "cpu")
        gather = kw.get("gather")
        want = _stage_mode(ps, 0, None, kw.get("gated", False),
                           kw.get("combine"))
        if gather is not None:
            cap, gmode = _stage_input(ps, None, 0, None, gather, None)
            assert cap == b
            want = gmode + want
        assert want == key_mode
        assert cs.mode_row(key_mode) in cs.KERNELS
        assert cs.KERNELS[cs.mode_row(key_mode)]["source"].endswith(
            "csrc/stage_matmul.cu")
        bytes_, flops = cs.mode_cost(device_stage(ps, "cpu"), 0, b, kw)
        assert bytes_ > 0 and flops > 0


@pytest.mark.parametrize("case", [
    "odd width", "resid with gated", "resid with combine", "both modes",
    "mode without layer", "slot rows", "wgt shape", "x width"])
def test_modes_refuse_what_they_cannot_express(plans, case):
    cs = _chip_smoke()
    _, tplan, cfg = plans["mixtral"]
    gu, ed = tplan.stages["eg"], tplan.stages["ed"]
    x, slot, wgt = _combine_args(ed, cfg, cs)
    src_gu, src_ed = _src(gu, 4, 1), _src(ed, 4, 2)
    # 4094 rows of the last level, two a output: 2047 outputs
    odd = cs.handbuilt_stage(np.random.default_rng(0), p=2, r=4094, group=2047)
    assert odd.out_dim % 2
    calls = {
        "odd width": lambda f: f(odd, _src(odd, 4, 3), layer=0, gated=True),
        "resid with gated": lambda f: f(gu, src_gu, layer=0, gated=True,
                                        resid=torch.zeros(gu.out_dim, 4)),
        "resid with combine": lambda f: f(ed, src_ed, layer=0,
                                          combine=(x, slot, wgt),
                                          resid=torch.zeros(ed.out_dim, 4)),
        "both modes": lambda f: f(ed, src_ed, layer=0, gated=True,
                                  combine=(x, slot, wgt)),
        "mode without layer": lambda f: f(gu, src_gu[None].repeat(
            gu.n_layers, 1, 1), gated=True),
        "slot rows": lambda f: f(ed, src_ed, layer=0,
                                 combine=(x, slot[:-1], wgt[:-1])),
        "wgt shape": lambda f: f(ed, src_ed, layer=0,
                                 combine=(x, slot, wgt[:, :1])),
        "x width": lambda f: f(ed, src_ed, layer=0,
                               combine=(x[:-1], slot, wgt)),
    }
    for fn in (stage_matmul, stage_matmul_plain):
        with pytest.raises(ValueError):
            calls[case](fn)
