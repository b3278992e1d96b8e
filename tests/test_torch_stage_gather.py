"""The stage's gathered-input mode (K6 reading the MoE dispatch, K8's, where
it stands), against the JAX package on the CPU.

The plan is packed from the artifact that the JAX package's real compressor
makes of reduced mixtral-8x22b, as in ``tests/test_torch_stage_epilogue.py``;
beside it, its ``eg`` stage with a live dw block in one layer and
``chip_smoke.handbuilt_stage`` with nonzero fs/dw/bias (300 inputs as 4
experts of 75).  The routes come from ``chip_smoke.gather_inputs``: a
dropped choice, empty slots and a -0.0 in a routed token's column.

* ``stage_matmul_plain(None, gather=(h2, slot, src_tok))`` is
  ``moe_dispatch_plain`` followed by the plain stage, bit for bit, in the
  plain and the gated mode, and the wrapper on CPU tensors launches nothing.
* Gathered and gated is within 2e-5 * max(1, max|plain|) of the reference's
  ``buf`` dispatch (``repro.kernels.layer_plan``, lines 350-354), its
  ``stage_matmul`` in interpret mode and ``jax.nn.silu``.
* ``chip_smoke.ordered_gather`` (what the kernel reads through ``src_tok``)
  is the scatter-add's input on routes with capacity drops, and
  ``chip_smoke.ordered_stage_plain`` in the gathered mode is within 1e-6 of
  the plain version.
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

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.kernels import layer_plan as jlp
from repro.models import api as japi
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import artifact_from_reference
from repro_torch.kernels import dispatch
from repro_torch.kernels.layer_plan import stage_matmul, stage_matmul_plain
from repro_torch.kernels.moe_route import moe_dispatch_plain, moe_route_plain
from repro_torch.serving.executor import CompressedExecutor

ROOT = Path(__file__).resolve().parents[1]
SUM_TOL = 2e-5  # one stage in float32, sums in another order
ORDER_TOL = 1e-6  # the kernels' order against PyTorch's, one stage
SM = 132  # H100 SXM
T, K = 8, 2  # tokens, top-k


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mixtral_cfg():
    return jreduced(jget_arch("mixtral-8x22b"), d_model=32, n_heads=4,
                    n_kv_heads=2, head_dim=16, vocab=64, n_layers=2,
                    moe=jget_arch("mixtral-8x22b").moe.__class__(
                        n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=1.25))


@pytest.fixture(scope="module")
def cs():
    return _chip_smoke()


@pytest.fixture(scope="module")
def mixtral():
    """(reference eg, port eg packed by the port, config)."""
    cfg = _mixtral_cfg()
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    jart = japi.compress_model(params, cfg, jcore.CompressionConfig(
        algorithm="fp", max_share_rel_err=0.06))
    tart = dataclasses.replace(artifact_from_reference(jart, "cpu"), plans={})
    jplan = JExecutor(jart, interpret=True).step_plan(jart.config)
    tplan = CompressedExecutor(tart, device="cpu").step_plan(tart.config)
    return jplan.stages["eg"], tplan.stages["eg"], tart.config


@pytest.fixture(scope="module")
def stages(mixtral, cs):
    """name -> (stage, experts E): mixtral's eg, the same with a live dw
    block in layer 1 only, and the hand-built stage with fs/dw/bias."""
    _, eg, cfg = mixtral
    rng = np.random.default_rng(3)
    dw = np.zeros((eg.n_layers, eg.out_dim, eg.d_src), np.float32)
    dw[1] = rng.integers(-4, 5, dw.shape[1:]) / 8
    n_exp = cfg.moe.n_experts
    return {"mixtral eg": (eg, n_exp),
            "mixtral eg dw in layer 1": (dataclasses.replace(eg, dw_mat=dw),
                                         n_exp),
            "hand fs+dw+bias": (cs.handbuilt_stage(rng, p=3, dense=True), 4)}


def _gather(cs, ps, n_exp, cap=4, seed=5):
    return cs.gather_inputs(ps.d_src // n_exp, T, K, n_exp, cap, seed, "cpu")


def test_gather_inputs_hold_the_cases(cs, stages):
    """A dropped choice, empty slots, kept slots unique and each slot's
    token the one routed to it, and a -0.0 that reaches the stage."""
    ps, n_exp = stages["mixtral eg"]
    h2, slot, src_tok = _gather(cs, ps, n_exp)
    cap = src_tok.numel() // n_exp
    s = slot.long()
    kept = s < n_exp * cap
    assert int((~kept).sum()) >= 1  # a dropped choice
    assert s[kept].unique().numel() == int(kept.sum())
    assert int((src_tok < 0).sum()) >= 1  # empty slots
    tok = torch.arange(T)[:, None].expand_as(s)
    assert torch.equal(src_tok[s[kept]].long(), tok[kept])
    assert torch.signbit(h2[0, 0]) and h2[0, 0] == 0
    assert int((src_tok == 0).sum()) >= 1  # token 0 is routed


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("name", ["mixtral eg", "mixtral eg dw in layer 1",
                                  "hand fs+dw+bias"])
def test_gathered_plain_is_the_dispatch_then_the_stage(cs, stages, name,
                                                       gated):
    ps, n_exp = stages[name]
    for layer in range(ps.n_layers):
        h2, slot, src_tok = _gather(cs, ps, n_exp, seed=10 + layer)
        cap = src_tok.numel() // n_exp
        src = moe_dispatch_plain(h2, slot, src_tok, n_exp, cap)
        want = stage_matmul_plain(ps, src, layer=layer, gated=gated)
        got = stage_matmul_plain(ps, None, layer=layer, gated=gated,
                                 gather=(h2, slot, src_tok))
        assert got.shape == want.shape == (
            ps.out_dim // 2 if gated else ps.out_dim, cap)
        assert torch.equal(got, want)
        # on a CPU tensor the wrapper takes the plain version, launching nothing
        dispatch.reset_launch_count()
        assert torch.equal(stage_matmul(ps, None, layer=layer, gated=gated,
                                        gather=(h2, slot, src_tok)), got)
        assert dispatch.launch_count() == 0


def test_live_dw_block_reads_the_gathered_input(cs, stages):
    """Layer 1's dw block adds dw @ src, src the dispatched input: the
    gathered mode with it differs from the stage without it by exactly
    that product's contribution (checked against the plain dense call)."""
    ps, n_exp = stages["mixtral eg dw in layer 1"]
    base, _ = stages["mixtral eg"]
    h2, slot, src_tok = _gather(cs, ps, n_exp)
    src = moe_dispatch_plain(h2, slot, src_tok, n_exp, 4)
    g = (h2, slot, src_tok)
    got = stage_matmul_plain(ps, None, layer=1, gather=g)
    without = stage_matmul_plain(base, None, layer=1, gather=g)
    torch.testing.assert_close(got - without,
                               torch.from_numpy(ps.dw_mat[1]) @ src,
                               rtol=0, atol=1e-5)
    assert not torch.equal(got, without)
    # layer 0's block is all zero: it adds nothing
    assert torch.equal(stage_matmul_plain(ps, None, layer=0, gather=g),
                       stage_matmul_plain(base, None, layer=0, gather=g))


def _reference_dispatch(h2, slot, n_exp, cap):
    """The reference's ``buf`` dispatch (src/repro/kernels/layer_plan.py,
    lines 350-354) in jnp: [E * d, cap]."""
    d = h2.shape[0]
    xt = jnp.asarray(h2).T
    s = jnp.asarray(slot)
    buf = jnp.zeros((n_exp * cap, d), jnp.float32)
    for j in range(s.shape[1]):
        buf = buf.at[s[:, j]].add(xt, mode="drop")
    return buf.reshape(n_exp, cap, d).transpose(0, 2, 1).reshape(n_exp * d, cap)


def test_gathered_gated_matches_the_reference(cs, mixtral):
    jps, ps, cfg = mixtral
    n_exp = cfg.moe.n_experts
    n = ps.out_dim // 2
    inputs = [_gather(cs, ps, n_exp, seed=20 + layer)
              for layer in range(ps.n_layers)]
    src = jnp.stack([_reference_dispatch(h2.numpy(), slot.numpy(), n_exp,
                                         src_tok.numel() // n_exp)
                     for h2, slot, src_tok in inputs])
    y = jlp.stage_matmul(jps, src, interpret=True)
    for layer, g in enumerate(inputs):
        want = np.asarray(jax.nn.silu(y[layer, :n]) * y[layer, n:])
        got = stage_matmul_plain(ps, None, layer=layer, gated=True,
                                 gather=g).numpy()
        np.testing.assert_allclose(
            got, want, rtol=0, atol=SUM_TOL * max(1.0, float(np.abs(got).max())))


def test_ordered_gather_is_the_dispatch_on_routes(cs, mixtral):
    """Through real routes with capacity drops (the route's plain version):
    the kernel's read through src_tok equals the reference's scatter-add in
    every value, and keeps a -0.0 that the scatter-add turns into +0.0."""
    _, ps, cfg = mixtral
    n_exp, d = cfg.moe.n_experts, cfg.d_model
    rng = np.random.default_rng(7)
    for cap in (1, 2, 4):
        h2 = torch.from_numpy(rng.standard_normal((d, T)).astype(np.float32))
        router = torch.from_numpy(
            (rng.standard_normal((d, n_exp)) / np.sqrt(d)).astype(np.float32))
        dropped = torch.zeros(1, dtype=torch.int32)
        _, _, slot, src_tok = moe_route_plain(h2, router, top_k=K, cap=cap,
                                              norm_topk=True, dropped=dropped)
        assert int(dropped) > 0 or cap == 4
        tok = int(src_tok[src_tok >= 0][0])
        h2[3, tok] = -0.0
        got = cs.ordered_gather(ps, h2, slot, src_tok)
        want = moe_dispatch_plain(h2, slot, src_tok, n_exp, cap)
        assert torch.equal(got, want)
        e = int(torch.nonzero(src_tok == tok)[0, 0]) // cap
        c = int(torch.nonzero(src_tok == tok)[0, 0]) % cap
        assert torch.signbit(got[e * d + 3, c])
        assert not torch.signbit(want[e * d + 3, c])


@pytest.mark.parametrize("sm", [8, SM])
@pytest.mark.parametrize("name,gated", [("mixtral eg", True),
                                        ("mixtral eg dw in layer 1", False),
                                        ("hand fs+dw+bias", False)])
def test_ordered_reference_in_the_gathered_mode_matches_plain(
        cs, stages, name, gated, sm):
    ps, n_exp = stages[name]
    for layer in range(ps.n_layers):
        g = _gather(cs, ps, n_exp, seed=100 + layer)
        got = cs.ordered_stage_plain(ps, None, layer, sm, gated=gated,
                                     gather=g)
        want = stage_matmul_plain(ps, None, layer=layer, gated=gated, gather=g)
        assert got.shape == want.shape
        torch.testing.assert_close(
            got, want, rtol=0,
            atol=ORDER_TOL * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("case", [
    "src_tok length", "D_src not E * d", "no layer", "resid", "src as well",
    "no input", "slot rows", "combine of other tokens"])
def test_gathered_mode_refuses_what_it_cannot_express(cs, stages, case):
    ps, n_exp = stages["mixtral eg"]
    h2, slot, src_tok = _gather(cs, ps, n_exp)
    g = (h2, slot, src_tok)
    x, cslot, cwgt = cs.combine_inputs(h2.shape[0], T + 1, K, n_exp, 4, 5,
                                       "cpu")
    calls = {
        "src_tok length": lambda f: f(ps, None, layer=0,
                                      gather=(h2, slot, src_tok[:-1])),
        "D_src not E * d": lambda f: f(ps, None, layer=0,
                                       gather=(h2[:-1], slot, src_tok)),
        "no layer": lambda f: f(ps, None, gather=g),
        "resid": lambda f: f(ps, None, layer=0, gather=g,
                             resid=torch.zeros(ps.out_dim, 4)),
        "src as well": lambda f: f(ps, torch.zeros(ps.d_src, 4), layer=0,
                                   gather=g),
        "no input": lambda f: f(ps, None, layer=0),
        "slot rows": lambda f: f(ps, None, layer=0,
                                 gather=(h2, slot[:-1], src_tok)),
        "combine of other tokens": lambda f: f(ps, None, layer=0, gather=g,
                                               combine=(x, cslot, cwgt)),
    }
    for fn in (stage_matmul, stage_matmul_plain):
        with pytest.raises(ValueError):
            calls[case](fn)
