"""K9 — ``moe_plan_matmul``, one MoE layer's experts as stage A, SwiGLU,
stage B — against ``repro.kernels.layer_plan.moe_plan_matmul`` in interpret
mode, at reduced deepseek-v2-lite widths.

Artifacts from the JAX package's real compressor are carried across, one
without weight sharing and one with every site weight-shared (12 clusters,
so the stages' prep pairs merge inputs).  The port's :class:`MoEPlan`
packs stages A and B bitwise as the reference's ``MoEPlan`` does, from the
carried records alone.  ``moe_plan_matmul``'s plain version (what the
wrapper runs for CPU tensors) agrees with the reference kernel on the
stages the reference packed within 2e-5 * max(1, max|ref|): float32, the
same terms summed in other orders through two stages and the SwiGLU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import MoESpec as JMoESpec
from repro.configs.base import reduced_config as jreduced
from repro.kernels import layer_plan as jlp
from repro.models import api as japi
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import artifact_from_reference, stage_from_reference
from repro_torch.kernels import dispatch
from repro_torch.kernels.layer_plan import (moe_plan_matmul,
                                            moe_plan_matmul_plain)
from repro_torch.serving.executor import CompressedExecutor

TOL = 2e-5
E, D, DFF = 4, 32, 16
_STAGE_FIELDS = ("prep_src", "prep_tgt", "gidx", "gexp", "gsgn", "outg",
                 "fs_mat", "dw_mat", "bias", "segs")


@pytest.fixture(scope="module", params=["unshared", "shared"])
def plans(request):
    """(reference MoEPlan of layer 0, the port's, packed from the carried
    artifact without the reference's stages)."""
    cfg = jreduced(jget_arch("deepseek-v2-lite-16b"), d_model=D, n_heads=2,
                   n_kv_heads=2, vocab=64, n_layers=1,
                   moe=JMoESpec(n_experts=E, top_k=2, d_ff_expert=DFF,
                                n_shared=1, capacity_factor=1.25))
    params = japi.init_params(jax.random.PRNGKey(7), cfg)
    cc = (jcore.CompressionConfig(algorithm="fp", share_clusters=12)
          if request.param == "shared"
          else jcore.CompressionConfig(algorithm="fp", max_share_rel_err=0.06))
    jart = japi.compress_model(params, cfg, cc)
    shared = [n for n, r in jart.records.items() if r.shared is not None]
    assert bool(shared) == (request.param == "shared")
    kw = dict(n_experts=E, d_model=D, d_ff=DFF)
    jplan = JExecutor(jart, interpret=True).moe_plan("l0", **kw)
    tart = dataclasses.replace(artifact_from_reference(jart, "cpu"), plans={})
    tplan = CompressedExecutor(tart, device="cpu").moe_plan("l0", **kw)
    return jplan, tplan


def test_stages_pack_bitwise_as_the_reference(plans):
    jplan, tplan = plans
    assert set(tplan.stages) == set(jplan.stages) == {"a", "b"}
    for name, jps in jplan.stages.items():
        tps = tplan.stages[name]
        for f in _STAGE_FIELDS:
            a, b = getattr(tps, f), getattr(jps, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b),
                                              err_msg=f"{name}.{f}")
                assert a.dtype == np.asarray(b).dtype
        assert (tps.k_alloc, tps.d_src, tps.out_dim, tps.n_layers,
                tps.site_names) == (jps.k_alloc, jps.d_src, jps.out_dim,
                                    jps.n_layers, tuple(jps.site_names))
    assert (tplan.stages["a"].d_src, tplan.stages["a"].out_dim,
            tplan.stages["b"].out_dim) == (E * D, 2 * E * DFF, E * D)
    assert tplan.d_ff_total == jplan.d_ff_total == E * DFF
    assert tplan.covered == jplan.covered


@pytest.mark.parametrize("c", [4, 7])
def test_moe_plan_plain_matches_reference_kernel(plans, c):
    jplan, _ = plans
    sa, sb = jplan.stages["a"], jplan.stages["b"]
    src = np.random.default_rng(c).standard_normal((E * D, c)).astype(np.float32)
    want = np.asarray(jlp.moe_plan_matmul(sa, sb, d_ff_total=E * DFF,
                                          src=jnp.asarray(src), interpret=True))
    ta, tb = stage_from_reference(sa), stage_from_reference(sb)
    dispatch.reset_launch_count()
    got = moe_plan_matmul(ta, tb, d_ff_total=E * DFF, src=torch.from_numpy(src))
    assert dispatch.launch_count() == 0  # a CPU tensor: the plain version
    plain = moe_plan_matmul_plain(ta, tb, d_ff_total=E * DFF,
                                  src=torch.from_numpy(src))
    assert torch.equal(got, plain)
    got = got.numpy()
    assert got.shape == want.shape == (E * D, c) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def test_plan_call_equals_the_grouped_expert_route(plans):
    """The plan on a dispatched buffer == the three grouped per-region
    launches of the same experts (the route it replaces)."""
    _, tplan = plans
    ex = tplan.executor
    buf = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (E, 4, D)).astype(np.float32))
    out = tplan(buf)

    def grouped(proj, z):
        g = ex.grouped(tuple(f"moe.{proj}.l0.e{e}" for e in range(E)))
        return torch.stack([y.T for y in g([z[e].T for e in range(E)])])
    h = torch.nn.functional.silu(grouped("gate", buf)) * grouped("up", buf)
    want = grouped("down", h)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=TOL * max(1.0, float(want.abs().max())))


def test_mismatched_stages_raise(plans):
    _, tplan = plans
    sa, sb = tplan.stages["a"], tplan.stages["b"]
    src = torch.zeros((E * D, 4))
    with pytest.raises(ValueError, match="stage A emits"):
        moe_plan_matmul(sb, sa, d_ff_total=E * DFF, src=src)
    with pytest.raises(ValueError, match="one layer"):
        moe_plan_matmul(dataclasses.replace(sa, n_layers=2), sb,
                        d_ff_total=E * DFF, src=src)
