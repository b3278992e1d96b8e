"""The MoE FFN of the port (``repro_torch.models.moe.moe_ffn``) against
``repro.models.moe.moe_ffn`` at reduced mixtral-8x22b widths, the router's
float32 through conversion, shared experts and MLA against the reference,
the manual expert-parallel MoE without a mesh (``moe_ffn``) and refused
under the train step's mesh, the router's load-balance loss, the
configuration and the seeded MoE fixture.

The same numpy parameters and activations go through both functions.  The
routing must be the same — the experts chosen (``sel``), their order, and
which (token, choice) assignments keep a capacity slot (``keep``, re-derived
for the reference from its ``sel`` by the reference's rank rule) — and
``y`` agrees within 1e-5 * max(1, max|y|) in float32 (the same products in
another summation order).  In bfloat16 (activations and experts; the router
stays float32) the routing is still identical and ``y`` agrees within
2^-7 * max|y|: one bfloat16 rounding of each expert output and of the
combine, where XLA and PyTorch may round at other points."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import MLASpec as JMLASpec
from repro.configs.base import arch_to_dict as jarch_to_dict
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models.moe import moe_ffn as jmoe_ffn

from repro_torch.configs import arch_to_dict, get_arch, reduced_config
from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.moe_route import capacity
from repro_torch.models import api as tapi
from repro_torch.models.moe import moe_ffn
from repro_torch.serving.executor import CompressedExecutor
from repro_torch.testing import _seeded_chains, moe_sites, seeded_artifact

TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _params(rng, d, n_exp, dff, dtype=np.float32):
    def tn(shape, scale):
        return (np.clip(rng.standard_normal(shape), -2, 2) * scale).astype(np.float32)
    return {"router": tn((d, n_exp), d ** -0.5),
            "gate": tn((n_exp, d, dff), d ** -0.5).astype(dtype),
            "up": tn((n_exp, d, dff), d ** -0.5).astype(dtype),
            "down": tn((n_exp, dff, d), dff ** -0.5).astype(dtype)}


def _reference_keep(sel: np.ndarray, n_exp: int, cap: int) -> np.ndarray:
    """The reference's rule, in numpy: the rank of an assignment is the
    number of earlier ones (token-major, choice-minor) to the same expert."""
    counts = np.zeros(n_exp, np.int64)
    keep = np.zeros(sel.shape, bool)
    for t in range(sel.shape[0]):
        for j in range(sel.shape[1]):
            keep[t, j] = counts[sel[t, j]] < cap
            counts[sel[t, j]] += 1
    return keep


@pytest.mark.parametrize("case", ["no_drops", "drops", "tie", "bf16"])
def test_moe_ffn_routes_and_computes_as_the_reference(case):
    rng = np.random.default_rng(["no_drops", "drops", "tie", "bf16"].index(case))
    d, n_exp, dff, k = 32, 4, 16, 2
    b, s = 2, 16
    cf = {"no_drops": 8.0, "drops": 0.5, "tie": 1.25, "bf16": 1.25}[case]
    bf16 = case == "bf16"
    p = _params(rng, d, n_exp, dff)
    if case == "tie":  # two experts with the same router column
        p["router"][:, 3] = p["router"][:, 1]
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(n_experts=n_exp, top_k=k, capacity_factor=cf, norm_topk=True)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jp = {n: jnp.asarray(v, jnp.float32 if n == "router" else jdt)
          for n, v in p.items()}
    tp = {n: torch.from_numpy(v).to(torch.float32 if n == "router" else tdt)
          for n, v in p.items()}
    jy, jaux = jmoe_ffn(jp, jnp.asarray(x, jdt), **kw)
    ty, taux = moe_ffn(tp, torch.from_numpy(x).to(tdt), **kw)
    cap = capacity(b * s, k, cf, n_exp)
    jsel = np.asarray(jaux["sel"])
    np.testing.assert_array_equal(taux["sel"].numpy(), jsel)
    np.testing.assert_array_equal(taux["keep"].numpy(),
                                  _reference_keep(jsel, n_exp, cap))
    assert float(taux["dropped_frac"]) == pytest.approx(
        float(jaux["dropped_frac"]), abs=1e-7)
    n_drop = int((~taux["keep"]).sum())
    if case == "drops":
        assert n_drop > 0
    if case == "no_drops":
        assert n_drop == 0
    if case == "tie":  # where both tied experts are chosen, 1 comes before 3
        both = (jsel == 1).any(-1) & (jsel == 3).any(-1)
        assert both.any()
        assert (jsel[both] == [1, 3]).all()
    assert ty.dtype == tdt
    want = np.asarray(jnp.asarray(jy, jnp.float32))
    got = _np(ty)
    tol = BF16_TOL * float(np.abs(want).max()) if bf16 else \
        TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_capacity_rounds_half_to_even_as_the_host_does():
    # B = 8, k = 2, cf 1.25, E = 8: round(2.5) == 2, so min_capacity wins
    assert capacity(8, 2, 1.25, 8) == 4
    assert capacity(24, 2, 1.25, 8) == 8  # round(7.5) == 8
    assert capacity(20, 2, 1.25, 8) == 6  # round(6.25) == 6
    assert capacity(12, 2, 1.0, 8, min_capacity=1) == 3


def test_mixtral_config_agrees_with_the_reference():
    for red in (False, True):
        j, t = jget_arch("mixtral-8x22b"), get_arch("mixtral-8x22b")
        if red:
            j, t = jreduced(j, vocab=256), reduced_config(t, vocab=256)
        assert jarch_to_dict(j) == arch_to_dict(t)
        assert config_from_reference(j) == t
    cfg = get_arch("mixtral-8x22b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab,
            cfg.attn_window, cfg.rope_theta) == (6144, 48, 8, 128, 32768,
                                                 4096, 10000.0)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert) == (8, 2, 16384)
    assert not cfg.tie_embeddings and cfg.moe.n_shared == 0


def test_bf16_config_keeps_the_converted_router_float32():
    jcfg = jreduced(jget_arch("mixtral-8x22b"), vocab=64, param_dtype="bfloat16",
                    compute_dtype="bfloat16")
    tcfg = config_from_reference(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(1), jcfg)
    assert jparams["blocks"]["ffn"]["router"].dtype == jnp.float32
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    ffn = tparams["blocks"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["gate"].dtype == torch.bfloat16
    assert tparams["blocks"]["attn"]["q"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ffn["router"].numpy(),
                                  np.asarray(jparams["blocks"]["ffn"]["router"]))
    # one layer's FFN on the same bf16 activations: the same routing
    x = np.random.default_rng(0).standard_normal((2, 8, jcfg.d_model))
    kw = dict(n_experts=jcfg.moe.n_experts, top_k=jcfg.moe.top_k,
              capacity_factor=jcfg.moe.capacity_factor)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ffn"])
    _, jaux = jmoe_ffn(jp, jnp.asarray(x, jnp.bfloat16), **kw)
    _, taux = moe_ffn({n: v[0] for n, v in ffn.items()},
                      torch.from_numpy(x).to(torch.bfloat16), **kw)
    np.testing.assert_array_equal(taux["sel"].numpy(), np.asarray(jaux["sel"]))


def test_prefill_logits_equal_the_reference():
    jcfg = jreduced(jget_arch("mixtral-8x22b"), vocab=64, d_model=32,
                    n_heads=4, head_dim=8)
    tcfg = config_from_reference(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    toks = np.random.default_rng(3).integers(0, 64, (2, 12)).astype(np.int32)
    jh, _ = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        th, _ = tapi.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=0, atol=1e-4)


@pytest.mark.parametrize("what", ["moe_manual"])
def test_deepseek_features_are_refused(what):
    """The manual expert-parallel MoE (``moe_manual``): without a mesh it is
    ``moe_ffn`` (prefill and decode bit for bit the config without it);
    under the train step's mesh it stays refused, naming ROADMAP A7c (its
    backward needs a differentiable all-reduce)."""
    from types import SimpleNamespace

    from repro_torch.optim.optimizers import prox_sgd
    from repro_torch.training.trainer import make_train_step

    base = reduced_config(get_arch("mixtral-8x22b"), vocab=64)
    cfg = {"moe_manual": replace(base, moe_manual=True)}[what]
    params = tapi.init_params(0, base, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 6)))
    with torch.no_grad():
        outs = [tapi.prefill(params, c, {"tokens": toks}, collect_cache=True)
                for c in (base, cfg)]
        steps = []
        for c in (base, cfg):
            st = tapi.init_decode_state(c, 2, 8, device="cpu")
            steps.append(tapi.decode(params, c, st, toks[:, :1],
                                     torch.tensor([0, -1]))[0])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(steps[0], steps[1])
    mesh = SimpleNamespace(shape={"data": 1, "model": 1})
    with pytest.raises(NotImplementedError, match="A7c"):
        make_train_step(cfg, prox_sgd(0.9), mesh=mesh)


def test_router_aux_losses_match_the_reference():
    from repro.models.moe import router_aux_losses as jrouter_aux_losses

    from repro_torch.models.moe import router_aux_losses

    rng = np.random.default_rng(7)
    d, n_exp, dff = 32, 4, 16
    p = _params(rng, d, n_exp, dff)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    kw = dict(n_experts=n_exp, top_k=2, capacity_factor=0.5)
    _, jaux = jmoe_ffn({n: jnp.asarray(v) for n, v in p.items()},
                       jnp.asarray(x), **kw)
    _, taux = moe_ffn({n: torch.from_numpy(v) for n, v in p.items()},
                      torch.from_numpy(x), **kw)
    want = jrouter_aux_losses(jaux, n_exp)
    got = router_aux_losses(taux, n_exp)
    assert set(got) == set(want) == {"load_balance", "dropped_frac"}
    assert float(got["dropped_frac"]) > 0
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6)


@pytest.mark.parametrize("what", ["shared_experts", "mla"])
def test_deepseek_features_match_the_reference(what):
    """Shared experts and MLA attention — once refused — on reduced
    mixtral widths: prefill hidden states and caches, and two decode steps'
    logits, equal the JAX package's within 1e-4."""
    jcfg = jreduced(jget_arch("mixtral-8x22b"), vocab=64, d_model=32,
                    n_heads=4, head_dim=8)
    if what == "shared_experts":
        jcfg = replace(jcfg, moe=replace(jcfg.moe, n_shared=1))
    else:
        jcfg = replace(jcfg, n_kv_heads=4, attn_window=None,
                       mla=JMLASpec(kv_lora=16, qk_nope=8, qk_rope=8, v_dim=8))
    tcfg = config_from_reference(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    assert ("shared" in tparams["blocks"]["ffn"]) == (what == "shared_experts")
    assert ("dkv" in tparams["blocks"]["attn"]) == (what == "mla")
    toks = np.random.default_rng(6).integers(0, 64, (2, 10)).astype(np.int32)
    jh, jc = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                          collect_cache=True)
    with torch.no_grad():
        th, tc = tapi.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                              collect_cache=True)
    for got, want in ((th, jh), *zip(tc, jc)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4)
    js = japi.init_decode_state(jcfg, 2, 8)
    ts = tapi.init_decode_state(tcfg, 2, 8, device="cpu")
    for t, pos in enumerate(([0, 0], [1, -1])):
        tok = toks[:, t:t + 1]
        lj, js = japi.decode(jparams, jcfg, js, jnp.asarray(tok),
                             jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            lt, ts = tapi.decode(tparams, tcfg, ts, torch.from_numpy(tok),
                                 torch.tensor(pos))
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=1e-4)


def test_seeded_chains_share_memory_and_pack_bitwise():
    for n, k in ((64, 30), (96, 200), (200, 50)):
        dec, pk = _seeded_chains(n, k, np.random.default_rng(n + k))
        ref = tops.pack_decomposition(dec)
        for f in ("idx", "exp", "sign"):
            np.testing.assert_array_equal(getattr(pk, f), getattr(ref, f))
            assert getattr(pk, f).dtype == getattr(ref, f).dtype
        assert (pk.col_slices, pk.d_pad, pk.first_width, pk.chain_lengths) == \
            (ref.col_slices, ref.d_pad, ref.first_width, ref.chain_lengths)
        if n in (64, 96):  # no row padding: the factors are views of pk
            assert np.shares_memory(dec.slices[0].factors[1].idx, pk.idx)


def test_seeded_moe_fixture_kernel_routes_equal_dense():
    cfg = reduced_config(get_arch("mixtral-8x22b"), vocab=256)
    art = seeded_artifact(cfg, seed=5, device="cpu", host_effective=False)
    again = seeded_artifact(cfg, seed=5, device="cpu")
    n_exp = cfg.moe.n_experts
    assert len(art.records) == cfg.n_layers * (4 + 3 * n_exp) == len(art.packed)
    ffn = art.params["blocks"]["ffn"]
    assert ffn["router"].shape == (cfg.n_layers, cfg.d_model, n_exp)
    for prefix, proj, n, k in moe_sites(cfg):
        assert ffn[proj].shape == (cfg.n_layers, n_exp, k, n)
    for name, rec in art.records.items():
        assert rec.effective is None and again.records[name].effective is not None
        assert (rec.shared is not None) == name.startswith(
            ("attn.k", "attn.o", "moe.up"))
        np.testing.assert_array_equal(art.packed[name].idx, again.packed[name].idx)
    for name in ffn:  # the same seed, the same artifact
        assert torch.equal(ffn[name], again.params["blocks"]["ffn"][name])
    tok, pos = torch.tensor([[9], [100], [7]]), torch.tensor([0, 0, -1])
    out = {}
    for route, ex in (("plan", CompressedExecutor(art, device="cpu")),
                      ("per_region", CompressedExecutor(art, use_plans=False,
                                                        device="cpu")),
                      ("dense", None)):
        st = tapi.init_decode_state(cfg, 3, 8, device="cpu")
        dispatch.reset_launch_count()
        with torch.no_grad():
            out[route], _ = tapi.decode(art.params, cfg, st, tok, pos,
                                        executor=ex)
        assert dispatch.launch_count() == 0  # CPU tensors: plain versions
        if ex is not None:
            assert ex.routed == ex.sites == set(art.records)
            assert ex.n_layer_plans == int(route == "plan")
    assert torch.isfinite(out["dense"]).all() and float(out["dense"].std()) > 0.05
    for route in ("plan", "per_region"):
        torch.testing.assert_close(out[route], out["dense"], rtol=0, atol=1e-4)
