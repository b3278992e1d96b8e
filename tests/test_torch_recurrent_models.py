"""The recurrent families on the port against the JAX package at reduced
widths: rwkv6-1.6b (ssm: d 64, 4 heads of 16, d_ff 96, vocab 64, 2 layers)
and zamba2-7b (hybrid: d 64, 4 heads of 16, d_ff 96, vocab 64, d_inner 64,
d_state 16, SSM heads of 16, period 2 over 5 layers — two insertions of the
shared block and a tail layer), parameters from the reference's
``init_params`` through ``convert.params_from_numpy``.

* configs field for field, full and reduced; the site tables letter for
  letter (names, paths, indices; the hybrid's shared block unstacked);
* ``forward`` hidden states and final states within 1e-5 of the outputs'
  scale (measured ~1e-6: float32 ``exp`` an ulp apart and other summation
  orders, see ``tests/test_torch_rwkv6.py``), ``loss_fn`` and its gradients
  within 1e-5 relative;
* ``decode_step`` (an idle slot at position -1) logits and every state
  leaf within 1e-4;
* ``api.compress_model`` on the converted parameters: records and packed
  streams bitwise the reference's; the port's per-region route (the plain
  K1/K2/K3) against its own dense-effective decode within 1e-4 with
  ``routed == sites`` (the counterparts of the reference's
  ``test_rwkv6_executor_parity`` / ``test_hybrid_executor_parity``) and
  against the reference's dense-effective decode within 1e-4; the reduced
  artifacts' shards byte for byte the reference's;
* ``param_dtype="bfloat16"``: the reference's float32 leaves (rwkv6's
  ``mix_mu``/``w0``/``u``/``ln_w``/``mix_mu_k``, mamba2's
  ``A_log``/``D``/``dt_bias``) stay float32 through ``convert``,
  ``abstract_params``, ``init_params`` and ``seeded_artifact``, every other
  leaf bf16, and a bf16 decode step's logits stay within 8 bf16 ulps of
  their scale, with the reference's greedy tokens."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import SSMSpec as JSSMSpec
from repro.configs.base import arch_to_dict as jarch_to_dict
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models import compress_adapters as jca
from repro.models import transformer as jtransformer

from repro_torch.configs import SSMSpec, arch_to_dict, get_arch, reduced_config
from repro_torch.convert import (F32_LEAVES, config_from_reference,
                                 params_from_numpy)
from repro_torch.core import CompressionConfig
from repro_torch.models import api as tapi
from repro_torch.models import compress_adapters as tca
from repro_torch.models import layers as tlayers
from repro_torch.serving.executor import CompressedExecutor
from repro_torch.testing import seeded_artifact

from test_torch_compress import assert_dense_equal

TOL = 1e-5
DECODE_TOL = 1e-4
SMALL = {"rwkv6-1.6b": dict(d_model=64, head_dim=16, d_ff=96, vocab=64),
         "zamba2-7b": dict(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                           head_dim=16, d_ff=96, vocab=64,
                           ssm=JSSMSpec(d_inner=64, d_state=16, head_dim=16,
                                        d_conv=4))}
ARCHS = tuple(SMALL)
SHARD = os.path.join("step_0000000000", "shard_0.msgpack")


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jreduced(jget_arch(request.param), **SMALL[request.param])
    tree = jax.tree.map(np.array, japi.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = config_from_reference(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(
        tree, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for red in (False, True):
        j, t = jget_arch(arch), get_arch(arch)
        if red:
            j, t = jreduced(j), reduced_config(t)
        assert jarch_to_dict(j) == arch_to_dict(t)
        assert config_from_reference(j) == t
    full = get_arch(arch)
    if arch == "zamba2-7b":
        assert full.n_layers % full.hybrid_period == 3  # 81 = 13 x 6 + 3
        assert full.ssm == SSMSpec(d_inner=7168, d_state=64, head_dim=64,
                                   d_conv=4)
        # the reference's reduced hybrid has no tail (4 layers at period
        # 2): the tests here take 5 layers so that the tail runs
        red = reduced_config(full)
        assert (red.n_layers, red.hybrid_period) == (4, 2)


def test_site_tables_are_the_references(model):
    jcfg, jp, tcfg, tp = model
    want = [(s.name, s.path, s.index, s.transpose)
            for s in jca.sites_for(jp, jcfg)]
    got = [(s.name, s.path, s.index, s.transpose)
           for s in tca.sites_for(tp, tcfg)]
    assert got == want
    if tcfg.family == "hybrid":
        shared = [g for g in got if g[0].startswith("shared_attn.")]
        assert len(shared) == 7 and all(g[2] == () for g in shared)
        assert len(got) == 2 * tcfg.n_layers + 7
    else:
        assert len(got) == 8 * tcfg.n_layers
    # each site reads the reference's matrix
    for ts, js in zip(tca.sites_for(tp, tcfg), jca.sites_for(jp, jcfg)):
        np.testing.assert_array_equal(ts.weight(tp), js.weight(jp))


def test_forward_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 40)).astype(np.int32)
    jh, jc = jtransformer.forward(jp, jcfg, tokens=jnp.asarray(toks),
                                  collect_cache=True, unroll=True)
    with torch.no_grad():
        th, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              collect_cache=True)
    _close(th, jh)
    if tcfg.family == "ssm":  # the stacked time-mix states
        _close(tc.wkv, jnp.stack([s.wkv for s in jc]))
        _close(tc.x_prev, jnp.stack([s.x_prev for s in jc]))
    else:  # a mamba state a layer, a (k, v) an insertion of the shared block
        assert len(tc["mamba"]) == tcfg.n_layers and len(tc["attn"]) == 2
        for got, want in zip(tc["mamba"], jc["mamba"]):
            _close(got.ssm, want.ssm)
            _close(got.conv, want.conv)
        for (tk, tv), (jk, jv) in zip(tc["attn"], jc["attn"]):
            _close(tk, jk)
            _close(tv, jv)
    # the training form (no cache) gives the same hidden states
    with torch.no_grad():
        th2, none = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert none is None and torch.equal(th2, th)


def test_loss_and_grads_match_reference(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)}
    jl, jg = jax.jit(jax.value_and_grad(jtransformer.loss_fn),
                     static_argnums=1)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    paths, leaves = [], []

    def req(t, path=()):
        if isinstance(t, dict):
            return {k: req(v, path + (k,)) for k, v in t.items()}
        t = t.clone().requires_grad_(True)
        paths.append(path)
        leaves.append(t)
        return t

    tpg = req(tp)
    tl = tapi.train_loss(tpg, tcfg, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    grads = dict(zip(paths, torch.autograd.grad(tl, leaves, allow_unused=True,
                                                materialize_grads=True)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    flat = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    assert sorted(flat) == sorted(grads)
    for path, want in flat.items():
        np.testing.assert_allclose(grads[path].numpy(), want, rtol=TOL,
                                   atol=TOL * max(1e-3, float(np.abs(want).max())),
                                   err_msg="/".join(path))


def _decode_both(jcfg, jp, tcfg, tp, steps=4, b=3, smax=12, jex=None, tex=None):
    js = japi.init_decode_state(jcfg, b, smax)
    ts = tapi.init_decode_state(tcfg, b, smax, device="cpu")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (steps, b)).astype(np.int32)
    out = []
    for t in range(steps):
        pos = np.array([t, t if t < 2 else -1, t], np.int32)  # an idle slot
        lj, js = japi.decode(jp, jcfg, js, jnp.asarray(toks[t][:, None]),
                             jnp.asarray(pos), executor=jex)
        with torch.no_grad():
            lt, ts = tapi.decode(tp, tcfg, ts, torch.from_numpy(toks[t][:, None]),
                                 torch.from_numpy(pos), executor=tex)
        out.append((lt, lj))
    return out, ts, js


def test_decode_step_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    out, ts, js = _decode_both(jcfg, jp, tcfg, tp)
    for lt, lj in out:
        _close(lt, lj, DECODE_TOL)
    assert sorted(ts) == sorted(js)
    for name, leaf in ts.items():
        assert leaf.dtype == (torch.int32 if "kpos" in name else torch.float32)
        _close(leaf, js[name], DECODE_TOL)
    if tcfg.family == "hybrid":  # the idle slot wrote no shared-block row
        assert (ts["attn_kpos"][:, 1, 2:] == -1).all()
    else:  # the token shifts hold the normed inputs, as the reference's do:
        # layer 0's time-mix shift is ln1's norm of the last token's embedding
        last = torch.from_numpy(np.random.default_rng(3).integers(
            0, tcfg.vocab, (4, 3)).astype(np.int64))[3]
        emb = tp["embed"][last]
        normed = tlayers.rms_norm(emb, tp["blocks"]["ln1"][0])
        np.testing.assert_allclose(_np(ts["x_prev_tm"][0]), _np(normed),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def arts(model):
    jcfg, jp, tcfg, tp = model
    kw = dict(algorithm="fp", max_share_rel_err=0.06)
    jart = japi.compress_model(jp, jcfg, jcore.CompressionConfig(**kw))
    tart = tapi.compress_model(tp, tcfg, CompressionConfig(**kw))
    return jart, tart


def test_compressed_records_bitwise_the_reference(arts):
    jart, tart = arts
    assert list(tart.records) == list(jart.records)
    for name, jr in jart.records.items():
        assert_dense_equal(jr, tart.records[name])
        for f in ("idx", "exp", "sign"):
            assert np.array_equal(np.asarray(getattr(jart.packed[name], f)),
                                  getattr(tart.packed[name], f)), (name, f)
    flat = jax.tree_util.tree_leaves_with_path(jart.params)
    for path, want in flat:
        node = tart.params
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(_np(node), np.asarray(want, np.float32))


def test_executor_parity_with_the_dense_effective_route(arts):
    """The per-region route (plain K1/K2/K3 on the CPU) against the same
    artifact's dense-effective weights: one step from a fresh state within
    1e-4, every site routed (the reference's ``_decode_parity``); and the
    port's route against the reference's dense-effective decode."""
    jart, tart = arts
    cfg = tart.config
    ex = CompressedExecutor(tart, device="cpu")
    assert ex.plan_fallbacks == {"step": f"family:{cfg.family}"}
    assert ex.step_plan(cfg) is None
    tok = torch.full((2, 1), 3, dtype=torch.long)
    pos = torch.zeros(2, dtype=torch.long)
    with torch.no_grad():
        l_k, _ = tapi.decode(tart.params, cfg,
                             tapi.init_decode_state(cfg, 2, 8, device="cpu"),
                             tok, pos, executor=ex)
        l_d, _ = tapi.decode(tart.params, cfg,
                             tapi.init_decode_state(cfg, 2, 8, device="cpu"),
                             tok, pos)
    assert float((l_k - l_d).abs().max()) <= DECODE_TOL
    assert ex.routed == ex.sites == set(tart.records)
    out, _, _ = _decode_both(jart.config, jart.params, cfg, tart.params,
                             steps=3, tex=CompressedExecutor(tart, device="cpu"))
    for lt, lj in out:
        _close(lt, lj, DECODE_TOL)


def test_reduced_artifact_saves_as_the_reference(arts, tmp_path):
    """The port's own compressed artifact (records, packed streams,
    effective params, report) saved byte for byte as the reference's; the
    run's wall-clock statistics (``wall_s``, ``units_per_s``) are the only
    thing taken from the reference's run, as no two runs share them."""
    jart, tart = arts
    jart.save(str(tmp_path / "ref"))
    dataclasses.replace(tart, pipeline_stats=dict(jart.pipeline_stats)).save(
        str(tmp_path / "port"))
    assert (tmp_path / "port" / SHARD).read_bytes() == \
        (tmp_path / "ref" / SHARD).read_bytes()


def _dtypes(tree, pre=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _dtypes(sub, pre + (key,)).items()}
    return {pre: tree.dtype}


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_leaves_stay_float32_in_bf16_models(arch):
    jcfg = dataclasses.replace(jreduced(jget_arch(arch), **SMALL[arch]),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_reference(jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    want = {tuple(k.key for k in path): str(leaf.dtype)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    f32 = {p for p, d in want.items() if d == "float32"}
    assert f32 and {p[-1] for p in f32} <= set(F32_LEAVES)
    names = ({"mix_mu", "w0", "u", "ln_w", "mix_mu_k"} if arch == "rwkv6-1.6b"
             else {"A_log", "D", "dt_bias"})
    assert {p[-1] for p in f32} == names
    for got in (_dtypes(tp), _dtypes(tapi.abstract_params(tcfg)),
                _dtypes(tapi.init_params(0, tcfg, device="cpu"))):
        assert sorted(got) == sorted(want)
        for p, d in got.items():
            assert d == (torch.float32 if p in f32 else torch.bfloat16), p
    art = seeded_artifact(tcfg, seed=0, device="cpu")
    for p, d in _dtypes(art.params).items():
        assert d == (torch.float32 if p in f32 else torch.bfloat16), p
    # a bf16 decode step: the two packages round other intermediates to
    # bf16 (the einsums' outputs, the mixes), which the layers carry on:
    # within 8 bf16 ulps of the logits' scale (measured 0.8 % / 1.4 % of
    # it for rwkv6 / zamba2), the same greedy tokens
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
    lj, _ = japi.decode(jp, jcfg, japi.init_decode_state(jcfg, 2, 8),
                        jnp.asarray(toks), jnp.zeros(2, jnp.int32))
    with torch.no_grad():
        lt, _ = tapi.decode(tp, tcfg, tapi.init_decode_state(tcfg, 2, 8,
                                                             device="cpu"),
                            torch.from_numpy(toks), torch.zeros(2, dtype=torch.long))
    assert lt.dtype == torch.bfloat16
    want = np.asarray(lj.astype(jnp.float32))
    np.testing.assert_allclose(_np(lt), want, rtol=0,
                               atol=2.0 ** -5 * max(1.0, float(np.abs(want).max())))
    assert (_np(lt).argmax(-1) == want.argmax(-1)).all()
