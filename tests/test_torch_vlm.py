"""qwen2-vl-7b (the VLM family: m-RoPE, embeddings input, the vision tower
stubbed) on the port against the JAX package, at reduced widths (2 layers,
d 64, 2 heads of 32 over one kv head, d_ff 96, vocab 64, sections (4, 6,
6)), with seeded non-zero q/k/v biases handed to both packages.

``forward`` on embeddings at distinct temporal / height / width positions:
hidden states and K/V caches within 1e-5; ``loss_fn`` and its gradients on
an embeddings batch with ``positions3`` within 1e-5 relative; token decode
steps (m-RoPE at the token's position on all three axes, an idle slot)
within 1e-4.  ``api.compress_model`` on the converted parameters: records
bitwise the reference's, ``vlm`` taking the dense site table.  The engines
on those artifacts, float32 and a bf16 cast: the same greedy tokens, the
per-region route's first decode step within 1e-4 (float32) and, in bf16,
within four bf16 ulps of the logits' scale (``2**-6 * max|logit|``: the
two packages round other intermediates to bf16; measured two ulps at the
largest logits), ``plan_fallbacks`` the reference's
(``pos:mrope`` refuses the step plan) and the prefix cache off in both."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models import transformer as jtransformer
from repro.serving.engine import ServingEngine as JEngine

from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.core import CompressionConfig
from repro_torch.models import api as tapi
from repro_torch.models import compress_adapters as tca
from repro_torch.models import transformer as ttransformer
from repro_torch.serving.engine import ServingEngine

from test_torch_compress import assert_dense_equal

TOL = 1e-5
DECODE_TOL = 1e-4
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=96,
             vocab=64)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def with_biases(jp, seed):
    """The JAX params (zero biases at init) with seeded non-zero q/k/v
    biases, as numpy; the same tree goes to both packages."""
    tree = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(seed)
    for proj in ("q", "k", "v"):
        b = tree["blocks"]["attn"][proj]["b"]
        tree["blocks"]["attn"][proj]["b"] = (
            0.5 * rng.standard_normal(b.shape)).astype(b.dtype)
    return tree


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_arch("qwen2-vl-7b"), **SMALL)
    tree = with_biases(japi.init_params(jax.random.PRNGKey(0), jcfg), 1)
    tcfg = config_from_reference(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(
        tree, tcfg, "cpu")


def _positions3(rng, b, s):
    """Distinct temporal / height / width ids: a 2 x 3 patch grid at
    temporal 0 after a few text tokens, as Qwen2-VL lays an image out."""
    p = np.broadcast_to(np.arange(s), (3, b, s)).copy()
    p[1, :, 2:8] = 2 + np.repeat(np.arange(2), 3)
    p[2, :, 2:8] = 2 + np.tile(np.arange(3), 2)
    p[0, :, 2:8] = 2
    p += rng.integers(0, 3, (1, b, 1))
    return p.astype(np.int32)


def test_config_and_site_table(model):
    jcfg, jp, tcfg, tp = model
    assert tcfg.family == "vlm" and tcfg.pos == "mrope"
    assert tcfg.inputs == "embeds" and tcfg.qkv_bias
    assert tcfg.mrope_sections == (4, 6, 6) and tcfg.hd == 32
    sites = tca.sites_for(tp, tcfg)
    assert [s.name for s in sites] == [s.name for s in tca.sites_for(
        tp, dataclasses.replace(tcfg, family="dense", pos="rope"))]
    assert len(sites) == 7 * tcfg.n_layers


def test_forward_on_embeddings_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(2)
    b, s = 2, 12
    emb = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    p3 = _positions3(rng, b, s)
    jh, (jk, jv) = jtransformer.forward(jp, jcfg, embeds=jnp.asarray(emb),
                                        positions3=jnp.asarray(p3),
                                        collect_cache=True)
    with torch.no_grad():
        th, (tk, tv) = tapi.prefill(tp, tcfg, {"embeds": torch.from_numpy(emb),
                                               "positions3": torch.from_numpy(p3)},
                                    collect_cache=True)
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    # the positions matter: text positions on all three axes differ ...
    with torch.no_grad():
        h_text, _ = ttransformer.forward(tp, tcfg, embeds=torch.from_numpy(emb))
        h_same, _ = ttransformer.forward(
            tp, tcfg, embeds=torch.from_numpy(emb),
            positions3=torch.arange(s)[None, None].expand(3, b, s))
    assert not np.allclose(_np(h_text), _np(th), atol=1e-3)
    # ... and the default is arange(S) broadcast over the three axes
    assert torch.equal(h_text, h_same)


def test_loss_and_grads_on_embeddings_match_reference(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(3)
    b, s = 2, 16
    batch = {"embeds": rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32),
             "positions3": _positions3(rng, b, s),
             "labels": rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)}
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
    grads = dict(zip(paths, torch.autograd.grad(
        tl, leaves, allow_unused=True, materialize_grads=True)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    flat = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    assert sorted(flat) == sorted(grads)
    for path, want in flat.items():
        np.testing.assert_allclose(grads[path].numpy(), want, rtol=TOL,
                                   atol=TOL * max(1e-3, float(np.abs(want).max())),
                                   err_msg="/".join(path))
    # the biases are live; the embedding table is not read (embeddings in)
    for proj in ("q", "k", "v"):
        assert float(grads[("blocks", "attn", proj, "b")].abs().max()) > 0
    assert float(grads[("embed",)].abs().max()) == 0


def test_token_decode_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    b, smax = 3, 12
    js = japi.init_decode_state(jcfg, b, smax, kv_block=4)
    ts = tapi.init_decode_state(tcfg, b, smax, kv_block=4, device="cpu")
    tbl = (1 + np.arange(b * 3)).reshape(b, 3).astype(np.int32)
    js["block_tbl"] = jnp.asarray(tbl)
    ts["block_tbl"].copy_(torch.from_numpy(tbl))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab, (4, b)).astype(np.int32)
    for t in range(4):
        pos = np.array([t, t if t < 2 else -1, t], np.int32)  # an idle slot
        lj, js = japi.decode(jp, jcfg, js, jnp.asarray(toks[t][:, None]),
                             jnp.asarray(pos))
        with torch.no_grad():
            lt, ts = tapi.decode(tp, tcfg, ts, torch.from_numpy(toks[t][:, None]),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0,
                                   atol=DECODE_TOL)
    for name in ("k", "v", "kpos"):
        np.testing.assert_allclose(_np(ts[name]), np.asarray(js[name], np.float32),
                                   rtol=0, atol=DECODE_TOL)


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
    assert len(tart.records) == 7 * tart.config.n_layers
    for name, jr in jart.records.items():
        assert_dense_equal(jr, tart.records[name])
        for f in ("idx", "exp", "sign"):
            assert np.array_equal(np.asarray(getattr(jart.packed[name], f)),
                                  getattr(tart.packed[name], f)), (name, f)
    # the biases pass through untouched
    for proj in ("q", "k", "v"):
        np.testing.assert_array_equal(
            tart.params["blocks"]["attn"][proj]["b"].numpy(),
            np.asarray(jart.params["blocks"]["attn"][proj]["b"]))


def _bf16(jart, tart):
    jcfg = dataclasses.replace(jart.config, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tcfg = config_from_reference(jcfg)
    return (dataclasses.replace(jart, config=jcfg, params=jax.tree.map(
                lambda a: a.astype(jnp.bfloat16), jart.params)),
            dataclasses.replace(tart, config=tcfg, params=params_from_numpy(
                jax.tree.map(np.asarray, jax.tree.map(
                    lambda a: a.astype(jnp.bfloat16), jart.params)), tcfg, "cpu")))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engines_serve_as_the_reference(arts, dtype):
    jart, tart = arts if dtype == "float32" else _bf16(*arts)
    prompts = [[5, 9, 2, 7], [1, 33, 8, 3], [60, 4, 4, 12]]
    jeng = JEngine(artifact=jart, n_slots=4, max_len=32, kv_block=4,
                   metrics=False)
    eng = ServingEngine(artifact=tart, n_slots=4, max_len=32, kv_block=4,
                        device="cpu")
    want = [r.tokens for r in jeng.generate(prompts, max_new_tokens=6)]
    got = [r.tokens for r in eng.generate(prompts, max_new_tokens=6)]
    assert got == want
    assert not jeng.pool.prefix_cache and not eng.pool.prefix_cache
    assert eng.plan_stats()["fallbacks"] == jeng.plan_stats()["fallbacks"] \
        == {"step": "pos:mrope"}
    assert eng.n_layer_plans == jeng.n_layer_plans == 0
    assert eng.executor.routed == eng.executor.sites == set(tart.records)
    # one decode step's logits on the per-region route
    b = 2
    tok = np.array([[3], [41]], np.int32)
    pos = np.array([0, 0], np.int32)
    lj, _ = jax.jit(functools.partial(japi.decode, executor=jeng.executor),
                    static_argnums=1)(
        jart.params, jart.config, japi.init_decode_state(jart.config, b, 8),
        jnp.asarray(tok), jnp.asarray(pos))
    with torch.no_grad():
        lt, _ = tapi.decode(tart.params, tart.config,
                            tapi.init_decode_state(tart.config, b, 8, device="cpu"),
                            torch.from_numpy(tok), torch.from_numpy(pos),
                            executor=eng.executor)
    want = np.asarray(lj, np.float32)
    tol = (DECODE_TOL if dtype == "float32"
           else 2.0 ** -6 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(_np(lt), want, rtol=0, atol=tol)
