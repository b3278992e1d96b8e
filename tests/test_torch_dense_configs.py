"""The rest of the dense family on the port — qwen2.5-3b (QKV bias, GQA,
tied embeddings), llama3.2-3b (GQA, theta 500000, tied) and yi-9b (GQA,
untied) — and the VLM's config, against the JAX package.

The four configs equal the reference's field for field, reduced too, and
the registry holds seven archs.  At a small width (2 layers, d 32, 2
heads of 16 over one kv head, d_ff 48, vocab 64; qwen2.5-3b with seeded
non-zero q/k/v biases handed to both packages): prefill hidden states and
caches, and decode steps on a paged cache with an idle slot, within 1e-4
of the reference; an artifact from each package's compressor on the same
parameters, decoded greedily for four steps on the plan route (float32:
K6/K7's plain versions against the reference's interpret-mode plan) and
on the per-region route: the same tokens, logits within 1e-4 at every
step, ``plan_fallbacks`` and plan counts the reference's.  The seeded
fixture draws non-zero biases for a ``qkv_bias`` config from a generator
of its own: every other leaf and record is what it is without them."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.configs.base import arch_to_dict as jarch_to_dict
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.configs import ARCHS, arch_to_dict, get_arch, reduced_config
from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.core import CompressionConfig
from repro_torch.models import api as tapi
from repro_torch.serving.executor import CompressedExecutor
from repro_torch.testing import BIAS_SCALE, seeded_artifact

from test_torch_compress import assert_dense_equal

TOL = 1e-4
NEW = ("qwen2.5-3b", "llama3.2-3b", "yi-9b", "qwen2-vl-7b")
DENSE = ("qwen2.5-3b", "llama3.2-3b", "yi-9b")
SMALL = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
             n_kv_heads=1, head_dim=16)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("arch", NEW)
def test_config_equals_the_reference(arch):
    for red in (False, True):
        j, t = jget_arch(arch), get_arch(arch)
        if red:
            j, t = jreduced(j), reduced_config(t)
        assert jarch_to_dict(j) == arch_to_dict(t)
        assert config_from_reference(j) == t
    assert set(ARCHS) == set(JARCHS) and len(ARCHS) == 10
    assert set(NEW) | {"olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b",
                       "rwkv6-1.6b", "zamba2-7b", "whisper-small"} == set(ARCHS)


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    jcfg = jreduced(jget_arch(request.param), **SMALL)
    tree = jax.tree.map(np.array, japi.init_params(jax.random.PRNGKey(5), jcfg))
    if jcfg.qkv_bias:  # zero at init: seeded non-zero biases
        rng = np.random.default_rng(6)
        for proj in ("q", "k", "v"):
            b = tree["blocks"]["attn"][proj]["b"]
            tree["blocks"]["attn"][proj]["b"] = (
                0.5 * rng.standard_normal(b.shape)).astype(b.dtype)
    tcfg = config_from_reference(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_numpy(tree, tcfg, "cpu"))


def test_prefill_and_decode_match_the_reference(model):
    jcfg, jp, tcfg, tp = model
    assert ("b" in tp["blocks"]["attn"]["q"]) == tcfg.qkv_bias
    toks = np.random.default_rng(7).integers(0, 64, (2, 9)).astype(np.int32)
    jh, (jk, jv) = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                collect_cache=True)
    with torch.no_grad():
        th, (tk, tv) = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                    collect_cache=True)
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    b = 3
    js = japi.init_decode_state(jcfg, b, 8, kv_block=4)
    ts = tapi.init_decode_state(tcfg, b, 8, kv_block=4, device="cpu")
    tbl = (1 + np.arange(b * 2)).reshape(b, 2).astype(np.int32)
    js["block_tbl"] = jnp.asarray(tbl)
    ts["block_tbl"].copy_(torch.from_numpy(tbl))
    for t in range(3):
        tok = toks[:1, t:t + 1].repeat(b, 0) + np.arange(b)[:, None]
        pos = np.array([t, t, t if t < 1 else -1], np.int32)  # an idle slot
        lj, js = japi.decode(jp, jcfg, js, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            lt, ts = tapi.decode(tp, tcfg, ts, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def arts(model):
    jcfg, jp, tcfg, tp = model
    return (japi.compress_model(jp, jcfg, jcore.CompressionConfig(
                algorithm="fp", max_share_rel_err=0.06)),
            tapi.compress_model(tp, tcfg, CompressionConfig(
                algorithm="fp", max_share_rel_err=0.06)))


@pytest.mark.parametrize("use_plans", [True, False], ids=["plan", "per_region"])
def test_compressed_routes_decode_as_the_reference(arts, use_plans):
    jart, tart = arts
    jcfg, tcfg = jart.config, tart.config
    for name, jr in jart.records.items():
        assert_dense_equal(jr, tart.records[name])
    jex = JExecutor(jart, interpret=True, use_plans=use_plans)
    tex = CompressedExecutor(tart, use_plans=use_plans, device="cpu")
    jstep = jax.jit(functools.partial(japi.decode, executor=jex),
                    static_argnums=1)
    b = 3
    js = japi.init_decode_state(jcfg, b, 8)
    ts = tapi.init_decode_state(tcfg, b, 8, device="cpu")
    tok = np.array([[3], [41], [17]], np.int32)
    for t in range(4):  # greedy: each step feeds its own argmax back
        pos = np.full(b, t, np.int32)
        lj, js = jstep(jart.params, jcfg, js, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            lt, ts = tapi.decode(tart.params, tcfg, ts, torch.from_numpy(tok),
                                 torch.from_numpy(pos), executor=tex)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=TOL)
        want = np.array(jnp.argmax(lj, -1), np.int32)
        assert np.array_equal(lt.argmax(-1).numpy(), want)
        tok = want[:, None]
    assert tex.routed == tex.sites == set(tart.records)
    assert tex.plan_fallbacks == jex.plan_fallbacks
    assert tex.n_layer_plans == jex.n_layer_plans == int(use_plans)


def test_seeded_fixture_draws_biases_of_its_own():
    cfg = reduced_config(get_arch("qwen2.5-3b"), vocab=64)
    art = seeded_artifact(cfg, seed=3, device="cpu")
    plain = seeded_artifact(dataclasses.replace(cfg, qkv_bias=False), seed=3,
                            device="cpu")
    attn, attn0 = art.params["blocks"]["attn"], plain.params["blocks"]["attn"]
    for proj, n in (("q", cfg.n_heads * cfg.hd), ("k", cfg.n_kv_heads * cfg.hd),
                    ("v", cfg.n_kv_heads * cfg.hd)):
        bias = attn[proj]["b"]
        assert tuple(bias.shape) == (cfg.n_layers, n)
        assert bias.dtype == cfg.pdtype and bool((bias != 0).all())
        assert 0.3 * BIAS_SCALE < float(bias.std()) < 2 * BIAS_SCALE
        assert "b" not in attn0[proj]
    # everything else is the fixture without biases, bit for bit
    del attn["q"]["b"], attn["k"]["b"], attn["v"]["b"]

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{pre}/{k}")
        else:
            yield pre, t

    a, p = dict(leaves(art.params)), dict(leaves(plain.params))
    assert sorted(a) == sorted(p)
    assert all(torch.equal(a[k], p[k]) for k in a)
    assert list(art.records) == list(plain.records)
    for name, rec in art.records.items():
        assert np.array_equal(rec.effective, plain.records[name].effective)
        assert np.array_equal(art.packed[name].idx, plain.packed[name].idx)
    # the seed decides the biases
    other = seeded_artifact(cfg, seed=4, device="cpu").params["blocks"]["attn"]
    assert not torch.equal(other["v"]["b"], seeded_artifact(
        cfg, seed=3, device="cpu").params["blocks"]["attn"]["v"]["b"])
