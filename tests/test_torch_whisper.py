"""The audio family's model on the port against the JAX package: reduced
whisper-small (``reduced_config``: 2 encoder + 2 decoder layers, d 128, 4
heads of 32, d_ff 256, vocab 512, ``max_decoder_len`` 32), parameters from
the reference's ``init_params`` with non-zero q/k/v and fc1/fc2 biases and
perturbed LayerNorms written in before ``convert.params_from_numpy``.

* the config field for field (full and reduced), the registry's ten archs,
  the site table letter for letter (``_audio_sites``: the encoder's sites
  included, in the reference's order);
* ``_sinusoid`` bitwise; ``layer_norm`` and ``gelu_mlp`` within 1e-6 in
  float32 (the tanh GELU, ``jax.nn.gelu``'s default), and in bf16 within
  one bf16 rounding of their scale;
* ``encode`` and ``decoder_forward`` within 1e-5 of their scale, ``loss_fn``
  and every gradient within 1e-5 relative;
* ``decode_step`` with the cross-KV filled by the reference's recipe, one
  slot idle (position -1: the learned position's last row) and one slot
  run past ``max_decoder_len`` (positions 30-35 of 32: the self-KV write
  dropped, as the reference's ``one_hot`` drops it): logits and every
  state leaf within 1e-4;
* ``api``'s dispatch: ``prefill`` returns the encoder's states and None,
  ``init_decode_state`` the reference's leaves, ``train_loss`` the loss."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.configs.base import arch_to_dict as jarch_to_dict
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models import compress_adapters as jca
from repro.models import layers as jlayers
from repro.models import whisper as jwhisper

from repro_torch.configs import ARCHS, arch_to_dict, get_arch, reduced_config
from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import compress_adapters as tca
from repro_torch.models import layers as tlayers
from repro_torch.models import whisper as twhisper
from repro_torch.testing import fill_cross_kv

TOL = 1e-5
DECODE_TOL = 1e-4
ARCH = "whisper-small"


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def reference_tree(seed: int = 0) -> tuple:
    """(reference config, numpy params): the reference's ``init_params``
    with seeded non-zero q/k/v and fc1/fc2 biases and perturbed LayerNorm
    scales and biases (all zero or one at init)."""
    jcfg = jreduced(jget_arch(ARCH))
    tree = jax.tree.map(np.array, japi.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))
    rng = np.random.default_rng(seed + 100)

    def draw(a, scale, base=0.0):
        return (base + scale * rng.standard_normal(a.shape)).astype(np.float32)

    for blocks in ("enc_blocks", "dec_blocks"):
        bp = tree[blocks]
        for attn in ("attn", "xattn"):
            for proj in ("q", "k", "v"):
                if attn in bp:
                    bp[attn][proj]["b"] = draw(bp[attn][proj]["b"], 0.5)
        for fc in ("fc1", "fc2"):
            bp["mlp"][fc]["b"] = draw(bp["mlp"][fc]["b"], 0.5)
        for ln in ("ln1", "ln2", "ln_x"):
            if ln in bp:
                bp[ln]["w"] = draw(bp[ln]["w"], 0.1, 1.0)
                bp[ln]["b"] = draw(bp[ln]["b"], 0.1)
    for ln in ("enc_ln", "dec_ln"):
        tree[ln]["w"] = draw(tree[ln]["w"], 0.1, 1.0)
        tree[ln]["b"] = draw(tree[ln]["b"], 0.1)
    return jcfg, tree


@pytest.fixture(scope="module")
def model():
    jcfg, tree = reference_tree()
    tcfg = config_from_reference(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(
        tree, tcfg, "cpu")


def test_config_equals_the_reference():
    for red in (False, True):
        j, t = jget_arch(ARCH), get_arch(ARCH)
        if red:
            j, t = jreduced(j), reduced_config(t)
        assert jarch_to_dict(j) == arch_to_dict(t)
        assert config_from_reference(j) == t
    full = get_arch(ARCH)
    assert (full.family, full.n_layers, full.enc_layers, full.d_model,
            full.n_heads, full.d_ff, full.vocab, full.max_decoder_len) == \
        ("audio", 12, 12, 768, 12, 3072, 51865, 448)
    assert set(ARCHS) == set(JARCHS) and len(ARCHS) == 10


def test_site_table_is_the_references(model):
    jcfg, jp, tcfg, tp = model
    want = [(s.name, s.path, s.index, s.transpose)
            for s in jca.sites_for(jp, jcfg)]
    got = [(s.name, s.path, s.index, s.transpose)
           for s in tca.sites_for(tp, tcfg)]
    assert got == want
    assert len(got) == 6 * tcfg.enc_layers + 10 * tcfg.n_layers
    assert got[0][0] == "enc.mlp.fc1.l0" and got[-1][0] == "dec.xattn.o.l1"
    for ts, js in zip(tca.sites_for(tp, tcfg), jca.sites_for(jp, jcfg)):
        np.testing.assert_array_equal(ts.weight(tp), js.weight(jp))


@pytest.mark.parametrize("s,d", [(1500, 768), (16, 128), (7, 6)])
def test_sinusoid_is_bitwise_the_references(s, d):
    want = np.asarray(jwhisper._sinusoid(s, d))
    got = twhisper._sinusoid(s, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp(dtype):
    """float32 within 1e-6 of the scale; bf16 within one bf16 rounding of it
    (both round the normalised rows to bf16 before the affine, so the
    float32 statistics' last-ulp differences rarely cross a rounding)."""
    rng = np.random.default_rng(3)
    d, dff = 64, 96
    x = (rng.standard_normal((2, 5, d)) * 3 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    mlp = {"fc1": {"w": (rng.standard_normal((d, dff)) / 8).astype(np.float32),
                   "b": rng.standard_normal(dff).astype(np.float32)},
           "fc2": {"w": (rng.standard_normal((dff, d)) / 8).astype(np.float32),
                   "b": rng.standard_normal(d).astype(np.float32)}}
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8

    def j(a):
        return jnp.asarray(a).astype(jd)

    def t(a):
        return torch.from_numpy(a).to(td)

    want = jlayers.layer_norm(j(x), j(w), j(b))
    got = tlayers.layer_norm(t(x), t(w), t(b))
    assert got.dtype == td
    _close(got, want.astype(jnp.float32), tol)
    want = jlayers.gelu_mlp(jax.tree.map(j, mlp), j(x))
    got = tlayers.gelu_mlp(jax.tree.map(t, mlp), t(x))
    _close(got, want.astype(jnp.float32), tol if dtype == "float32" else 2.0 ** -7)
    # the tanh form: the exact erf GELU is off by 4e-4 at -3
    xs = np.linspace(-4, 4, 81).astype(np.float32)
    _close(tlayers.gelu(torch.from_numpy(xs)), jax.nn.gelu(jnp.asarray(xs)), 1e-6)


def _frames_tokens(tcfg, seed=1, b=2, s=16, t=6):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab, (b, t)).astype(np.int32)
    return frames, toks


def test_encode_and_decoder_forward_match_the_reference(model):
    jcfg, jp, tcfg, tp = model
    frames, toks = _frames_tokens(tcfg)
    je = jwhisper.encode(jp, jcfg, jnp.asarray(frames))
    jh = jwhisper.decoder_forward(jp, jcfg, jnp.asarray(toks), je)
    with torch.no_grad():
        te, none = tapi.prefill(tp, tcfg, {"frames": torch.from_numpy(frames)})
        th = twhisper.decoder_forward(tp, tcfg, torch.from_numpy(toks), te)
    assert none is None
    _close(te, je)
    _close(th, jh)


def test_loss_and_grads_match_the_reference(model):
    jcfg, jp, tcfg, tp = model
    frames, toks = _frames_tokens(tcfg, seed=2)
    labels = np.random.default_rng(2).integers(0, tcfg.vocab, toks.shape
                                               ).astype(np.int32)
    batch = {"frames": frames, "tokens": toks, "labels": labels}
    jl, jg = jax.jit(jax.value_and_grad(jwhisper.loss_fn), static_argnums=1)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    paths, leaves = [], []

    def req(t, path=()):
        if isinstance(t, dict):
            return {k: req(v, path + (k,)) for k, v in t.items()}
        t = t.clone().requires_grad_(True)
        paths.append(path)
        leaves.append(t)
        return t

    tl = tapi.train_loss(req(tp), tcfg, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    grads = dict(zip(paths, torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    flat = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    assert sorted(flat) == sorted(grads)
    for path, want in flat.items():
        np.testing.assert_allclose(grads[path].numpy(), want, rtol=TOL,
                                   atol=TOL * max(1e-3, float(np.abs(want).max())),
                                   err_msg="/".join(path))


def reference_cross_kv(jcfg, jp, frames):
    """The reference's recipe (``test_whisper_decode_consistency``): the
    encoder's states through each decoder layer's ``xattn.k``/``xattn.v``,
    stacked ``[L, B, S, Hkv, hd]``."""
    enc = jwhisper.encode(jp, jcfg, jnp.asarray(frames))
    b, s, _ = enc.shape
    ck, cv = [], []
    for li in range(jcfg.n_layers):
        bp = jax.tree.map(lambda a: a[li], jp["dec_blocks"])
        ck.append(jlayers.linear(bp["xattn"]["k"], enc).reshape(
            b, s, jcfg.n_kv_heads, jcfg.hd))
        cv.append(jlayers.linear(bp["xattn"]["v"], enc).reshape(
            b, s, jcfg.n_kv_heads, jcfg.hd))
    return jnp.stack(ck), jnp.stack(cv)


def test_fill_cross_kv_is_the_references_recipe(model):
    jcfg, jp, tcfg, tp = model
    frames, _ = _frames_tokens(tcfg, seed=4, b=3)
    ck, cv = reference_cross_kv(jcfg, jp, frames)
    st = tapi.init_decode_state(tcfg, 3, 16, device="cpu")
    for slot in range(3):
        fill_cross_kv(tp, tcfg, st, slot, torch.from_numpy(frames[slot]))
    _close(st["cross_k"], ck)
    _close(st["cross_v"], cv)
    with pytest.raises(ValueError, match="encoder positions"):
        fill_cross_kv(tp, tcfg, st, 0, torch.from_numpy(frames[0, :8]))


def test_decode_step_matches_the_reference(model):
    """Three slots over 36 steps: slot 0 runs positions 0-35 (past
    ``max_decoder_len`` = 32 from step 32 on: its self-KV keeps the 32
    rows written, as the reference's ``one_hot`` writes nothing), slot 1
    is idle from step 2 on (position -1: the learned position's last row),
    slot 2 runs positions 0-35 too, on other tokens."""
    jcfg, jp, tcfg, tp = model
    b, s_enc, steps = 3, 16, 36
    frames, _ = _frames_tokens(tcfg, seed=5, b=b, s=s_enc)
    ck, cv = reference_cross_kv(jcfg, jp, frames)
    js = japi.init_decode_state(jcfg, b, s_enc)
    js["cross_k"], js["cross_v"] = ck, cv
    ts = tapi.init_decode_state(tcfg, b, s_enc, device="cpu")
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: tuple(v.shape) for k, v in js.items()}
    ts["cross_k"].copy_(torch.from_numpy(np.array(ck)))
    ts["cross_v"].copy_(torch.from_numpy(np.array(cv)))
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (steps, b)
                                             ).astype(np.int32)
    dec = jax.jit(lambda st, tok, pos: japi.decode(jp, jcfg, st, tok, pos))
    for t in range(steps):
        pos = np.array([t, t if t < 2 else -1, t], np.int32)
        lj, js = dec(js, jnp.asarray(toks[t][:, None]), jnp.asarray(pos))
        with torch.no_grad():
            lt, ts = tapi.decode(tp, tcfg, ts, torch.from_numpy(toks[t][:, None]),
                                 torch.from_numpy(pos))
        assert lt.shape == (b, tcfg.vocab) and lt.dtype == torch.float32
        _close(lt, lj, DECODE_TOL)
    for name, leaf in ts.items():
        _close(leaf, js[name], DECODE_TOL)
    kpos = ts["self_kpos"]
    assert torch.equal(kpos[:, 0], torch.arange(32, dtype=torch.int32
                                                ).expand_as(kpos[:, 0]))
    assert (kpos[:, 1, 2:] == -1).all()
    # an idle row alone: the learned position's last row, no self-KV row
    with torch.no_grad():
        row, st = twhisper.decode_step(
            tp, tcfg, tapi.init_decode_state(tcfg, 1, s_enc, device="cpu"),
            torch.zeros((1, 1), dtype=torch.long), torch.tensor([-1]))
    jrow, _ = japi.decode(jp, jcfg, japi.init_decode_state(jcfg, 1, s_enc),
                          jnp.zeros((1, 1), jnp.int32), jnp.asarray([-1]))
    _close(row, jrow, DECODE_TOL)
    assert (st["self_kpos"] == -1).all() and not st["self_k"].any()


def test_api_serves_the_family(model):
    """``init_params`` / ``abstract_params`` give the reference's tree (keys,
    shapes, dtypes); the decoder backbone refuses the family by pointing at
    ``models/whisper.py``."""
    jcfg, jp, tcfg, tp = model

    def shapes(tree):
        return {tuple(k.key for k in path): tuple(v.shape)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}

    want = shapes(jp)
    assert shapes(tapi.init_params(0, tcfg, device="cpu")) == want
    assert shapes(tapi.abstract_params(tcfg)) == want
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    assert {v.dtype for v in jax.tree.leaves(tapi.abstract_params(bf))} == \
        {torch.bfloat16}
    from repro_torch.models import transformer

    with pytest.raises(ValueError, match="models/whisper.py"):
        transformer.forward(tp, tcfg, tokens=torch.zeros((1, 2), dtype=torch.long))
