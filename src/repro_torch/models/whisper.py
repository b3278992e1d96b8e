"""Whisper-style encoder-decoder backbone (audio frontend stubbed), the
counterpart of ``repro.models.whisper``.

``frames`` are precomputed frame embeddings [B, S, d] (the conv frontend
stub); the encoder is bidirectional, the decoder causal with
cross-attention over the encoder's output.  Sinusoidal encoder positions,
learned decoder positions, pre-LN layout (LayerNorm with bias), a tanh-GELU
MLP with biases on both layers, q/k/v biases (none on o).

Parameters are stacked per layer (``enc_blocks`` / ``dec_blocks``, [L, ...]
leaves, the JAX package's scanned layout) and a Python loop walks the
layers.  **Decode updates the state in place**: the self-KV of
``max_decoder_len`` rows is written at each row's position (nothing at
``pos == -1`` or past the end, as the reference's ``one_hot`` writes
nothing there); the cross-KV (``cross_k`` / ``cross_v``, the encoder
states through each decoder layer's ``xattn.k`` / ``xattn.v``) is static —
the caller fills it per slot, nothing here computes it during serving.

Compressed serving routes the decoder's sites ``dec.attn.{q,k,v,o}.l{i}``
(q/k/v one fused region), ``dec.xattn.{q,o}.l{i}`` and
``dec.mlp.fc{1,2}.l{i}`` through the executor; ``dec.xattn.k/v`` never run
in decode (their KV is static) and the encoder's sites never run in
serving at all.

Under a serving mesh (``act_shard.get_mesh()``) the parameters are
:class:`~repro_torch.distributed.tp.Sharded` leaves: the embedding, the
learned positions (a table looked up as an embedding), the projections
and the tied head go through :mod:`repro_torch.distributed.tp`, the
LayerNorms' scales and biases are gathered at use; the self- and the
cross-KV hold this rank's slice (``tp.kv_split``) and attention runs
through ``tp.attend``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tp
from repro_torch.distributed.act_shard import get_mesh

from .attention import KVCache, attention_decode, attention_prefill
from .layers import gelu, gelu_mlp, layer_norm, site_fmt, site_linear
from .transformer import _embed, _layer, _trunc_normal, _unbind_layers

__all__ = ["init_params", "encode", "decoder_forward", "loss_fn", "decode_step",
           "init_decode_state"]


def _layer_tree(cfg: ArchConfig, n: int, cross: bool, trunc, const) -> dict:
    """``n`` stacked encoder (``cross=False``) or decoder layers, leaves in
    the reference's order: LayerNorms ``ln1``/``ln2`` (and ``ln_x``),
    attention with q/k/v biases, the MLP's fc1/fc2 with biases."""
    d, dff = cfg.d_model, cfg.d_ff
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def dense(i, o, bias=True):
        p = {"w": trunc((n, i, o), 1.0 / math.sqrt(i))}
        if bias:
            p["b"] = const((n, o), 0.0)
        return p

    def ln():
        return {"w": const((n, d), 1.0), "b": const((n, d), 0.0)}

    def attn():
        return {"q": dense(d, nq * hd), "k": dense(d, nkv * hd),
                "v": dense(d, nkv * hd), "o": dense(nq * hd, d, bias=False)}

    p = {"ln1": ln(), "attn": attn(), "ln2": ln(),
         "mlp": {"fc1": dense(d, dff), "fc2": dense(dff, d)}}
    if cross:
        p["ln_x"] = ln()
        p["xattn"] = attn()
    return p


def _param_tree(cfg: ArchConfig, normal, trunc, const) -> dict:
    d = cfg.d_model
    return {
        "enc_blocks": _layer_tree(cfg, cfg.enc_layers, False, trunc, const),
        "enc_ln": {"w": const((d,), 1.0), "b": const((d,), 0.0)},
        "dec_blocks": _layer_tree(cfg, cfg.n_layers, True, trunc, const),
        "dec_ln": {"w": const((d,), 1.0), "b": const((d,), 0.0)},
        "embed": normal((cfg.vocab, d), d ** -0.5),
        "dec_pos": normal((cfg.max_decoder_len, d), 0.01),
    }


def init_params_numpy(seed: int, cfg: ArchConfig) -> dict:
    """Random parameters as float32 numpy arrays in the JAX package's layout
    and distributions (fan-in truncated-normal projections, zero biases,
    unit LayerNorm scales), drawn from a numpy generator: ``jax.random``
    streams cannot be reproduced here."""
    rng = np.random.default_rng(seed)
    return _param_tree(
        cfg,
        normal=lambda shape, scale: (rng.standard_normal(shape, dtype=np.float32)
                                     * np.float32(scale)),
        trunc=lambda shape, scale: _trunc_normal(rng, shape, scale),
        const=lambda shape, value: np.full(shape, value, np.float32))


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as ``meta`` tensors in ``cfg.param_dtype``."""
    def meta(shape, _):
        return torch.empty(shape, dtype=cfg.pdtype, device="meta")

    return _param_tree(cfg, meta, meta, meta)


def init_params(seed: int, cfg: ArchConfig, device="cuda"):
    """Random parameters on ``device`` in ``cfg.param_dtype``."""
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(init_params_numpy(seed, cfg), cfg, device)


def _sinusoid(s: int, d: int, device=None) -> torch.Tensor:
    """Sinusoidal positions [s, d]: built in float64 and rounded to float32,
    as the JAX package builds them."""
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _attend(cfg: ArchConfig, p, x, positions, *, causal: bool, kv_x=None):
    y, _, _ = attention_prefill(
        p, x, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, causal=causal, rope_theta=None, q_chunk=cfg.q_chunk,
        kv_x=kv_x)
    return y


def _enc_block(cfg: ArchConfig, x, bp, positions):
    x = x + _attend(cfg, bp["attn"], layer_norm(x, bp["ln1"]["w"], bp["ln1"]["b"]),
                    positions, causal=False)
    return x + gelu_mlp(bp["mlp"], layer_norm(x, bp["ln2"]["w"], bp["ln2"]["b"]))


def _dec_block(cfg: ArchConfig, x, bp, positions, enc_out):
    x = x + _attend(cfg, bp["attn"], layer_norm(x, bp["ln1"]["w"], bp["ln1"]["b"]),
                    positions, causal=True)
    x = x + _attend(cfg, bp["xattn"],
                    layer_norm(x, bp["ln_x"]["w"], bp["ln_x"]["b"]), positions,
                    causal=False, kv_x=enc_out)
    return x + gelu_mlp(bp["mlp"], layer_norm(x, bp["ln2"]["w"], bp["ln2"]["b"]))


def _run_layers(cfg: ArchConfig, block, x, blocks, n: int, *args):
    """``block(cfg, x, layer params, *args)`` over ``n`` stacked layers; in
    training (``cfg.remat``) each layer's activations are recomputed in the
    backward pass (the reference's ``jax.checkpoint``)."""
    block = functools.partial(block, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in _unbind_layers(blocks, n):
        x = (checkpoint(block, x, bp, *args, use_reentrant=False) if remat
             else block(x, bp, *args))
    return x


def encode(params, cfg: ArchConfig, frames):
    """frames [B, S, d] -> encoder states [B, S, d]."""
    b, s, _ = frames.shape
    x = frames.to(cfg.cdtype) + _sinusoid(s, cfg.d_model, frames.device
                                          ).to(cfg.cdtype)[None]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = _run_layers(cfg, _enc_block, x, params["enc_blocks"], cfg.enc_layers,
                    positions)
    return layer_norm(x, params["enc_ln"]["w"], params["enc_ln"]["b"])


def decoder_forward(params, cfg: ArchConfig, tokens, enc_out):
    """Teacher-forced decoder -> hidden [B, T, d]."""
    b, t = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.cdtype)
    x = x + params["dec_pos"][:t][None].to(cfg.cdtype)
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    x = _run_layers(cfg, _dec_block, x, params["dec_blocks"], cfg.n_layers,
                    positions, enc_out)
    return layer_norm(x, params["dec_ln"]["w"], params["dec_ln"]["b"])


def loss_fn(params, cfg: ArchConfig, batch):
    """Mean next-token cross-entropy of ``batch`` (``frames``, ``tokens``,
    ``labels``) over the full float32 logits, as the reference takes it."""
    enc_out = encode(params, cfg, batch["frames"])
    h = decoder_forward(params, cfg, batch["tokens"], enc_out)
    logits = (h @ params["embed"].T.to(h.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    return (lse - gold).mean()


def init_decode_state(cfg: ArchConfig, batch: int, enc_len: int, device="cuda"):
    """Self-KV over ``max_decoder_len`` rows + the static cross-KV over
    ``enc_len`` rows, per decoder layer."""
    L, t = cfg.n_layers, cfg.max_decoder_len
    z = dict(dtype=cfg.cdtype, device=device)
    return {
        "self_k": torch.zeros((L, batch, t, cfg.n_kv_heads, cfg.hd), **z),
        "self_v": torch.zeros((L, batch, t, cfg.n_kv_heads, cfg.hd), **z),
        "self_kpos": torch.full((L, batch, t), -1, dtype=torch.int32,
                                device=device),
        "cross_k": torch.zeros((L, batch, enc_len, cfg.n_kv_heads, cfg.hd), **z),
        "cross_v": torch.zeros((L, batch, enc_len, cfg.n_kv_heads, cfg.hd), **z),
    }


def decode_step(params, cfg: ArchConfig, state, token, pos, executor=None):
    """One decoder token against the static cross-KV: (logits [B, V] in the
    compute dtype, state). token [B, 1], pos [B] (-1 = idle slot).

    The learned position is ``dec_pos[min(pos, max_decoder_len - 1)]``
    taken modulo its rows, so an idle row (``pos == -1``) reads the last
    row, as ``jnp.take`` wraps it in the reference.  ``executor``
    (compressed serving): the decoder's sites run through it (module
    docstring); uncovered sites stay dense."""
    t_max = cfg.max_decoder_len
    x = _embed(params, token).to(cfg.cdtype)
    row = torch.minimum(pos.long(), torch.full_like(pos.long(), t_max - 1)) % t_max
    x = x + _embed({"embed": params["dec_pos"]}, row)[:, None].to(cfg.cdtype)
    ex = executor is not None
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
              rope_theta=None, executor=executor)
    mesh = get_mesh()
    self_split = cross_split = None
    if mesh is not None:
        self_split = (mesh, tp.kv_split(mesh, cfg.n_kv_heads, cfg.hd,
                                        state["self_k"].shape[2]))
        cross_split = (mesh, tp.kv_split(mesh, cfg.n_kv_heads, cfg.hd,
                                         state["cross_k"].shape[2]))
    for li in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], li)
        cache = KVCache(k=state["self_k"][li], v=state["self_v"][li],
                        kpos=state["self_kpos"][li])
        y, _ = attention_decode(
            bp["attn"], layer_norm(x, bp["ln1"]["w"], bp["ln1"]["b"]), cache,
            pos, site=f"dec.attn.{{}}.l{li}" if ex else None,
            kv_split=self_split, **kw)
        x = x + y
        xcache = KVCache(k=state["cross_k"][li], v=state["cross_v"][li],
                         kpos=None)
        y, _ = attention_decode(
            bp["xattn"], layer_norm(x, bp["ln_x"]["w"], bp["ln_x"]["b"]), xcache,
            pos, cross=True, site=f"dec.xattn.{{}}.l{li}" if ex else None,
            kv_split=cross_split, **kw)
        x = x + y
        m_in = layer_norm(x, bp["ln2"]["w"], bp["ln2"]["b"])
        sn = site_fmt(f"dec.mlp.{{}}.l{li}" if ex else None)
        h = site_linear(executor, sn("fc1"), bp["mlp"]["fc1"], m_in)
        x = x + site_linear(executor, sn("fc2"), bp["mlp"]["fc2"], gelu(h))
    h = layer_norm(x, params["dec_ln"]["w"], params["dec_ln"]["b"])
    table = params["embed"]
    if isinstance(table, tp.Sharded):  # the vocabulary columns gathered
        return tp.linear(h, table.T.to(h.dtype))[:, 0], state
    return (h @ table.T.to(h.dtype))[:, 0], state
