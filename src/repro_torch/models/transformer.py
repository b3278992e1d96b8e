"""Decoder backbone — the dense family (olmo-1b and relatives), the MoE
family (mixtral-8x22b; deepseek-v2-lite with MLA attention and shared
experts), the VLM, and the recurrent families: ssm (rwkv6) and hybrid
(zamba2).

Block layout:  dense   x += attn(norm(x));      x += swiglu(norm(x))
               moe     x += attn|mla(norm(x));  x += moe(norm(x)) [+ shared]
               ssm     x += timemix(norm(x));   x += channelmix(norm(x))
               hybrid  groups of ``hybrid_period`` mamba2 blocks, one
                       *weight-shared* attention+SwiGLU block after each
                       group, then the tail's mamba2 blocks

Parameters are stacked per layer ([L, ...] leaves, the JAX package's scanned
layout) and a Python loop walks the layers, so layer ``li`` binds its own
kernel buffers when a compressed executor is present (the hybrid's shared
block is one unstacked set of weights and sites, with one KV cache an
insertion).  **Decode updates the state in place** (the JAX package
returned new arrays and relied on ``donate_argnums``): ``decode_step``
hands back the dict it was given, its KV caches or recurrent states
written.

Under a serving mesh (``act_shard.get_mesh()``, which ``models.api`` sets
for a call given ``mesh=``) every family takes
:class:`~repro_torch.distributed.tp.Sharded` parameters: the embedding, the
projections and the tied head compute this rank's part through
:mod:`repro_torch.distributed.tp`, and each decode-state leaf holds this
rank's slice (``tp.state_split``), used by the rule ``tp``'s docstring
gives it: the KV caches (``k``/``v``, the hybrid's ``attn_k``/``attn_v``)
and rwkv6's wkv and mamba2's SSM states on the slice, MLA's latents, the
token shifts and the conv windows gathered whole at use.  ``moe_manual`` runs
:func:`~repro_torch.models.moe.moe_ffn_manual` (without an executor, as in
the reference); without a mesh it is ``moe_ffn``.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tp
from repro_torch.distributed.act_shard import get_mesh

from .attention import (KVCache, MLACache, PagedKVCache, PagedMLACache,
                        attention_decode, attention_extend, attention_prefill,
                        mla_decode, mla_extend, mla_prefill)
from .layers import (linear, non_parametric_ln, rms_norm, site_linear,
                     site_linear_group, swiglu)
from .mamba2 import Mamba2State, mamba2_decode, mamba2_prefill
from .moe import moe_ffn, moe_ffn_manual
from .rwkv6 import (LORA_MIX, LORA_W, MIX, RWKV6State, rwkv6_channelmix,
                    rwkv6_timemix_decode, rwkv6_timemix_prefill)

__all__ = ["init_params", "init_params_numpy", "abstract_params", "forward",
           "forward_extend", "logits_from_hidden", "loss_fn", "decode_step",
           "init_decode_state", "paged_layout"]


def _norm(cfg: ArchConfig, p, x):
    if cfg.norm == "nonparam":
        return non_parametric_ln(x)
    return rms_norm(x, p)


def _require_supported(cfg: ArchConfig) -> None:
    """The dense and MoE rope/no-position decoders, with GQA or MLA
    attention and with or without shared experts, the VLM decoder (m-RoPE,
    dense FFN), the ssm decoder (rwkv6) and the hybrid (mamba2 + a shared
    attention block).  The encoder-decoder (audio) family is served by
    ``models/whisper.py`` through ``models/api``, not here."""
    if cfg.family == "audio" or cfg.enc_layers > 0:
        raise ValueError(
            f"{cfg.name}: the audio family (encoder-decoder models) is served "
            "by models/whisper.py through models/api, not by the decoder "
            "backbone")
    vlm = cfg.family == "vlm" and cfg.pos == "mrope" and cfg.moe is None
    recurrent = cfg.family in ("ssm", "hybrid") and cfg.moe is None
    if not (vlm or recurrent) and (
            cfg.family not in ("dense", "moe")
            or (cfg.family == "moe") != (cfg.moe is not None)
            or cfg.pos not in ("rope", "none")):
        raise NotImplementedError(
            f"{cfg.name}: this package serves the dense and MoE "
            "rope/no-position decoders, the m-RoPE vlm decoder and the ssm "
            f"and hybrid families (family={cfg.family!r}, pos={cfg.pos!r})")


def _ffn(cfg: ArchConfig, p, x, executor=None, li: int | None = None):
    """The block's FFN on ``x [B, S, d]``: SwiGLU, or the routed experts.
    With an executor, layer ``li``'s compressed sites run through it
    (``moe_manual``'s experts never do, as in the reference)."""
    if cfg.moe is not None:
        kw = dict(n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                  capacity_factor=cfg.moe.capacity_factor,
                  norm_topk=cfg.moe.norm_topk)
        if cfg.moe_manual:
            return moe_ffn_manual(p, x, **kw)[0]
        if executor is not None:
            kw.update(executor=executor, site_tag=f"l{li}")
        return moe_ffn(p, x, **kw)[0]
    if executor is not None:
        return _sites_swiglu(executor, f"ffn.{{}}.l{li}")(p, x)
    return swiglu(p, x)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _trunc_normal(rng: np.random.Generator, shape, scale: float) -> np.ndarray:
    """Normal truncated to [-2, 2] sigma (redraw the tails), times ``scale``."""
    a = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(a) > 2
    while bad.any():
        a[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(a) > 2
    return a * np.float32(scale)


def _param_tree(cfg: ArchConfig, normal, trunc, const) -> dict:
    """The parameter tree, leaf by leaf in draw order: ``normal(shape,
    scale)``, ``trunc(shape, scale)`` (fan-in truncated normal) and
    ``const(shape, value)`` make the leaves.  The block leaves of every
    family, the recurrent mixes' small leaves included, carry the JAX
    package's init values and distributions."""
    d = cfg.d_model
    recurrent = cfg.family in ("ssm", "hybrid")
    # the attention families draw their attention weights before the
    # embedding (this package's draw order since the dense family)
    attn = None if recurrent else _attention_tree(cfg, trunc, const)
    params: dict[str, Any] = {"embed": normal((cfg.vocab, d), d ** -0.5),
                              "final_ln": const((d,), 1.0)}
    if cfg.family == "ssm":
        params["blocks"] = rwkv6_block_tree(cfg, normal, trunc, const)
    elif cfg.family == "hybrid":
        params["blocks"] = mamba2_block_tree(cfg, normal, trunc, const)
    else:
        params["blocks"] = _attention_blocks(cfg, attn, trunc, const)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": trunc((d, cfg.vocab), 1.0 / math.sqrt(d))}
    if cfg.family == "hybrid":
        params["shared_attn"] = shared_attn_tree(cfg, trunc, const)
    return params


def _dense(trunc, const, lead: tuple, i: int, o: int, bias: bool = False):
    p = {"w": trunc((*lead, i, o), 1.0 / math.sqrt(i))}
    if bias:
        p["b"] = const((*lead, o), 0.0)
    return p


def _attention_tree(cfg: ArchConfig, trunc, const) -> dict:
    """The stacked attention of the dense, MoE and VLM families: GQA
    q/k/v/o (q/k/v biases with ``qkv_bias``) or MLA's projections."""
    L, d = cfg.n_layers, cfg.d_model
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def dense(i, o, bias=False):
        return _dense(trunc, const, (L,), i, o, bias)

    if cfg.mla is not None:
        m = cfg.mla
        attn = {"q": dense(d, nq * (m.qk_nope + m.qk_rope)),
                "dkv": dense(d, m.kv_lora), "kr": dense(d, m.qk_rope),
                "uk": dense(m.kv_lora, nq * m.qk_nope),
                "uv": dense(m.kv_lora, nq * m.v_dim),
                "o": dense(nq * m.v_dim, d)}
    else:
        attn = {"q": dense(d, nq * hd, cfg.qkv_bias),
                "k": dense(d, nkv * hd, cfg.qkv_bias),
                "v": dense(d, nkv * hd, cfg.qkv_bias),
                "o": dense(nq * hd, d)}
    return attn


def _attention_blocks(cfg: ArchConfig, attn: dict, trunc, const) -> dict:
    """The stacked blocks of the dense, MoE and VLM families around their
    attention ``attn``: the norms and the SwiGLU FFN or the experts."""
    L, d, dff = cfg.n_layers, cfg.d_model, cfg.d_ff

    def dense(i, o):
        return _dense(trunc, const, (L,), i, o)

    blocks = {"ln1": const((L, d), 1.0), "ln2": const((L, d), 1.0),
              "attn": attn}
    if cfg.moe is None:
        blocks["ffn"] = {"gate": dense(d, dff), "up": dense(d, dff),
                         "down": dense(dff, d)}
    else:
        ne, edff = cfg.moe.n_experts, cfg.moe.d_ff_expert
        blocks["ffn"] = {
            "router": trunc((L, d, ne), 1.0 / math.sqrt(d)),
            "gate": trunc((L, ne, d, edff), 1.0 / math.sqrt(d)),
            "up": trunc((L, ne, d, edff), 1.0 / math.sqrt(d)),
            "down": trunc((L, ne, edff, d), 1.0 / math.sqrt(edff))}
        if cfg.moe.n_shared > 0:
            sff = cfg.moe.n_shared * edff
            blocks["ffn"]["shared"] = {
                "gate": dense(d, sff), "up": dense(d, sff),
                "down": dense(sff, d)}
    return blocks


def rwkv6_block_tree(cfg: ArchConfig, normal, trunc, const) -> dict:
    """The ssm family's stacked blocks: the rwkv6 time-mix ``tm`` (the five
    mixes' ``mix_mu``, their LoRA ``mix_A``/``mix_B``, r/k/v/g/o, the decay
    ``w0`` and its LoRA ``wA``/``wB``, the bonus ``u``, the per-head norm
    scale ``ln_w``) and channel-mix ``cm`` (``mix_mu_k``, k/v/r)."""
    L, d, dff, hd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.hd
    nm = len(MIX)

    def dense(i, o):
        return _dense(trunc, const, (L,), i, o)

    return {
        "ln1": const((L, d), 1.0), "ln2": const((L, d), 1.0),
        "tm": {"mix_mu": const((L, nm, d), 0.5),
               "mix_A": normal((L, d, LORA_MIX * nm), 0.01),
               "mix_B": normal((L, nm, LORA_MIX, d), 0.01),
               "r": dense(d, d), "k": dense(d, d), "v": dense(d, d),
               "g": dense(d, d), "o": dense(d, d),
               "w0": const((L, d), -5.0),
               "wA": normal((L, d, LORA_W), 0.01),
               "wB": normal((L, LORA_W, d), 0.01),
               "u": normal((L, d // hd, hd), 0.1),
               "ln_w": const((L, d), 1.0)},
        "cm": {"mix_mu_k": const((L, d), 0.5), "k": dense(d, dff),
               "v": dense(dff, d), "r": dense(d, d)},
    }


def mamba2_block_tree(cfg: ArchConfig, normal, trunc, const) -> dict:
    """The hybrid family's stacked mamba2 blocks (one norm each, no FFN):
    ``in_proj`` to z, x, B, C and dt, the depthwise conv over x, B and C,
    ``A_log``, ``D``, ``dt_bias``, the gated norm's scale and ``out_proj``."""
    L, d, sc = cfg.n_layers, cfg.d_model, cfg.ssm
    h = sc.d_inner // sc.head_dim
    conv_dim = sc.d_inner + 2 * sc.d_state

    def dense(i, o):
        return _dense(trunc, const, (L,), i, o)

    return {"ln1": const((L, d), 1.0),
            "mamba": {"in_proj": dense(d, 2 * sc.d_inner + 2 * sc.d_state + h),
                      "conv_w": normal((L, conv_dim, sc.d_conv), 0.2),
                      "conv_b": const((L, conv_dim), 0.0),
                      "A_log": const((L, h), 0.0),
                      "D": const((L, h), 1.0),
                      "dt_bias": const((L, h), 0.0),
                      "norm_w": const((L, sc.d_inner), 1.0),
                      "out_proj": dense(sc.d_inner, d)}}


def shared_attn_tree(cfg: ArchConfig, trunc, const) -> dict:
    """Zamba2's weight-shared attention + SwiGLU block: one unstacked set
    of weights (no q/k/v bias)."""
    d, dff = cfg.d_model, cfg.d_ff
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def dense(i, o):
        return _dense(trunc, const, (), i, o)

    return {"ln1": const((d,), 1.0), "ln2": const((d,), 1.0),
            "attn": {"q": dense(d, nq * hd), "k": dense(d, nkv * hd),
                     "v": dense(d, nkv * hd), "o": dense(nq * hd, d)},
            "ffn": {"gate": dense(d, dff), "up": dense(d, dff),
                    "down": dense(dff, d)}}


def init_params_numpy(seed: int, cfg: ArchConfig) -> dict:
    """Random parameters as float32 numpy arrays — the JAX package's pytree
    layout, drawn from a numpy generator so a test can hand the same arrays
    to both packages.  Fan-in truncated-normal projections; an MoE block
    holds raw expert stacks (no ``"w"`` level) and a float32 router; the
    recurrent families' small leaves take the reference's init values."""
    _require_supported(cfg)
    rng = np.random.default_rng(seed)
    return _param_tree(
        cfg,
        normal=lambda shape, scale: (rng.standard_normal(shape, dtype=np.float32)
                                     * np.float32(scale)),
        trunc=lambda shape, scale: _trunc_normal(rng, shape, scale),
        const=lambda shape, value: np.full(shape, value, np.float32))


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes (``cfg.param_dtype``; ``convert.F32_LEAVES`` float32), nothing
    allocated."""
    from repro_torch.convert import F32_LEAVES

    _require_supported(cfg)

    def meta(shape, _):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def cast(tree, dtype):
        if isinstance(tree, dict):
            return {k: cast(v, torch.float32 if k in F32_LEAVES else dtype)
                    for k, v in tree.items()}
        return tree.to(dtype)

    return cast(_param_tree(cfg, meta, meta, meta), cfg.pdtype)


def init_params(seed: int, cfg: ArchConfig, device="cuda"):
    """Random parameters on ``device`` in ``cfg.param_dtype``."""
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(init_params_numpy(seed, cfg), cfg, device)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _layer(blocks, li: int):
    """Layer ``li``'s slice of the stacked block parameters (views)."""
    if isinstance(blocks, dict):
        return {k: _layer(v, li) for k, v in blocks.items()}
    return blocks[li]


def _unbind_layers(blocks, n: int) -> list:
    """All ``n`` layers' slices of the stacked block parameters (views), one
    ``unbind`` a leaf: its backward stacks the layers' gradients once, where
    ``n`` separate index views would each scatter into a zero-filled
    gradient of the whole stack (L times the stack's bytes)."""
    if isinstance(blocks, dict):
        per = {k: _unbind_layers(v, n) for k, v in blocks.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(blocks.unbind(0))


def _rope_kw(cfg: ArchConfig, positions3) -> dict:
    """The attention's rotary arguments: m-RoPE at ``positions3`` (at the
    default theta, as the reference rotates it), or RoPE at
    ``cfg.rope_theta``, or none."""
    if cfg.pos == "mrope":
        return dict(rope_theta=None, mrope_sections=cfg.mrope_sections,
                    mrope_positions=positions3)
    return dict(rope_theta=None if cfg.pos == "none" else cfg.rope_theta)


def forward(params, cfg: ArchConfig, *, tokens=None, embeds=None,
            positions=None, positions3=None, collect_cache: bool = False):
    """Prefill forward -> (hidden [B,S,d], (k, v) caches [L,B,S,Hkv,hd] —
    for MLA (c_kv [L,B,S,dc], k_rope [L,B,S,Dr]) — or None).  MoE experts
    run as a batched product of the dense weights, as in the reference.
    An m-RoPE model rotates at ``positions3`` [3, B, S] (temporal, height,
    width), by default ``arange(S)`` on all three axes.  The recurrent
    families' caches are their final states: ssm an ``RWKV6State`` of
    stacked ``[L, ...]`` leaves, hybrid ``{"mamba": [Mamba2State] a layer,
    "attn": [(k, v)] an insertion of the shared block}``, as the
    reference's collect-cache forms give them."""
    _require_supported(cfg)
    if embeds is not None:
        x = embeds.to(cfg.cdtype)
        b, s = x.shape[:2]
    else:
        b, s = tokens.shape
        x = _embed(params, tokens).to(cfg.cdtype)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if cfg.pos == "mrope" and positions3 is None:
        positions3 = torch.arange(s, device=x.device)[None, None].expand(3, b, s)
    if cfg.family in ("ssm", "hybrid"):
        x, cache = _recurrent_forward(params, cfg, x, positions, collect_cache)
        return _norm(cfg, params["final_ln"], x), cache
    rope = _rope_kw(cfg, positions3)

    def block(x, bp):
        if cfg.mla is not None:  # the cache holds (c_kv, k_rope)
            m = cfg.mla
            y, k, v = mla_prefill(
                bp["attn"], _norm(cfg, bp["ln1"], x), positions,
                n_heads=cfg.n_heads, kv_lora=m.kv_lora, qk_nope=m.qk_nope,
                qk_rope=m.qk_rope, v_dim=m.v_dim, rope_theta=cfg.rope_theta,
                q_chunk=cfg.q_chunk)
        else:
            y, k, v = attention_prefill(
                bp["attn"], _norm(cfg, bp["ln1"], x), positions,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                causal=True, window=cfg.attn_window, q_chunk=cfg.q_chunk,
                **rope)
        x = x + y
        return x + _ffn(cfg, bp["ffn"], _norm(cfg, bp["ln2"], x)), k, v

    # training: each layer's activations are recomputed in the backward pass
    # (the reference's jax.checkpoint); serving never builds a graph
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    ks, vs = [], []
    for li, bp in enumerate(_unbind_layers(params["blocks"], cfg.n_layers)):
        if remat:
            x = checkpoint(lambda x, bp: block(x, bp)[0], x, bp,
                           use_reentrant=False)
            continue
        x, k, v = block(x, bp)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = _norm(cfg, params["final_ln"], x)
    cache = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, cache



def _ssm_block(cfg: ArchConfig, x, bp):
    """One rwkv6 block over ``x [B, S, d]``: (x', time-mix state)."""
    y, st = rwkv6_timemix_prefill(bp["tm"], _norm(cfg, bp["ln1"], x),
                                  head_dim=cfg.hd, chunk=cfg.ssm_chunk)
    x = x + y
    y, _ = rwkv6_channelmix(bp["cm"], _norm(cfg, bp["ln2"], x))
    return x + y, st


def _mamba_block(cfg: ArchConfig, x, bp):
    """One mamba2 block over ``x [B, S, d]``: (x', Mamba2State)."""
    sc = cfg.ssm
    y, st = mamba2_prefill(bp["mamba"], _norm(cfg, bp["ln1"], x),
                           d_inner=sc.d_inner, d_state=sc.d_state,
                           head_dim=sc.head_dim, d_conv=sc.d_conv,
                           chunk=cfg.ssm_chunk)
    return x + y, st


def _shared_attn_block(cfg: ArchConfig, p, x, positions):
    """The hybrid's weight-shared attention + SwiGLU block: (x', (k, v))."""
    y, k, v = attention_prefill(
        p["attn"], _norm(cfg, p["ln1"], x), positions, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, head_dim=cfg.hd, causal=True,
        window=cfg.attn_window, rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk)
    x = x + y
    return x + swiglu(p["ffn"], _norm(cfg, p["ln2"], x)), (k, v)


def hybrid_schedule(cfg: ArchConfig) -> list[tuple[str, int]]:
    """The hybrid's depth in order: ``("mamba", layer)`` and ``("shared",
    insertion)`` — ``hybrid_period`` mamba layers then the shared block,
    ``n_layers // hybrid_period`` times, then the tail's mamba layers."""
    period = cfg.hybrid_period
    n_groups = cfg.n_layers // period
    out = []
    for g in range(n_groups):
        out += [("mamba", g * period + i) for i in range(period)]
        out.append(("shared", g))
    out += [("mamba", li) for li in range(n_groups * period, cfg.n_layers)]
    return out


def _recurrent_forward(params, cfg: ArchConfig, x, positions,
                       collect_cache: bool):
    """The ssm and hybrid layer stacks over embedded ``x`` -> (x, cache)."""
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache

    def run(fn, *args):
        if remat:  # the state is not needed in training
            return checkpoint(lambda *a: fn(*a)[0], *args,
                              use_reentrant=False), None
        return fn(*args)

    layers = _unbind_layers(params["blocks"], cfg.n_layers)
    if cfg.family == "ssm":
        states = []
        for bp in layers:
            x, st = run(functools.partial(_ssm_block, cfg), x, bp)
            states.append(st)
        if not collect_cache:
            return x, None
        return x, RWKV6State(wkv=torch.stack([s.wkv for s in states]),
                             x_prev=torch.stack([s.x_prev for s in states]))
    caches = {"mamba": [], "attn": []}
    for kind, i in hybrid_schedule(cfg):
        if kind == "mamba":
            x, st = run(functools.partial(_mamba_block, cfg), x, layers[i])
            caches["mamba"].append(st)
        else:
            x, kv = run(functools.partial(_shared_attn_block, cfg),
                        params["shared_attn"], x, positions)
            caches["attn"].append(kv)
    return x, caches if collect_cache else None

def forward_extend(params, cfg: ArchConfig, tokens, positions, past, last):
    """Prefix-cache tail prefill: run ``tokens`` [B,T] at absolute
    ``positions`` [B,T] attending to a resident per-layer KV prefix.

    ``past`` holds the *gathered* pool views for the cached prefix —
    dense: ``{"k","v": [L,B,C,Hkv,hd], "kpos": [L,B,C]}``; MLA:
    ``{"c_kv","k_rope","kpos"}`` — masked by ``kpos == -1`` (so padding the
    prefix view is harmless).  Padded tail entries carry position ``-1``:
    they are excluded from every real query's key set and their own
    activations stay confined to their row (an MoE block still routes them,
    so they take expert capacity, as in the reference).  ``last`` [B]
    indexes the final real tail token.  Returns ``(logits [B,V] at
    ``last``, tail caches with [L,B,T,...] leaves)`` — only the tail K/V
    (MLA: latents), for scatter into freshly allocated blocks.  Dense
    weights throughout, as the bulk prefill."""
    _require_supported(cfg)
    b, t = tokens.shape
    x = _embed(params, tokens).to(cfg.cdtype)
    positions = positions.long()
    outs = ([], [])
    for li, bp in enumerate(_unbind_layers(params["blocks"], cfg.n_layers)):
        h = _norm(cfg, bp["ln1"], x)
        if cfg.mla is not None:
            m = cfg.mla
            y, a_t, b_t = mla_extend(
                bp["attn"], h, positions, past["c_kv"][li],
                past["k_rope"][li], past["kpos"][li], n_heads=cfg.n_heads,
                qk_nope=m.qk_nope, qk_rope=m.qk_rope, v_dim=m.v_dim,
                rope_theta=cfg.rope_theta)
        else:
            y, a_t, b_t = attention_extend(
                bp["attn"], h, positions, past["k"][li], past["v"][li],
                past["kpos"][li], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.hd,
                rope_theta=None if cfg.pos == "none" else cfg.rope_theta)
        x = x + y
        x = x + _ffn(cfg, bp["ffn"], _norm(cfg, bp["ln2"], x))
        outs[0].append(a_t)
        outs[1].append(b_t)
    names = ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")
    tails = {n: torch.stack(o) for n, o in zip(names, outs)}
    h = x[torch.arange(b, device=x.device), last.long()][:, None]  # [B,1,d]
    h = _norm(cfg, params["final_ln"], h)
    logits = logits_from_hidden(params, cfg, h)[:, 0]
    return logits, tails


def _embed(params, tokens):
    """The embedding rows of ``tokens`` (a partitioned table: this rank's
    rows, all-reduced)."""
    table = params["embed"]
    if isinstance(table, tp.Sharded):
        return tp.embed(table, tokens.long())
    return table[tokens.long()]


def logits_from_hidden(params, cfg: ArchConfig, h):
    if cfg.tie_embeddings:
        table = params["embed"]
        if isinstance(table, tp.Sharded):  # the vocabulary columns gathered
            return tp.linear(h, table.T.to(h.dtype))
        return h @ table.T.to(h.dtype)
    return linear(params["lm_head"], h)


def loss_fn(params, cfg: ArchConfig, batch, *, seq_chunk: int = 512):
    """Sequence-chunked cross-entropy (mean over tokens): the head's logits
    go to float32 one chunk of at most ``seq_chunk`` positions at a time, so
    ``[B, S, V]`` float32 logits are never held at once."""
    h, _ = forward(params, cfg, tokens=batch.get("tokens"),
                   embeds=batch.get("embeds"),
                   positions3=batch.get("positions3"))
    labels = batch["labels"]
    b, s = labels.shape
    c = min(seq_chunk, s)
    while s % c:
        c //= 2
    nc = s // c
    hch = h.reshape(b, nc, c, cfg.d_model)
    lch = labels.reshape(b, nc, c).long()
    tot = 0.0
    for i in range(nc):
        logits = logits_from_hidden(params, cfg, hch[:, i]).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lch[:, i, :, None])[..., 0]
        tot = tot + (lse - gold).sum()
    return tot / (b * s)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def paged_layout(cfg: ArchConfig, smax: int, kv_block: int,
                 kv_blocks: int | None = None, n_slots: int = 1):
    """Resolve paged-KV geometry -> ``(block_size, view_blocks, pool_entries)``.

    Windowed attention shrinks the block so it divides the ring exactly
    (``gcd``), keeping the logical view the same length as the ring — the
    ``pos % eff`` slot arithmetic is unchanged.  ``pool_entries`` counts the
    reserved null block (id 0) and is rounded up to a multiple of 8; without
    ``kv_blocks`` the pool matches the contiguous layout's token capacity
    (one full view per slot).
    """
    w = cfg.attn_window
    eff = min(smax, w) if w is not None else smax
    bs = math.gcd(int(kv_block), eff) if w is not None else min(int(kv_block), eff)
    mb = -(-eff // bs)
    usable = kv_blocks if kv_blocks is not None else n_slots * mb
    if w is not None:
        usable = max(usable, mb)  # a ring slot needs its whole view resident
    entries = -(-(usable + 1) // 8) * 8
    return bs, mb, entries


def init_decode_state(cfg: ArchConfig, batch: int, smax: int, *,
                      kv_block: int | None = None,
                      kv_blocks: int | None = None, device="cuda"):
    """Per-layer decode caches: ``k``/``v`` for GQA, the latents ``c_kv``/
    ``k_rope`` for MLA, and ``kpos``.  The recurrent families keep their
    contiguous states: ssm the wkv state (float32) and the two token
    shifts; hybrid the SSM state (float32) and the conv window a layer and
    the shared block's contiguous KV cache an insertion (``attn_k``/
    ``attn_v``/``attn_kpos``).

    ``kv_block`` switches the attention families to a paged layout:
    per-layer block *pools* ``[L, pool, bs, ...]`` plus one shared block
    table ``[batch, view_blocks]`` (see ``serving.kvpool``).
    """
    _require_supported(cfg)
    L, cd = cfg.n_layers, cfg.cdtype
    z = dict(dtype=cd, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.hd
        return {"wkv": torch.zeros((L, batch, h, cfg.hd, cfg.hd), **f32),
                "x_prev_tm": torch.zeros((L, batch, cfg.d_model), **z),
                "x_prev_cm": torch.zeros((L, batch, cfg.d_model), **z)}
    if cfg.family == "hybrid":
        sc = cfg.ssm
        n_attn = cfg.n_layers // cfg.hybrid_period
        kv = (n_attn, batch, smax, cfg.n_kv_heads, cfg.hd)
        return {"ssm": torch.zeros((L, batch, sc.d_inner // sc.head_dim,
                                    sc.d_state, sc.head_dim), **f32),
                "conv": torch.zeros((L, batch, sc.d_inner + 2 * sc.d_state,
                                     sc.d_conv - 1), **z),
                "attn_k": torch.zeros(kv, **z), "attn_v": torch.zeros(kv, **z),
                "attn_kpos": torch.full((n_attn, batch, smax), -1, **i32)}
    if cfg.mla is not None:
        dc, dr = cfg.mla.kv_lora, cfg.mla.qk_rope
        if kv_block is not None:
            bs, mb, nb = paged_layout(cfg, smax, kv_block, kv_blocks,
                                      n_slots=batch)
            return {"c_kv": torch.zeros((L, nb, bs, dc), **z),
                    "k_rope": torch.zeros((L, nb, bs, dr), **z),
                    "kpos": torch.full((L, batch, mb * bs), -1, **i32),
                    "block_tbl": torch.zeros((batch, mb), **i32)}
        return {"c_kv": torch.zeros((L, batch, smax, dc), **z),
                "k_rope": torch.zeros((L, batch, smax, dr), **z),
                "kpos": torch.full((L, batch, smax), -1, **i32)}
    if kv_block is not None:
        bs, mb, nb = paged_layout(cfg, smax, kv_block, kv_blocks, n_slots=batch)
        return {
            "k": torch.zeros((L, nb, bs, cfg.n_kv_heads, cfg.hd), **z),
            "v": torch.zeros((L, nb, bs, cfg.n_kv_heads, cfg.hd), **z),
            "kpos": torch.full((L, batch, mb * bs), -1, **i32),
            "block_tbl": torch.zeros((batch, mb), **i32),
        }
    w = cfg.attn_window
    eff = min(smax, w) if w is not None else smax
    return {
        "k": torch.zeros((L, batch, eff, cfg.n_kv_heads, cfg.hd), **z),
        "v": torch.zeros((L, batch, eff, cfg.n_kv_heads, cfg.hd), **z),
        "kpos": torch.full((L, batch, eff), -1, **i32),
    }


def _sites_swiglu(executor, tag: str):
    """SwiGLU routed through compressed sites: gate/up (shared input) as ONE
    grouped fused launch, down through its own chain; uncovered sites dense."""
    def ffn(p, x):
        g, u = site_linear_group(executor, (tag.format("gate"), tag.format("up")),
                                 (p["gate"], p["up"]), x)
        return site_linear(executor, tag.format("down"), p["down"],
                           F.silu(g) * u)

    return ffn


def decode_step(params, cfg: ArchConfig, state, token, pos, *, executor=None):
    """One decode step: (logits [B, V], state). token [B,1], pos [B].

    ``state`` is updated in place and returned.

    ``executor`` (compressed serving): a site-keyed registry — see
    ``repro_torch.serving.executor.CompressedExecutor`` — consulted for every
    compressible site (attention q/k/v/o, FFN gate/up/down, MoE experts,
    the recurrent mixes).  Covered sites execute their LCC chains through fused kernel launches;
    sites the executor does not cover fall back to the dense weights.  A
    whole-step layer plan, when the executor offers one, replaces the
    per-layer loop (its MoE layers route inside the step); MLA never has
    one (reason ``"mla"``), and its MoE layers may take a per-layer expert
    plan instead.  The recurrent families never ask for one (the executor
    records ``"family:ssm"`` / ``"family:hybrid"`` when it is built): their
    sites — rwkv6's r/k/v/g (one grouped launch), o, channel-mix k/r (one
    grouped launch) and v; mamba2's in/out projections and the shared
    block's q/k/v, o, gate/up and down — take the per-region route.
    """
    _require_supported(cfg)
    x = _embed(params, token).to(cfg.cdtype)
    mesh = get_mesh()
    if cfg.family == "ssm":
        x = _ssm_decode(params, cfg, state, x, executor, mesh)
        return _decode_logits(params, cfg, x), state
    if cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, state, x, pos, executor, mesh)
        return _decode_logits(params, cfg, x), state
    tbl = state.get("block_tbl")
    # MLA never asks for the whole-step plan (the executor records "mla" when
    # it is built), as in the reference
    plan = (executor.step_plan(cfg)
            if executor is not None and hasattr(executor, "step_plan")
            and cfg.mla is None else None)
    # text-only decode: m-RoPE at the token's position on all three axes
    rope = _rope_kw(cfg, pos.long()[None, :, None].expand(3, -1, 1)
                    if cfg.pos == "mrope" else None)
    kv_split = latent_split = None
    if mesh is not None and cfg.mla is not None:
        seq = state["kpos"].shape[2]
        latent_split = (mesh, *(tp.state_split(
            mesh, (1, 1, seq, width), seq_axis=2, what="MLA latent cache")
            for width in (cfg.mla.kv_lora, cfg.mla.qk_rope)))
    elif mesh is not None:
        kv_split = (mesh, tp.kv_split(mesh, cfg.n_kv_heads, cfg.hd,
                                      state["k"].shape[2]))
    if plan is not None:
        x, state = plan.decode_layers(state, x, pos)
    else:
        for li in range(cfg.n_layers):
            bp = _layer(params["blocks"], li)
            site = f"attn.{{}}.l{li}" if executor is not None else None
            kp = state["kpos"][li]
            if cfg.mla is not None:
                m = cfg.mla
                ck, kr = state["c_kv"][li], state["k_rope"][li]
                cache = (PagedMLACache(c_kv=ck, k_rope=kr, kpos=kp, tbl=tbl)
                         if tbl is not None
                         else MLACache(c_kv=ck, k_rope=kr, kpos=kp))
                y, _ = mla_decode(
                    bp["attn"], _norm(cfg, bp["ln1"], x), cache, pos,
                    n_heads=cfg.n_heads, kv_lora=m.kv_lora, qk_nope=m.qk_nope,
                    qk_rope=m.qk_rope, v_dim=m.v_dim,
                    rope_theta=cfg.rope_theta, executor=executor, site=site,
                    latent_split=latent_split)
            else:
                k, v = state["k"][li], state["v"][li]
                cache = (PagedKVCache(k=k, v=v, kpos=kp, tbl=tbl)
                         if tbl is not None else KVCache(k=k, v=v, kpos=kp))
                y, _ = attention_decode(
                    bp["attn"], _norm(cfg, bp["ln1"], x), cache, pos,
                    n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                    window=cfg.attn_window, **rope,
                    executor=executor, site=site, kv_split=kv_split)
            x = x + y
            x = x + _ffn(cfg, bp["ffn"], _norm(cfg, bp["ln2"], x), executor, li)
    return _decode_logits(params, cfg, x), state


def _decode_logits(params, cfg: ArchConfig, x):
    h = _norm(cfg, params["final_ln"], x)
    return logits_from_hidden(params, cfg, h)[:, 0]


def _whole_at_use(leaf, split):
    """A state leaf gathered whole (rule (b)) when it holds this rank's
    slice (``split`` ``(mesh, dim)``), else the leaf itself."""
    return leaf if split is None else tp.gather_kv(leaf, *split)


def _keep(dst, new, split) -> None:
    """Write the rank's slice of the whole ``new`` into ``dst`` (rule (b)'s
    write-back; all of it unmeshed)."""
    dst.copy_(new if split is None else tp.kv_local(new, *split))


def _split(mesh, shape):
    """``(mesh, dim)`` of a state leaf of whole ``shape`` under ``mesh``
    (None: unmeshed, or no dimension split)."""
    if mesh is None:
        return None
    dim = tp.state_split(mesh, shape)
    return None if dim is None else (mesh, dim)


def _ssm_decode(params, cfg: ArchConfig, state, x, executor, mesh=None):
    """The rwkv6 layers' decode step on ``x [B, 1, d]``; the wkv state and
    both token shifts written in place (the channel mix's shift holds its
    *normed* input, as the reference's does).  Under a mesh the wkv state
    is the rank's rows of the key axis, the token shifts gathered whole at
    use (``tp``'s docstring)."""
    ex = executor is not None
    h, d = cfg.d_model // cfg.hd, cfg.d_model
    wkv_split = _split(mesh, (1, 1, h, cfg.hd, cfg.hd))
    x_split = _split(mesh, (1, 1, d))
    for li in range(cfg.n_layers):
        bp = _layer(params["blocks"], li)
        tm_in = _norm(cfg, bp["ln1"], x)
        y, st = rwkv6_timemix_decode(
            bp["tm"], tm_in, RWKV6State(
                wkv=state["wkv"][li],
                x_prev=_whole_at_use(state["x_prev_tm"][li], x_split)),
            head_dim=cfg.hd, executor=executor,
            site=f"tm.{{}}.l{li}" if ex else None, wkv_split=wkv_split)
        x = x + y
        cm_in = _norm(cfg, bp["ln2"], x)
        y, _ = rwkv6_channelmix(
            bp["cm"], cm_in,
            x_prev_last=_whole_at_use(state["x_prev_cm"][li], x_split),
            executor=executor, site=f"cm.{{}}.l{li}" if ex else None)
        x = x + y
        state["wkv"][li].copy_(st.wkv)
        _keep(state["x_prev_tm"][li], st.x_prev, x_split)
        _keep(state["x_prev_cm"][li], cm_in[:, 0], x_split)
    return x


def _hybrid_decode(params, cfg: ArchConfig, state, x, pos, executor,
                   mesh=None):
    """The hybrid's decode step on ``x [B, 1, d]`` in :func:`hybrid_schedule`
    order; each mamba layer's SSM state and conv window and each insertion's
    KV cache written in place.  Under a mesh the SSM state is the rank's
    slice of one of its axes, the conv window gathered whole at use, the
    shared block's KV cache the rank's slice (``tp``'s docstring)."""
    sc, sp = cfg.ssm, params["shared_attn"]
    ex = executor is not None
    h, cd = sc.d_inner // sc.head_dim, sc.d_inner + 2 * sc.d_state
    ssm_split = _split(mesh, (1, 1, h, sc.d_state, sc.head_dim))
    conv_split = _split(mesh, (1, 1, cd, sc.d_conv - 1))
    kv_split = (None if mesh is None else
                (mesh, tp.kv_split(mesh, cfg.n_kv_heads, cfg.hd,
                                   state["attn_k"].shape[2])))
    for kind, i in hybrid_schedule(cfg):
        if kind == "mamba":
            bp = _layer(params["blocks"], i)
            y, st = mamba2_decode(
                bp["mamba"], _norm(cfg, bp["ln1"], x),
                Mamba2State(ssm=state["ssm"][i],
                            conv=_whole_at_use(state["conv"][i], conv_split)),
                d_inner=sc.d_inner, d_state=sc.d_state, head_dim=sc.head_dim,
                d_conv=sc.d_conv, executor=executor,
                site=f"mamba.{{}}.l{i}" if ex else None, ssm_split=ssm_split)
            state["ssm"][i].copy_(st.ssm)
            _keep(state["conv"][i], st.conv, conv_split)
            x = x + y
            continue
        cache = KVCache(k=state["attn_k"][i], v=state["attn_v"][i],
                        kpos=state["attn_kpos"][i])
        y, _ = attention_decode(
            sp["attn"], _norm(cfg, sp["ln1"], x), cache, pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            window=cfg.attn_window, rope_theta=cfg.rope_theta,
            executor=executor, site="shared_attn.attn.{}" if ex else None,
            kv_split=kv_split)
        x = x + y
        ffn_in = _norm(cfg, sp["ln2"], x)
        x = x + (_sites_swiglu(executor, "shared_attn.ffn.{}")(sp["ffn"], ffn_in)
                 if ex else swiglu(sp["ffn"], ffn_in))
    return x
