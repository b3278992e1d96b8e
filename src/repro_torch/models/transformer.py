"""Decoder backbone — the dense family (olmo-1b and relatives) and the MoE
family (mixtral-8x22b).

Block layout:  dense  x += attn(norm(x));  x += swiglu(norm(x))
               moe    x += attn(norm(x));  x += moe(norm(x))

Parameters are stacked per layer ([L, ...] leaves, the JAX package's scanned
layout) and a Python loop walks the layers, so layer ``li`` binds its own
kernel buffers when a compressed executor is present.  **Decode updates the
KV state in place** (the JAX package returned new arrays and relied on
``donate_argnums``): ``decode_step`` hands back the dict it was given.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .attention import (KVCache, PagedKVCache, attention_decode,
                        attention_prefill)
from .layers import (linear, non_parametric_ln, rms_norm, site_linear,
                     site_linear_group, swiglu)
from .moe import moe_ffn

__all__ = ["init_params", "forward", "logits_from_hidden", "decode_step",
           "init_decode_state", "paged_layout"]


def _norm(cfg: ArchConfig, p, x):
    if cfg.norm == "nonparam":
        return non_parametric_ln(x)
    return rms_norm(x, p)


def _require_supported(cfg: ArchConfig) -> None:
    """The dense and MoE rope/no-position decoders; MLA attention and shared
    experts (deepseek-v2-lite) come with a later slice."""
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not available in this package yet "
            "(the deepseek-v2-lite slice)")
    if cfg.moe is not None and (cfg.moe.n_shared > 0 or cfg.moe_manual):
        raise NotImplementedError(
            f"{cfg.name}: shared experts and the manual expert-parallel MoE "
            "are not available in this package yet (the deepseek-v2-lite "
            "slice; mesh= for moe_manual)")
    if (cfg.family not in ("dense", "moe") or (cfg.family == "moe")
            != (cfg.moe is not None) or cfg.enc_layers > 0
            or cfg.pos not in ("rope", "none")):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and MoE rope/no-position decoder "
            f"families are available in this package (family={cfg.family!r}, "
            f"pos={cfg.pos!r})")


def _ffn(cfg: ArchConfig, p, x, executor=None, li: int | None = None):
    """The block's FFN on ``x [B, S, d]``: SwiGLU, or the routed experts.
    With an executor, layer ``li``'s compressed sites run through it."""
    if cfg.moe is not None:
        kw = ({"executor": executor, "site_tag": f"l{li}"}
              if executor is not None else {})
        y, _ = moe_ffn(p, x, n_experts=cfg.moe.n_experts,
                       top_k=cfg.moe.top_k,
                       capacity_factor=cfg.moe.capacity_factor,
                       norm_topk=cfg.moe.norm_topk, **kw)
        return y
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


def init_params_numpy(seed: int, cfg: ArchConfig) -> dict:
    """Random parameters as float32 numpy arrays — the JAX package's pytree
    layout, drawn from a numpy generator so a test can hand the same arrays
    to both packages.  Fan-in truncated-normal projections; an MoE block
    holds raw expert stacks (no ``"w"`` level) and a float32 router."""
    _require_supported(cfg)
    rng = np.random.default_rng(seed)
    L, d, dff = cfg.n_layers, cfg.d_model, cfg.d_ff
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def dense(i, o, bias=False):
        p = {"w": _trunc_normal(rng, (L, i, o), 1.0 / math.sqrt(i))}
        if bias:
            p["b"] = np.zeros((L, o), np.float32)
        return p

    params: dict[str, Any] = {
        "embed": rng.standard_normal((cfg.vocab, d), dtype=np.float32)
        * np.float32(d ** -0.5),
        "final_ln": np.ones((d,), np.float32),
        "blocks": {
            "ln1": np.ones((L, d), np.float32),
            "ln2": np.ones((L, d), np.float32),
            "attn": {"q": dense(d, nq * hd, cfg.qkv_bias),
                     "k": dense(d, nkv * hd, cfg.qkv_bias),
                     "v": dense(d, nkv * hd, cfg.qkv_bias),
                     "o": dense(nq * hd, d)},
        },
    }
    if cfg.moe is None:
        params["blocks"]["ffn"] = {"gate": dense(d, dff), "up": dense(d, dff),
                                   "down": dense(dff, d)}
    else:
        ne, edff = cfg.moe.n_experts, cfg.moe.d_ff_expert
        params["blocks"]["ffn"] = {
            "router": _trunc_normal(rng, (L, d, ne), 1.0 / math.sqrt(d)),
            "gate": _trunc_normal(rng, (L, ne, d, edff), 1.0 / math.sqrt(d)),
            "up": _trunc_normal(rng, (L, ne, d, edff), 1.0 / math.sqrt(d)),
            "down": _trunc_normal(rng, (L, ne, edff, d), 1.0 / math.sqrt(edff))}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _trunc_normal(rng, (d, cfg.vocab),
                                                1.0 / math.sqrt(d))}
    return params


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


def forward(params, cfg: ArchConfig, *, tokens=None, embeds=None,
            positions=None, collect_cache: bool = False):
    """Prefill forward -> (hidden [B,S,d], (k, v) caches [L,B,S,Hkv,hd] or None).
    MoE experts run as a batched product of the dense weights, as in the
    reference."""
    _require_supported(cfg)
    if embeds is not None:
        x = embeds.to(cfg.cdtype)
        b, s = x.shape[:2]
    else:
        b, s = tokens.shape
        x = params["embed"][tokens.long()].to(cfg.cdtype)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        bp = _layer(params["blocks"], li)
        y, k, v = attention_prefill(
            bp["attn"], _norm(cfg, bp["ln1"], x), positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            causal=True, window=cfg.attn_window,
            rope_theta=None if cfg.pos == "none" else cfg.rope_theta,
            q_chunk=cfg.q_chunk)
        x = x + y
        x = x + _ffn(cfg, bp["ffn"], _norm(cfg, bp["ln2"], x))
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = _norm(cfg, params["final_ln"], x)
    cache = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, cache


def logits_from_hidden(params, cfg: ArchConfig, h):
    if cfg.tie_embeddings:
        return h @ params["embed"].T.to(h.dtype)
    return linear(params["lm_head"], h)


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
    """Per-layer decode caches.

    ``kv_block`` switches to a paged layout: per-layer block *pools*
    ``[L, pool, bs, ...]`` plus one shared block table ``[batch,
    view_blocks]`` (see ``serving.kvpool``).
    """
    _require_supported(cfg)
    L, cd = cfg.n_layers, cfg.cdtype
    z = dict(dtype=cd, device=device)
    i32 = dict(dtype=torch.int32, device=device)
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
    compressible site (attention q/k/v/o, FFN gate/up/down, MoE experts).
    Covered sites execute their LCC chains through fused kernel launches;
    sites the executor does not cover fall back to the dense weights.  A
    whole-step layer plan, when the executor offers one, replaces the
    per-layer loop (its MoE layers route inside the step).
    """
    _require_supported(cfg)
    x = params["embed"][token.long()].to(cfg.cdtype)
    tbl = state.get("block_tbl")
    plan = (executor.step_plan(cfg)
            if executor is not None and hasattr(executor, "step_plan")
            else None)
    if plan is not None:
        x, state = plan.decode_layers(state, x, pos)
    else:
        for li in range(cfg.n_layers):
            bp = _layer(params["blocks"], li)
            k, v, kp = state["k"][li], state["v"][li], state["kpos"][li]
            cache = (PagedKVCache(k=k, v=v, kpos=kp, tbl=tbl)
                     if tbl is not None else KVCache(k=k, v=v, kpos=kp))
            y, _ = attention_decode(
                bp["attn"], _norm(cfg, bp["ln1"], x), cache, pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                window=cfg.attn_window,
                rope_theta=None if cfg.pos == "none" else cfg.rope_theta,
                executor=executor,
                site=f"attn.{{}}.l{li}" if executor is not None else None)
            x = x + y
            x = x + _ffn(cfg, bp["ffn"], _norm(cfg, bp["ln2"], x), executor, li)
    h = _norm(cfg, params["final_ln"], x)
    logits = logits_from_hidden(params, cfg, h)[:, 0]
    return logits, state
