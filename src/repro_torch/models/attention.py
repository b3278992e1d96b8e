"""Attention: GQA (full / sliding-window / bidirectional / cross) and MLA,
prefill and one-token decode.

Written with ``einsum``/``softmax`` as the JAX package writes it (that package
has no attention kernel, so none is ported and no fused library attention is
called).  Prefill is query-chunked (memory O(S * chunk) instead of O(S^2)).

KV caches are named tuples of tensors.  Sliding-window attention uses a ring
buffer of size ``window``; cross-attention (whisper's decoder) reads a static
cache of the encoder's keys and values that decode never writes.  **Decode
updates the cache in place** (the JAX package returned a new cache and
relied on ``donate_argnums`` to reuse the buffer): the tensors handed in are
the ones handed back.

MLA (DeepSeek-V2) caches the compressed KV latent ``c_kv`` and the shared,
not yet rotated rope key ``k_rope`` a token; every step expands the whole
latent view through ``uk``/``uv`` (one grouped launch when compressed), as
the JAX package does.

The prefix cache's tail prefill runs the unmatched tail tokens against a
gathered resident prefix: :func:`attention_extend` (GQA) and
:func:`mla_extend` (MLA).  Padded tail rows sit at position -1; every key is
masked for them, and the finite ``_NEG`` keeps their softmax finite.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed import tp

from .layers import (apply_mrope, apply_rope, linear, site_fmt, site_linear,
                     site_linear_group)

__all__ = [
    "attention_prefill",
    "attention_decode",
    "attention_extend",
    "KVCache",
    "PagedKVCache",
    "paged_view",
    "init_kv_cache",
    "MLACache",
    "PagedMLACache",
    "mla_prefill",
    "mla_decode",
    "mla_extend",
]

_NEG = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, Smax, Hkv, Dh]  (ring buffer if windowed)
    v: torch.Tensor  # [B, Smax, Hkv, Dh]
    kpos: torch.Tensor  # [B, Smax] absolute positions (-1 = empty)


class PagedKVCache(NamedTuple):
    """Paged KV: one block pool per layer plus per-row block tables.

    ``k``/``v`` are the pool slice for this layer; ``tbl[b, j]`` names the
    pool block backing row ``b``'s logical blocks (0 = the reserved null
    block — unallocated, masked out via ``kpos == -1``).  The logical view
    (``tbl`` gathered and flattened) has exactly the contiguous cache's
    layout, so attention math — and its numerics — are unchanged."""
    k: torch.Tensor  # [Nb, bs, Hkv, Dh] block pool (this layer)
    v: torch.Tensor  # [Nb, bs, Hkv, Dh]
    kpos: torch.Tensor  # [B, S] logical positions (-1 = empty), S = mb * bs
    tbl: torch.Tensor  # [B, mb] int block ids


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # [B, Smax, dc] compressed KV latents
    k_rope: torch.Tensor  # [B, Smax, Dr] shared rotary key branch (unrotated)
    kpos: torch.Tensor  # [B, Smax]


class PagedMLACache(NamedTuple):
    c_kv: torch.Tensor  # [Nb, bs, dc] latent block pool (this layer)
    k_rope: torch.Tensor  # [Nb, bs, Dr]
    kpos: torch.Tensor  # [B, S]
    tbl: torch.Tensor  # [B, mb]


def paged_view(pool: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Gather a pool ``[Nb, bs, ...]`` through block tables ``[B, mb]`` into
    the contiguous logical view ``[B, mb * bs, ...]``."""
    b, mb = tbl.shape
    bs = pool.shape[1]
    return pool[tbl.long()].reshape(b, mb * bs, *pool.shape[2:])


def _paged_index(tbl: torch.Tensor, slot: torch.Tensor, bs: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(block, offset) of logical view position ``slot`` ([B], -1 = no write
    -> routed to the null block 0) for pools of ``bs``-token blocks.  The
    clamp is the explicit guard: a negative index would wrap silently."""
    w = slot.clamp(min=0)
    bidx = torch.gather(tbl.long(), 1, (w // bs)[:, None])[:, 0]
    bidx = torch.where(slot >= 0, bidx, torch.zeros_like(bidx))
    return bidx, w % bs


def _paged_scatter(pool: torch.Tensor, tbl: torch.Tensor, slot: torch.Tensor,
                   vals: torch.Tensor) -> None:
    """Write one token per row into the pool, in place, at logical view
    position ``slot`` ([B], -1 = no write -> routed to the null block 0)."""
    bidx, off = _paged_index(tbl, slot, pool.shape[1])
    pool[bidx, off] = vals.to(pool.dtype)


def _row_scatter(buf: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor) -> None:
    """``buf[b, slot[b]] = vals[b]`` in place for rows with ``0 <= slot <
    buf.shape[1]``; the other rows (``slot == -1``, or past the end: the
    JAX package's ``one_hot(slot, smax)`` is all zeros there) rewrite a
    value of their own with itself (no write, no sync)."""
    active = (slot >= 0) & (slot < buf.shape[1])
    safe = slot.clamp(0, buf.shape[1] - 1)
    bi = torch.arange(buf.shape[0], device=buf.device)
    mask = active.reshape(-1, *([1] * (vals.dim() - 1)))
    buf[bi, safe] = torch.where(mask, vals.to(buf.dtype), buf[bi, safe])


def init_kv_cache(batch: int, smax: int, n_kv: int, head_dim: int, dtype,
                  device="cuda") -> KVCache:
    return KVCache(
        k=torch.zeros((batch, smax, n_kv, head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, smax, n_kv, head_dim), dtype=dtype, device=device),
        kpos=torch.full((batch, smax), -1, dtype=torch.int32, device=device),
    )


def _sdpa(q, k, v, mask):
    """q [B,Sq,Hkv,G,D], k/v [B,Sk,Hkv,D], additive mask [B,1,1,Sq,Sk] or None."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))


def attention_prefill(
    p, x, positions, *, n_heads: int, n_kv: int, head_dim: int,
    causal: bool = True, window: int | None = None,
    rope_theta: float | None = 10000.0, mrope_sections=None,
    mrope_positions=None, q_chunk: int = 1024,
    kv_x: torch.Tensor | None = None,
):
    """Returns (out [B,S,d_model], k, v) — k/v rotary-encoded, as cached.
    With ``mrope_sections`` q and k take m-RoPE at ``mrope_positions``
    [3, B, S] (at the default theta, as the JAX package rotates them).

    ``kv_x`` [B, Sk, d] switches to cross-attention: k and v come from it
    (rotated, where rope is on, at ``arange(Sk)``) and no query is masked,
    whatever ``causal`` says."""
    b, s, _ = x.shape
    g = n_heads // n_kv
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    q = linear(p["q"], x).reshape(b, s, n_heads, head_dim)
    k = linear(p["k"], src).reshape(b, sk, n_kv, head_dim)
    v = linear(p["v"], src).reshape(b, sk, n_kv, head_dim)
    if mrope_sections is not None:
        q = apply_mrope(q, mrope_positions, mrope_sections)
        k = apply_mrope(k, mrope_positions, mrope_sections)
    elif rope_theta is not None:
        kpos = (positions if kv_x is None else
                torch.arange(sk, device=x.device)[None].expand(b, sk))
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kpos, rope_theta)
    qg = q.reshape(b, s, n_kv, g, head_dim)
    kpos_all = torch.arange(sk, device=x.device)

    def chunk_out(q_c, qpos_c):
        if not causal or kv_x is not None:
            return _sdpa(q_c, k, v, None)
        m = kpos_all[None, :] <= qpos_c[:, None]
        if window is not None:
            m = m & (kpos_all[None, :] > qpos_c[:, None] - window)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = torch.where(m, zero, zero + _NEG)[None, None, None]
        return _sdpa(q_c, k, v, mask)

    n_chunks = max(1, s // q_chunk) if s % q_chunk == 0 else 1
    cq = s // n_chunks
    out = torch.cat([chunk_out(qg[:, i * cq:(i + 1) * cq],
                               positions[0, i * cq:(i + 1) * cq])
                     for i in range(n_chunks)], dim=1)
    out = out.reshape(b, s, n_heads * head_dim)
    return linear(p["o"], out.to(x.dtype)), k, v


def attention_decode(
    p, x, cache, pos, *, n_heads: int, n_kv: int, head_dim: int,
    window: int | None = None, rope_theta: float | None = 10000.0,
    mrope_sections=None, mrope_positions=None, cross: bool = False,
    executor=None, site: str | None = None, kv_split=None,
):
    """One-token decode. x [B,1,d]; pos [B] absolute position of this token
    (with ``mrope_sections``, q and the new k take m-RoPE at
    ``mrope_positions`` [3, B, 1] instead).

    Returns (out [B,1,d], cache) — the cache is the one passed in, updated in
    place.  With ``window`` the cache is a ring buffer (slot = pos % window).
    ``cross=True`` reads a static cross-attention cache (``cache.k``/
    ``cache.v`` over the encoder's positions): q alone goes through its
    site, the cache is returned untouched and no key is masked.

    ``executor``/``site`` (compressed serving): q/k/v/o route through the
    executor's fused LCC kernels — q/k/v as ONE grouped launch (they share the
    input) — for sites named ``site.format(proj)``; uncovered sites stay
    dense.

    ``cache`` may be a :class:`PagedKVCache`: keys/values then live in a block
    pool indexed through per-row block tables.  The new token is scattered
    into its pool block and the gathered logical view has the contiguous
    layout (same positions, same mask math).

    A row with ``pos == -1`` (serving's idle-slot sentinel) writes nothing:
    contiguous caches rewrite the old value, paged caches sink the write into
    the null block, and ``kpos`` keeps -1 so nothing attends to it.  Nor
    does a contiguous, unwindowed row at ``pos >= Smax`` (as in the JAX
    package: whisper's self-KV holds ``max_decoder_len`` rows): it attends
    to the rows already cached.

    ``kv_split`` ``(mesh, dim)`` (a serving mesh): the cache holds this
    rank's slice of the keys and values along ``dim`` (-1 head_dim, -2 the
    kv heads); the new row is rotated whole, its slice written, and the
    attention runs through :func:`repro_torch.distributed.tp.attend`.
    """
    b = x.shape[0]
    pos = pos.long()
    paged = isinstance(cache, PagedKVCache)
    sn = site_fmt(site)
    if cross:
        q_raw = site_linear(executor, sn("q"), p["q"], x)
    else:
        q_raw, k_raw, v_raw = site_linear_group(
            executor, (sn("q"), sn("k"), sn("v")), (p["q"], p["k"], p["v"]), x)
    q = q_raw.reshape(b, 1, n_heads, head_dim)
    if mrope_sections is not None:
        q = apply_mrope(q, mrope_positions, mrope_sections)
    elif rope_theta is not None:
        q = apply_rope(q, pos[:, None], rope_theta)
    g = n_heads // n_kv
    qg = q.reshape(b, 1, n_kv, g, head_dim)
    if cross:
        out = _sdpa(qg, cache.k, cache.v, None).reshape(b, 1, n_heads * head_dim)
        return site_linear(executor, sn("o"), p["o"], out.to(x.dtype)), cache
    k_new = k_raw.reshape(b, 1, n_kv, head_dim)
    v_new = v_raw.reshape(b, 1, n_kv, head_dim)
    if mrope_sections is not None:
        k_new = apply_mrope(k_new, mrope_positions, mrope_sections)
    elif rope_theta is not None:
        k_new = apply_rope(k_new, pos[:, None], rope_theta)
    smax = cache.kpos.shape[1]
    # negative pos must stay out of the ring too: plain pos % smax would wrap
    # -1 onto a live cache entry
    if window is not None:
        slot = torch.where(pos >= 0, pos % smax, torch.full_like(pos, -1))
    else:
        slot = pos
    k_w, v_w = k_new[:, 0], v_new[:, 0]
    if kv_split is not None:
        k_w, v_w = (tp.kv_local(t, *kv_split) for t in (k_w, v_w))
    if paged:
        _paged_scatter(cache.k, cache.tbl, slot, k_w)
        _paged_scatter(cache.v, cache.tbl, slot, v_w)
        k = paged_view(cache.k, cache.tbl)
        v = paged_view(cache.v, cache.tbl)
    else:
        _row_scatter(cache.k, slot, k_w)
        _row_scatter(cache.v, slot, v_w)
        k, v = cache.k, cache.v
    _row_scatter(cache.kpos, slot, pos.to(cache.kpos.dtype))
    kpos = cache.kpos
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if window is not None:
        valid = valid & (kpos > (pos[:, None] - window))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(valid, zero, zero + _NEG)[:, None, None, None, :]
    out = (_sdpa(qg, k, v, mask) if kv_split is None
           else tp.attend(qg, k, v, mask, *kv_split))
    out = out.reshape(b, 1, n_heads * head_dim)
    return site_linear(executor, sn("o"), p["o"], out.to(x.dtype)), cache


def _extend_mask(kpos: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Additive causal mask ``[B,1,1,T,C+T]`` of tail queries at
    ``positions`` [B,T] over keys at ``kpos`` [B,C+T] (-1 = padding)."""
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= positions[:, :, None])
    zero = torch.zeros((), dtype=torch.float32, device=kpos.device)
    return torch.where(valid, zero, zero + _NEG)[:, None, None]


def attention_extend(p, x, positions, past_k, past_v, past_kpos, *,
                     n_heads: int, n_kv: int, head_dim: int,
                     rope_theta: float | None = 10000.0):
    """Prefill continuation against a resident KV prefix (prefix-cache hit).

    ``x`` [B,T,d] are the unmatched tail tokens at absolute ``positions``
    [B,T]; ``past_k``/``past_v`` [B,C,Hkv,Dh] is the gathered prefix (already
    rotary-encoded at its own positions, exactly as the pool stores it) with
    validity mask ``past_kpos`` [B,C] (-1 = padding).  Returns
    ``(out [B,T,d], k_tail, v_tail)`` — only the tail K/V, for scatter into
    freshly allocated blocks.  Causal, non-windowed."""
    b, t, _ = x.shape
    g = n_heads // n_kv
    positions = positions.long()
    q = linear(p["q"], x).reshape(b, t, n_heads, head_dim)
    k_t = linear(p["k"], x).reshape(b, t, n_kv, head_dim)
    v_t = linear(p["v"], x).reshape(b, t, n_kv, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k_t = apply_rope(k_t, positions, rope_theta)
    k = torch.cat([past_k, k_t], dim=1)
    v = torch.cat([past_v, v_t], dim=1)
    kpos = torch.cat([past_kpos.long(), positions], dim=1)  # [B, C+T]
    qg = q.reshape(b, t, n_kv, g, head_dim)
    out = _sdpa(qg, k, v, _extend_mask(kpos, positions))
    out = out.reshape(b, t, n_heads * head_dim)
    return linear(p["o"], out.to(x.dtype)), k_t, v_t


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV cache
# ---------------------------------------------------------------------------


def _mla_qkv(p, x, c_kv, k_rope_src, positions, kpositions, n_heads, qk_nope,
             qk_rope, v_dim, rope_theta, executor=None, site=None):
    """Queries, keys and values of every head from the latent view: ``q``
    rotated at ``positions``, the rope key at ``kpositions`` (shared across
    heads, broadcast after rotation)."""
    b, s, _ = x.shape
    sk = c_kv.shape[1]
    sn = site_fmt(site)
    q = site_linear(executor, sn("q"), p["q"], x).reshape(
        b, s, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    # uk/uv share the latent-cache input: one grouped launch when compressed
    uk, uv = site_linear_group(executor, (sn("uk"), sn("uv")),
                               (p["uk"], p["uv"]), c_kv)
    k_nope = uk.reshape(b, sk, n_heads, qk_nope)
    v = uv.reshape(b, sk, n_heads, v_dim)
    k_rope = apply_rope(k_rope_src[:, :, None, :], kpositions, rope_theta)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, sk, n_heads, qk_rope)], dim=-1)
    return q_full, k_full, v


def mla_prefill(p, x, positions, *, n_heads, kv_lora, qk_nope, qk_rope, v_dim,
                rope_theta=10000.0, q_chunk: int = 1024):
    """Returns (out [B,S,d_model], c_kv [B,S,dc], k_rope [B,S,Dr]) — the
    latents as cached (the rope branch unrotated)."""
    b, s, _ = x.shape
    c_kv = linear(p["dkv"], x)
    k_rope_src = linear(p["kr"], x)
    q, k, v = _mla_qkv(p, x, c_kv, k_rope_src, positions, positions, n_heads,
                       qk_nope, qk_rope, v_dim, rope_theta)
    # MLA heads are full multi-head (n_kv == n_heads): the GQA path, G = 1
    qg = q.reshape(b, s, n_heads, 1, qk_nope + qk_rope)
    kpos_all = torch.arange(s, device=x.device)

    def chunk_out(q_c, qpos_c):
        m = kpos_all[None, :] <= qpos_c[:, None]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = torch.where(m, zero, zero + _NEG)[None, None, None]
        return _sdpa(q_c, k, v, mask)

    n_chunks = max(1, s // q_chunk) if s % q_chunk == 0 else 1
    cq = s // n_chunks
    out = torch.cat([chunk_out(qg[:, i * cq:(i + 1) * cq],
                               positions[0, i * cq:(i + 1) * cq])
                     for i in range(n_chunks)], dim=1)
    out = out.reshape(b, s, n_heads * v_dim)
    return linear(p["o"], out.to(x.dtype)), c_kv, k_rope_src


def mla_decode(p, x, cache, pos, *, n_heads, kv_lora, qk_nope, qk_rope, v_dim,
               rope_theta=10000.0, executor=None, site: str | None = None):
    """One-token MLA decode. x [B,1,d]; pos [B] (-1 = idle slot).

    Returns (out [B,1,d], cache) — the cache passed in, updated in place:
    the new latent and rope rows go to the row's slot ``pos`` (contiguous)
    or its pool block (:class:`PagedMLACache`, through the block table),
    then the whole latent view is expanded.  An idle row writes nothing, as
    in :func:`attention_decode` (the JAX package's ``one_hot(-1)`` is all
    zeros; here every write is guarded).  Keys are rotated at
    ``max(kpos, 0)``."""
    b = x.shape[0]
    pos = pos.long()
    paged = isinstance(cache, PagedMLACache)
    sn = site_fmt(site)
    c_new, kr_new = site_linear_group(executor, (sn("dkv"), sn("kr")),
                                      (p["dkv"], p["kr"]), x)  # [B,1,dc/Dr]
    if paged:
        _paged_scatter(cache.c_kv, cache.tbl, pos, c_new[:, 0])
        _paged_scatter(cache.k_rope, cache.tbl, pos, kr_new[:, 0])
        c_kv = paged_view(cache.c_kv, cache.tbl)
        k_rope = paged_view(cache.k_rope, cache.tbl)
    else:
        _row_scatter(cache.c_kv, pos, c_new[:, 0])
        _row_scatter(cache.k_rope, pos, kr_new[:, 0])
        c_kv, k_rope = cache.c_kv, cache.k_rope
    _row_scatter(cache.kpos, pos, pos.to(cache.kpos.dtype))
    kpos = cache.kpos
    q, k, v = _mla_qkv(p, x, c_kv, k_rope, pos[:, None], kpos.clamp(min=0),
                       n_heads, qk_nope, qk_rope, v_dim, rope_theta,
                       executor=executor, site=site)
    qg = q.reshape(b, 1, n_heads, 1, qk_nope + qk_rope)
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(valid, zero, zero + _NEG)[:, None, None, None, :]
    out = _sdpa(qg, k, v, mask)
    out = out.reshape(b, 1, n_heads * v_dim)
    return site_linear(executor, sn("o"), p["o"], out.to(x.dtype)), cache


def mla_extend(p, x, positions, past_c, past_kr, past_kpos, *, n_heads,
               qk_nope, qk_rope, v_dim, rope_theta=10000.0):
    """MLA prefill continuation against a resident latent prefix.

    ``past_c`` [B,C,dc] / ``past_kr`` [B,C,Dr] are the gathered compressed-KV
    prefix (pool layout: the rope branch unrotated, the latent as stored),
    masked by ``past_kpos`` [B,C].  Returns ``(out, c_tail, kr_tail)``."""
    b, t, _ = x.shape
    positions = positions.long()
    c_t = linear(p["dkv"], x)  # [B,T,dc]
    kr_t = linear(p["kr"], x)  # [B,T,Dr]
    c_all = torch.cat([past_c, c_t], dim=1)
    kr_all = torch.cat([past_kr, kr_t], dim=1)
    kpos = torch.cat([past_kpos.long(), positions], dim=1)  # [B, C+T]
    q, k, v = _mla_qkv(p, x, c_all, kr_all, positions, kpos.clamp(min=0),
                       n_heads, qk_nope, qk_rope, v_dim, rope_theta)
    qg = q.reshape(b, t, n_heads, 1, qk_nope + qk_rope)
    out = _sdpa(qg, k, v, _extend_mask(kpos, positions))
    out = out.reshape(b, t, n_heads * v_dim)
    return linear(p["o"], out.to(x.dtype)), c_t, kr_t
