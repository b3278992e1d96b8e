"""RWKV-6 "Finch": time-mix with data-dependent per-channel decay + channel-mix
(counterpart of ``repro.models.rwkv6``).

Recurrence (per head, state S in R^{K x V}, before-token convention):
    y_t = r_t . (S_t + diag(u) k_t^T v_t)
    S_{t+1} = diag(w_t) S_t + k_t^T v_t
with w_t = exp(-exp(w0 + lora_w(x_t)))  (data-dependent decay, the Finch
novelty) and token-shift ddlerp mixing on every projection input.

Prefill uses a chunked formulation: within a chunk the pairwise term is a
masked matmul on decay-normalized keys/queries; across chunks the [B, H, K, V]
state is carried (a Python loop over the chunks).  The LoRA products
(``mix_A``/``mix_B``, ``wA``/``wB``) are small plain products, outside any
kernel in the reference too.

Decode routes r/k/v/g through ONE grouped launch of the compressed executor:
their four distinct token-shifted inputs are laid out as equally spaced
slices of one stacked ``[4, B, 1, d]`` buffer (the layout the region prep
takes for a stack of experts); ``o`` runs through its own chain.

Under a serving mesh the parameters may be
:class:`~repro_torch.distributed.tp.Sharded` leaves: the products go
through :mod:`repro_torch.distributed.tp` (``mix_B``'s five matrices as an
expert stack), the mixes, decays, bonus and norm scale are gathered at use;
the decode step's wkv state may hold this rank's rows of the key axis
(``wkv_split``, rule (a) of ``tp``'s docstring).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp

from .layers import linear, site_fmt, site_linear, site_linear_group

__all__ = ["RWKV6State", "rwkv6_timemix_prefill", "rwkv6_timemix_decode",
           "rwkv6_channelmix", "MIX", "LORA_MIX", "LORA_W"]

MIX = ("r", "k", "v", "w", "g")
_GROUPED = (0, 1, 2, 4)  # r, k, v, g: the projections of the grouped launch
LORA_MIX = 32  # the reference's init_rwkv6 defaults
LORA_W = 64


class RWKV6State(NamedTuple):
    wkv: torch.Tensor  # [B, H, K, V]
    x_prev: torch.Tensor  # [B, d_model]  (time-mix token shift)


def _mm(x, w):
    """``x @ w`` for a plain or a partitioned ``w``."""
    return linear({"w": w}, x)


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift: the mixed inputs ``[..., 5, d]`` of the
    five projections (r, k, v, w, g)."""
    delta = x_prev - x
    lora = torch.tanh(_mm(x, p["mix_A"]))  # [B,S,5*lm]
    lora = lora.reshape(*x.shape[:-1], len(MIX), -1)
    if isinstance(p["mix_B"], tp.Sharded):  # [5, lm, d]: an expert stack
        z = lora.reshape(-1, len(MIX), lora.shape[-1]).transpose(0, 1)
        dd = tp.expert_matmul(z, p["mix_B"].to(x.dtype)).transpose(0, 1)
        dd = dd.reshape(*lora.shape[:-1], -1)
    else:
        dd = torch.einsum("bsmi,mid->bsmd", lora, p["mix_B"].to(x.dtype))
    mu = tp.whole(p["mix_mu"]).to(x.dtype)  # [5, d]
    return x[..., None, :] + delta[..., None, :] * (mu + dd)


def _group_norm_heads(x, w, h, eps=64e-5):
    """Per-head LayerNorm of the wkv output (RWKV's ln_x)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, h, d // h).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, s, d) * w).to(x.dtype)


def _log_decay(p, xw):
    """``-exp(w0 + lora_w(xw))`` in float32: the log of the decay, < 0."""
    lw = _mm(torch.tanh(_mm(xw, p["wA"])), p["wB"]).to(torch.float32)
    return -torch.exp(tp.whole(p["w0"]) + lw)


def _chunk_math(rc, kc, vc, lc, lw, st, u, mask):
    """One chunk of the prefill: outputs ``[B, q, H, V]`` and the state
    carried past the chunk."""
    # rq_t = r_t * exp(l_{t-1});  ks_s = k_s * exp(-l_s)
    lprev = lc - lw  # l_{t-1} = cumsum up to t-1
    rq = rc * torch.exp(lprev)
    ks = kc * torch.exp(-lc)
    score = torch.einsum("bthk,bshk->bhts", rq, ks)
    score = torch.where(mask[None, None], score, torch.zeros_like(score))
    y = torch.einsum("bhts,bshv->bthv", score, vc)
    # bonus diagonal term: y_t += (r_t . (u * k_t)) v_t
    y = y + torch.einsum("bthk,hk->bth", rc * kc, u)[..., None] * vc
    # inter-chunk: y_t += (r_t * exp(l_{t-1})) . state
    y = y + torch.einsum("bthk,bhkv->bthv", rq, st)
    # state' = diag(exp(l_Q)) state + sum_s exp(l_Q - l_s) k_s v_s
    lq = lc[:, -1]  # [B,H,K]
    kdec = kc * torch.exp(lq[:, None] - lc)
    st = st * torch.exp(lq)[..., None] + torch.einsum("bshk,bshv->bhkv", kdec, vc)
    return y, st


def rwkv6_timemix_prefill(p, x, *, head_dim: int, chunk: int = 256,
                          state: RWKV6State | None = None):
    """x [B, S, d] -> (y [B, S, d], final RWKV6State).  The chunk is the
    largest power-of-two fraction of ``min(chunk, S)`` that divides S."""
    b, s, d = x.shape
    h = d // head_dim
    first = (state.x_prev[:, None] if state is not None
             else torch.zeros((b, 1, d), dtype=x.dtype, device=x.device))
    mixed = _ddlerp(p, x, torch.cat([first, x[:, :-1]], dim=1))
    xr, xk, xv, xw, xg = mixed.unbind(-2)

    r = linear(p["r"], xr).reshape(b, s, h, head_dim).to(torch.float32)
    k = linear(p["k"], xk).reshape(b, s, h, head_dim).to(torch.float32)
    v = linear(p["v"], xv).reshape(b, s, h, head_dim).to(torch.float32)
    g = F.silu(linear(p["g"], xg))
    logw = _log_decay(p, xw).reshape(b, s, h, head_dim)

    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    r, k, v, logw = (t.reshape(b, nc, q, h, head_dim) for t in (r, k, v, logw))
    lcum = torch.cumsum(logw, dim=2)  # [B,nc,q,H,K]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device), -1)
    u = tp.whole(p["u"])
    st = (state.wkv.to(torch.float32) if state is not None
          else torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                           device=x.device))
    ys = []
    for i in range(nc):
        y, st = _chunk_math(r[:, i], k[:, i], v[:, i], lcum[:, i], logw[:, i],
                            st, u, mask)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, s, d).to(x.dtype)
    y = _group_norm_heads(y, tp.whole(p["ln_w"]), h) * g
    return linear(p["o"], y), RWKV6State(wkv=st, x_prev=x[:, -1])


def rwkv6_timemix_decode(p, x, state: RWKV6State, *, head_dim: int,
                         executor=None, site: str | None = None,
                         wkv_split=None):
    """One-token step. x [B, 1, d] -> (y [B, 1, d], new RWKV6State).

    ``executor``/``site``: the r/k/v/g projections run through the
    compressed executor as ONE grouped launch (their token-shifted inputs
    stacked along the group axis) and ``o`` through its own chain.

    ``wkv_split`` ``(mesh, dim)`` (a serving mesh): ``state.wkv`` holds this
    rank's rows of the key axis (``dim == -2``; ``state.x_prev`` is whole):
    the state updates on them from the rank's slice of r, k, the decay and
    the bonus, and ``r . S``, a partial sum over keys, is all-reduced over
    "model" before the group norm.  The new state is the rank's rows."""
    b, _, d = x.shape
    h = d // head_dim
    sn = site_fmt(site)
    mixed = _ddlerp(p, x, state.x_prev[:, None])  # [B,1,5,d]
    xw = mixed[..., 3, :]
    # r, k, v, g as four equally spaced slices of one [4, B, 1, d] buffer
    stacked = torch.stack([mixed[..., i, :] for i in _GROUPED])
    rr, kk, vv, gg = site_linear_group(
        executor, (sn("r"), sn("k"), sn("v"), sn("g")),
        (p["r"], p["k"], p["v"], p["g"]), list(stacked))
    r = rr.reshape(b, h, head_dim).to(torch.float32)
    k = kk.reshape(b, h, head_dim).to(torch.float32)
    v = vv.reshape(b, h, head_dim).to(torch.float32)
    g = F.silu(gg)
    w = torch.exp(_log_decay(p, xw)).reshape(b, 1, h, head_dim)[:, 0]
    u = tp.whole(p["u"])

    wkv = state.wkv.to(torch.float32)
    if wkv_split is not None:  # this rank's rows of the key axis
        mesh, dim = wkv_split
        if dim != -2:
            raise NotImplementedError(
                f"rwkv6: a wkv state split over 'model' on dim {dim} of "
                "[B, H, K, V] (the step splits the key axis, -2)")
        sl = tp.model_slice(mesh, wkv.shape[-2])
        r, k, w, u = r[..., sl], k[..., sl], w[..., sl], u[..., sl]
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    y = torch.einsum("bhk,bhkv->bhv", r, wkv + u[..., None] * kv)
    if wkv_split is not None:  # partial sums over the keys
        y = tp.model_sum(y, wkv_split[0])
    wkv = wkv * w[..., None] + kv
    y = y.reshape(b, 1, d).to(x.dtype)
    y = _group_norm_heads(y, tp.whole(p["ln_w"]), h) * g
    return site_linear(executor, sn("o"), p["o"], y), \
        RWKV6State(wkv=wkv, x_prev=x[:, 0])


def rwkv6_channelmix(p, x, x_prev_last=None, *, executor=None,
                     site: str | None = None):
    """Squared-ReLU channel mix with token shift. Returns (y, last token x).

    ``executor``/``site``: k/r (one shared token-shifted input) run as one
    grouped launch, v through its own chain; dense weights otherwise."""
    b, s, d = x.shape
    sn = site_fmt(site)
    first = (x_prev_last[:, None] if x_prev_last is not None
             else torch.zeros((b, 1, d), dtype=x.dtype, device=x.device))
    xp = torch.cat([first, x[:, :-1]], dim=1)
    mu = tp.whole(p["mix_mu_k"]).to(x.dtype)
    xk = x + (xp - x) * mu
    k_out, r_out = site_linear_group(executor, (sn("k"), sn("r")),
                                     (p["k"], p["r"]), xk)
    kk = torch.square(F.relu(k_out))
    rr = torch.sigmoid(r_out)
    v_out = site_linear(executor, sn("v"), p["v"], kk)
    return rr * v_out, x[:, -1]
