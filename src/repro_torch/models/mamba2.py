"""Mamba2 (SSD) layer: chunked state-space duality scan + recurrent decode
(counterpart of ``repro.models.mamba2``).

Faithful to the SSD formulation (Dao & Gu 2024): per-head scalar decay
a_t = exp(dt_t * A_h) with A_h = -exp(A_log_h); within a chunk the output is an
attention-like masked product, across chunks a small state [H, N, P] is carried
(a Python loop over the chunks).  The causal conv is depthwise:
``F.conv1d(groups=Cd)`` in place of the reference's ``conv_general_dilated``.

Decode routes ``in_proj`` and ``out_proj`` through the compressed executor's
chains (one K1 launch each) when it covers them.

Under a serving mesh the parameters may be
:class:`~repro_torch.distributed.tp.Sharded` leaves: the projections go
through :mod:`repro_torch.distributed.tp`, the depthwise conv, ``A_log``,
``D``, ``dt_bias`` and the norm scale are gathered at use; the decode
step's SSM state may hold this rank's slice of one of its axes
(``ssm_split``, rule (a) of ``tp``'s docstring).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp

from .layers import linear, rms_norm, site_fmt, site_linear

__all__ = ["Mamba2State", "mamba2_prefill", "mamba2_decode"]


class Mamba2State(NamedTuple):
    ssm: torch.Tensor  # [B, H, N, P]
    conv: torch.Tensor  # [B, d_conv_in, K-1]  (last K-1 inputs of the causal conv)


def _softplus(x):
    """``log(1 + exp(x))`` as the reference computes it (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(p, x, d_inner, d_state, h, executor=None, site_name=None):
    zxbcdt = site_linear(executor, site_name, p["in_proj"], x)
    return torch.split(zxbcdt, [d_inner, d_inner, d_state, d_state, h], dim=-1)


def _causal_conv(xbc, w, b, prev=None):
    """Depthwise causal conv over time. xbc [B, S, Cd], w [Cd, K]; ``prev``
    [B, Cd, K-1] the inputs before the first (zeros when None)."""
    w, b = tp.whole(w), tp.whole(b)
    k = w.shape[1]
    x = xbc.movedim(-1, 1)  # [B, Cd, S]
    if prev is None:
        x = F.pad(x, (k - 1, 0))
    else:
        x = torch.cat([prev.to(x.dtype), x], dim=-1)
    out = F.conv1d(x, w[:, None, :], groups=w.shape[0])
    out = out + b[None, :, None]
    return out.movedim(1, -1)  # [B, S', Cd]


def _chunk_math(xc, bc, cc, lc, mask, state):
    """One chunk of the scan: outputs ``[B, q, H, P]`` and the state carried
    past the chunk."""
    # intra: y[t] = sum_{s<=t} (C_t.B_s) exp(l_t - l_s) x_s
    cb = torch.einsum("btn,bsn->bts", cc, bc)  # [B,q,q]
    dec = torch.exp(lc[:, :, None, :] - lc[:, None, :, :])  # [B,t,s,H]
    dec = torch.where(mask[None, :, :, None], dec, torch.zeros_like(dec))
    y = torch.einsum("bts,btsh,bshp->bthp", cb, dec, xc)
    # inter: y[t] += C_t . state * exp(l_t)
    y = y + torch.einsum("btn,bhnp,bth->bthp", cc, state, torch.exp(lc))
    # state' = exp(l_q) state + sum_s exp(l_q - l_s) B_s x_s
    ltot = lc[:, -1]  # [B,H]
    snew = torch.einsum("bsn,bshp,bsh->bhnp", bc, xc,
                        torch.exp(ltot[:, None] - lc))
    return y, state * torch.exp(ltot)[:, :, None, None] + snew


def mamba2_prefill(p, x, *, d_inner: int, d_state: int, head_dim: int,
                   d_conv: int, chunk: int = 256):
    """x [B, S, d_model] -> (y [B, S, d_model], final Mamba2State)."""
    b, s, _ = x.shape
    h = d_inner // head_dim
    n, pdim = d_state, head_dim
    z, xc, b_in, c_in, dt = _split_proj(p, x, d_inner, d_state, h)
    conv_in = torch.cat([xc, b_in, c_in], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, b_in, c_in = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)

    dt = _softplus(dt.to(torch.float32) + tp.whole(p["dt_bias"]))  # [B,S,H]
    a = -torch.exp(tp.whole(p["A_log"]))  # [H]
    loga = dt * a[None, None, :]  # log decay (negative)  [B,S,H]
    xh = xs.reshape(b, s, h, pdim).to(torch.float32) * dt[..., None]  # dt folded in
    bh = b_in.to(torch.float32)  # [B,S,N] (n_groups=1, broadcast over heads)
    ch = c_in.to(torch.float32)

    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    xh, bh, ch, loga = (t.reshape(b, nc, q, *t.shape[2:])
                        for t in (xh, bh, ch, loga))
    lcum = torch.cumsum(loga, dim=2)  # [B,nc,q,H]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, h, n, pdim), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        y, state = _chunk_math(xh[:, i], bh[:, i], ch[:, i], lcum[:, i], mask,
                               state)
        ys.append(y)
    y = torch.stack(ys, dim=1)

    y = (y.reshape(b, s, h, pdim)
         + tp.whole(p["D"])[None, None, :, None] * xs.reshape(b, s, h, pdim))
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    tail = conv_in.movedim(1, 2)  # [B, Cd, S]
    conv_tail = (tail[:, :, s - (d_conv - 1):] if s >= d_conv - 1
                 else F.pad(tail, (d_conv - 1 - s, 0)))
    return linear(p["out_proj"], y), Mamba2State(ssm=state, conv=conv_tail)


def mamba2_decode(p, x, state: Mamba2State, *, d_inner: int, d_state: int,
                  head_dim: int, d_conv: int, executor=None,
                  site: str | None = None, ssm_split=None):
    """One-token step. x [B, 1, d_model] -> (y [B, 1, d_model], new state).

    ``executor``/``site``: the in/out projections route through the
    compressed executor's chains (sites ``site.format("in_proj"/"out_proj")``).

    ``ssm_split`` ``(mesh, dim)`` (a serving mesh): ``state.ssm`` holds this
    rank's slice of one axis (``state.conv`` is whole).  Over the state
    axis N (``dim == -2``) the state updates on its rows from the rank's
    slice of B, and ``C . h``, a partial sum over N, is all-reduced over
    "model" before ``+ D x``; over the head_dim P (-1) or the heads H (-3),
    ``y = C . h`` is local there and its slices are gathered.  The new
    SSM state is the rank's slice."""
    b = x.shape[0]
    h = d_inner // head_dim
    sn = site_fmt(site)
    z, xc, b_in, c_in, dt = _split_proj(p, x, d_inner, d_state, h,
                                        executor=executor,
                                        site_name=sn("in_proj"))
    conv_in = torch.cat([xc, b_in, c_in], dim=-1)  # [B,1,Cd]
    win = torch.cat([state.conv, conv_in.movedim(1, 2)], dim=-1)  # [B,Cd,K]
    conv_out = torch.einsum("bck,ck->bc", win.to(torch.float32),
                            tp.whole(p["conv_w"]).to(torch.float32))
    conv_out = F.silu(conv_out + tp.whole(p["conv_b"]).to(torch.float32)
                      )[:, None, :]
    xs, b_i, c_i = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)

    dtv = _softplus(dt[:, 0].to(torch.float32)
                    + tp.whole(p["dt_bias"]))  # [B,H]
    a = torch.exp(dtv * (-torch.exp(tp.whole(p["A_log"]))))  # [B,H]
    xhp = xs[:, 0].reshape(b, h, head_dim).to(torch.float32) * dtv[..., None]
    bn, cn = b_i[:, 0], c_i[:, 0]
    if ssm_split is not None:  # this rank's rows of one state axis
        mesh, dim = ssm_split
        sl = tp.model_slice(mesh, state.ssm.shape[dim])
        if dim == -2:  # N: B's and C's entries
            bn, cn = bn[:, sl], cn[:, sl]
        elif dim == -1:  # P: the inputs' channels
            xhp = xhp[..., sl]
        elif dim == -3:  # H: the heads' inputs and decays
            xhp, a = xhp[:, sl], a[:, sl]
        else:
            raise NotImplementedError(
                f"mamba2: an SSM state split over 'model' on dim {dim} of "
                "[B, H, N, P]")
    ssm = (state.ssm * a[:, :, None, None]
           + torch.einsum("bn,bhp->bhnp", bn, xhp))
    y = torch.einsum("bn,bhnp->bhp", cn, ssm)
    if ssm_split is not None:  # partial sums over N, or the rank's P / H
        y = (tp.model_sum(y, mesh) if dim == -2
             else tp.gather_kv(y, mesh, {-1: -1, -3: -2}[dim]))
    y = y + tp.whole(p["D"])[None, :, None] * xs[:, 0].reshape(b, h, head_dim)
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    return site_linear(executor, sn("out_proj"), p["out_proj"], y), \
        Mamba2State(ssm=ssm, conv=win[:, :, 1:])
