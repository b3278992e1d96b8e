"""Shared model primitives: norms, rotary embeddings, FFNs.

Plain functions on tensors; parameters are nested dicts of tensors.  Compute
dtype and accumulation dtype are explicit (bf16 compute / f32 statistics at
full width, f32 throughout in the reduced configs).

Under a serving mesh a parameter may be a
:class:`~repro_torch.distributed.tp.Sharded` leaf (this rank's chunk and its
spec): :func:`linear` then computes this rank's part through
:mod:`repro_torch.distributed.tp`, and a norm gain or a bias is gathered at
use.  Plain tensors take the code below unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp

__all__ = [
    "linear",
    "matvec_acts",
    "site_fmt",
    "site_linear",
    "site_linear_group",
    "rms_norm",
    "layer_norm",
    "non_parametric_ln",
    "apply_rope",
    "apply_mrope",
    "swiglu",
    "gelu",
    "gelu_mlp",
]


def linear(p, x):
    if isinstance(p["w"], tp.Sharded):
        return tp.linear(x, p["w"], p.get("b"))
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def site_fmt(site):
    """Site-name binder for a format template like ``"attn.{}.l3"`` — returns
    a key -> site-name function (None template => every projection dense)."""
    return (lambda k: site.format(k)) if site is not None else (lambda k: None)


def matvec_acts(fn, x):
    """Run a features-major matvec (x [K, B] -> [N, B]) on [..., d] acts:
    the callable gets the transposed view of the activations in their own
    dtype (it works in float32), and the result comes back in that dtype."""
    lead = x.shape[:-1]
    y = fn(x.reshape(-1, x.shape[-1]).T)
    return y.T.reshape(*lead, -1).to(x.dtype)


def site_linear(executor, name, p, x):
    """``linear(p, x)``, routed through the compressed executor's fused-kernel
    matvec when it covers site ``name`` (dense weights otherwise).

    ``executor`` is duck-typed (see ``repro_torch.serving.executor``): any
    object with ``matvec(name) -> callable | None``.  Bias is applied on top of
    the compressed map — only ``w`` is a compressible site.
    """
    fn = executor.matvec(name) if executor is not None else None
    if fn is None:
        return linear(p, x)
    y = matvec_acts(fn, x)
    if "b" in p:
        y = y + tp.whole(p["b"])
    return y


def site_linear_group(executor, names, ps, xs):
    """Several projections of one *fused region* (attention q/k/v, SwiGLU
    gate/up, RWKV r/k/v/g) in ONE grouped kernel launch when the executor
    covers every site, and per-site :func:`site_linear` otherwise.

    ``xs`` is one activation tensor shared by every site (the region gets
    one transposed view of it for all its members) or a per-site list of
    equally spaced slices of one stacked tensor (``z[g]`` of a contiguous
    ``[G, ..., d]`` buffer; the region gets their transposed views, see
    ``kernels.shared_matmul.region_layout``).  Returns the per-site outputs
    in order.
    """
    shared = isinstance(xs, torch.Tensor)
    xlist = [xs] * len(names) if shared else list(xs)
    fused = executor.grouped(tuple(names)) if executor is not None else None
    if fused is None:
        return [site_linear(executor, n, p, x)
                for n, p, x in zip(names, ps, xlist)]
    x = xlist[0]
    lead = x.shape[:-1]
    ys = fused(x.reshape(-1, x.shape[-1]).T if shared
               else [v.reshape(-1, v.shape[-1]).T for v in xlist])
    outs = []
    for y, p in zip(ys, ps):
        o = y.T.reshape(*lead, -1).to(x.dtype)
        if "b" in p:
            o = o + tp.whole(p["b"])
        outs.append(o)
    return outs


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * tp.whole(w)


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm as the JAX package computes it: the statistics and the
    normalisation in float32, the result cast back to ``x``'s dtype, and only
    then the affine ``* w + b`` in that dtype (``F.layer_norm`` applies the
    affine in float32, which rounds otherwise in bf16)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * tp.whole(w) \
        + tp.whole(b)


def non_parametric_ln(x, eps: float = 1e-5):
    """OLMo-style LayerNorm without learnable affine parameters."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt)


def _rope_sincos(positions, dim: int, theta: float):
    """positions [...]: sin/cos [..., dim/2] in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # [..., half]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x [B, S, H, D], positions [B, S] (absolute)."""
    d = x.shape[-1]
    sin, cos = _rope_sincos(positions, d, theta)  # [B, S, d/2]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, sections: tuple[int, int, int],
                theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE. x [B, S, H, D], positions3 [3, B, S]
    (temporal / height / width position ids); ``sections`` split the D/2
    rotary frequencies among the three axes (sum(sections) == D // 2): band
    ``i`` rotates at the position of the axis its section names."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, half)
    dev = positions3.device
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=dev) / half)
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=dev)
    pos_sel = positions3.to(torch.float32)[sec_id]  # [half, B, S]
    ang = pos_sel.movedim(0, -1) * freqs  # [B, S, half]
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(p, x):
    """SwiGLU FFN: down( silu(gate(x)) * up(x) )."""
    g = linear(p["gate"], x)
    u = linear(p["up"], x)
    return linear(p["down"], F.silu(g) * u)


def gelu(x):
    """GELU in its tanh form, ``jax.nn.gelu``'s default (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(p, x):
    """Two-layer GELU MLP (whisper-style), biases on both layers (a
    partitioned layer through ``tp.linear(x, w, b)``)."""
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))
