"""Mixture-of-experts FFN with capacity-bounded dispatch (GShard-style).

Port of ``repro.models.moe.moe_ffn``.  Tokens are routed top-k, each
(token, choice) gets a rank in its expert's queue, and the kept ones are
scattered into an ``[E, C, d]`` buffer, so the experts run as one batched
product (or, under a compressed executor, one grouped kernel launch a
projection).  The routing math is ``kernels.moe_route.route_tokens`` — the
same function the whole-step plan's plain version uses — and keeps the
reference's semantics exactly: the router runs in float32 on upcast
activations, ties go to the lower expert index, the capacity is Python's
``round`` of ``T * k * cf / E`` (at least ``min_capacity``), empty expert
slots are still evaluated.  Shared (always-on) experts are one SwiGLU of
``n_shared * d_ff`` columns added after the gated combine, as in the
reference.

Not carried over: the manual shard_map variant (``moe_manual``, reached only
with ``mesh=``) and the router's auxiliary training losses.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_route import capacity, route_tokens

from .layers import site_linear, site_linear_group, swiglu

__all__ = ["moe_ffn"]


def moe_ffn(p, x, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, norm_topk: bool = True,
            min_capacity: int = 4, executor=None,
            site_tag: str | None = None):
    """x [B, S, d] -> (y [B, S, d], aux dict with router stats).

    ``p``: ``router [d, E]`` (float32), ``gate``/``up`` ``[E, d, dff]``,
    ``down`` ``[E, dff, d]``, and optionally ``shared`` (``gate``/``up``/
    ``down`` ``{"w": ...}`` of ``n_shared * dff`` columns).
    ``executor``/``site_tag`` (compressed serving): the executor's per-layer
    expert plan (``moe_plan``, K9) when it offers one; otherwise each
    projection's per-expert products run as ONE grouped launch over all
    experts (sites ``moe.{proj}.{site_tag}.e{e}``) when the executor covers
    them all, as a batched product of the dense weights otherwise.  Shared
    experts route through their own sites (``moe.shared.{proj}.{site_tag}``:
    gate+up one grouped launch, down one chain).  ``aux``:
    ``router_probs_mean``, ``dropped_frac`` and ``sel`` as in the reference,
    plus ``keep`` (which choices got a slot)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    cap = capacity(t, top_k, capacity_factor, n_experts, min_capacity)
    probs, gates, sel, keep, slot = route_tokens(
        xt.to(torch.float32), p["router"].to(torch.float32), top_k=top_k,
        cap=cap, norm_topk=norm_topk)
    if executor is not None and hasattr(executor, "count_moe_drops"):
        executor.count_moe_drops(keep)
    plan = None
    if executor is not None and site_tag is not None and hasattr(
            executor, "moe_plan"):
        plan = executor.moe_plan(site_tag, n_experts=n_experts, d_model=d,
                                 d_ff=p["gate"].shape[-1])

    # scatter-add into the slots; row E * C takes the dropped choices
    buf = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        buf.index_add_(0, slot[:, j], xt)
    buf = buf[:-1].reshape(n_experts, cap, d)

    def expert_mm(proj, z):
        """z [E, C, d_in] @ p[proj] [E, d_in, d_out] -> [E, C, d_out]."""
        fused = None
        if executor is not None and site_tag is not None:
            fused = executor.grouped(tuple(
                f"moe.{proj}.{site_tag}.e{e}" for e in range(n_experts)))
        if fused is None:
            return torch.einsum("ecd,edf->ecf", z, p[proj])
        # one view an expert into the stacked [E, C, d_in] buffer
        ys = fused([z[e].T for e in range(n_experts)])
        return torch.stack([y.T for y in ys]).to(z.dtype)

    if plan is not None:
        # all experts' gate/up, SwiGLU and down in one plan call (K9)
        out_buf = plan(buf).reshape(n_experts * cap, d)
    else:
        h = F.silu(expert_mm("gate", buf)) * expert_mm("up", buf)
        out_buf = expert_mm("down", h).reshape(n_experts * cap, d)

    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        gathered = out_buf[torch.clamp(slot[:, j], max=n_experts * cap - 1)]
        w = (gates[:, j] * keep[:, j]).to(x.dtype)[:, None]
        y = y + w * gathered
    if "shared" in p:
        sp = p["shared"]
        if executor is not None and site_tag is not None:
            sg, su = site_linear_group(
                executor, (f"moe.shared.gate.{site_tag}",
                           f"moe.shared.up.{site_tag}"),
                (sp["gate"], sp["up"]), xt)
            y = y + site_linear(executor, f"moe.shared.down.{site_tag}",
                                sp["down"], F.silu(sg) * su)
        else:
            y = y + swiglu(sp, xt)
    aux = {"router_probs_mean": probs.mean(0),
           "dropped_frac": 1.0 - keep.to(torch.float32).mean(), "sel": sel,
           "keep": keep}
    return y.reshape(b, s, d), aux
