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

Under a serving mesh the expert stacks and the router are
:class:`~repro_torch.distributed.tp.Sharded` leaves: ``moe_ffn`` computes
its routing and its experts through :mod:`repro_torch.distributed.tp` on
the whole batch (routing capacity is a function of the global batch).
:func:`moe_ffn_manual` is the reference's manual variant (``moe_manual``):
each (pod, data) rank routes its own block of tokens with a capacity of its
own, runs its experts (EP) or its slice of every expert's ``d_ff``, and one
all-reduce over "model" combines.  :func:`router_aux_losses` is the
reference's load-balance loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp
from repro_torch.distributed.act_shard import get_mesh
from repro_torch.distributed.collectives import all_reduce
from repro_torch.distributed.placement import gather_leaf
from repro_torch.distributed.sharding import P
from repro_torch.kernels.moe_route import capacity, route_tokens

from .layers import site_linear, site_linear_group, swiglu

__all__ = ["moe_ffn", "moe_ffn_manual", "router_aux_losses"]


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
    router, logits = p["router"].to(torch.float32), None
    if isinstance(router, tp.Sharded):
        logits, router = tp.linear(xt.to(torch.float32), router), None
    probs, gates, sel, keep, slot = route_tokens(
        xt.to(torch.float32), router, top_k=top_k, cap=cap,
        norm_topk=norm_topk, logits=logits)
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
            if isinstance(p[proj], tp.Sharded):
                return tp.expert_matmul(z, p[proj])
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


def moe_ffn_manual(p, x, *, n_experts: int, top_k: int,
                   capacity_factor: float = 1.25, norm_topk: bool = True,
                   min_capacity: int = 4, mesh=None):
    """The MoE block with local dispatch (the reference's ``shard_map``
    variant): x [B, S, d], whole on every rank -> (y [B, S, d], aux).

    The ``T`` tokens split over the mesh's ("pod", "data") axes; each rank
    routes its ``T / tshard`` tokens with the local capacity
    ``max(min_capacity, round(T // tshard * k * cf / E))``, runs its
    ``E / model`` experts when they divide (EP) or its slice of every
    expert's ``d_ff`` otherwise (shared experts: a slice of their ``d_ff``),
    combines its choices in float32, and one all-reduce over "model" sums
    the parts; the ranks' token blocks are then gathered.  Parameters are
    whole tensors or :class:`~repro_torch.distributed.tp.Sharded` leaves
    (resharded to the layout above where theirs differs).  Without a mesh
    (``mesh`` or the current one) or when the tokens do not divide, it is
    :func:`moe_ffn`, as in the reference.  No executor: the experts run on
    the dense weights."""
    if mesh is None:
        mesh = get_mesh()
    b, s, d = x.shape
    t = b * s
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, norm_topk=norm_topk,
              min_capacity=min_capacity)
    token_axes = (() if mesh is None else
                  tuple(a for a in ("pod", "data") if a in mesh.shape))
    tshard = math.prod(mesh.shape[a] for a in token_axes) if mesh else 1
    if mesh is None or t % tshard:
        return moe_ffn(p, x, **kw)
    msize = mesh.shape.get("model", 1)
    midx = mesh.coord("model")
    ep = n_experts % msize == 0 and n_experts >= msize
    e_loc = n_experts // msize if ep else n_experts
    tl = t // tshard
    ti = 0
    for a in token_axes:
        ti = ti * mesh.shape[a] + mesh.coord(a)
    xt = x.reshape(t, d)[ti * tl:(ti + 1) * tl]

    def chunk(w, spec):
        return tp.local_chunk(w, spec, mesh)

    gate_spec = P("model", None, None) if ep else P(None, None, "model")
    down_spec = P("model", None, None) if ep else P(None, "model", None)
    gate, up = chunk(p["gate"], gate_spec), chunk(p["up"], gate_spec)
    down = chunk(p["down"], down_spec)
    router = tp.whole(p["router"])
    cap = int(max(min_capacity, round(tl * top_k * capacity_factor
                                      / n_experts)))
    _, gates, sel, keep, slot = route_tokens(
        xt.to(torch.float32), router.to(torch.float32), top_k=top_k, cap=cap,
        norm_topk=norm_topk)
    buf = torch.zeros((n_experts * cap + 1, d), dtype=xt.dtype,
                      device=xt.device)
    for j in range(top_k):  # row E * C takes the dropped choices
        buf.index_add_(0, slot[:, j], xt)
    buf = buf[:-1].reshape(n_experts, cap, d)
    my = buf[midx * e_loc:(midx + 1) * e_loc] if ep else buf
    h = (F.silu(torch.einsum("ecd,edf->ecf", my, gate))
         * torch.einsum("ecd,edf->ecf", my, up))
    flat = torch.einsum("ecf,efd->ecd", h, down).reshape(e_loc * cap, d)
    y = torch.zeros((tl, d), dtype=torch.float32, device=xt.device)
    for j in range(top_k):
        if ep:  # a kept choice's slot, moved to this rank's expert block
            e_l = sel[:, j] - midx * e_loc
            owned = (e_l >= 0) & (e_l < e_loc) & keep[:, j]
            idx = torch.clamp(slot[:, j] - midx * e_loc * cap, 0,
                              e_loc * cap - 1)
        else:
            owned = keep[:, j]
            idx = torch.clamp(slot[:, j], max=n_experts * cap - 1)
        g = flat[idx].to(torch.float32)
        y = y + torch.where(owned[:, None], gates[:, j:j + 1] * g,
                            torch.zeros((), dtype=torch.float32,
                                        device=xt.device))
    if "shared" in p:  # shared experts, tensor-parallel over their d_ff
        sp = p["shared"]
        sg = chunk(sp["gate"]["w"], P(None, "model"))
        su = chunk(sp["up"]["w"], P(None, "model"))
        sd = chunk(sp["down"]["w"], P("model", None))
        hs = F.silu(xt @ sg) * (xt @ su)
        y = y + (hs @ sd).to(torch.float32)
    y = all_reduce(y, mesh.group("model")).to(xt.dtype)
    if token_axes:
        y = gather_leaf(y, P(token_axes), mesh)
    aux = {"router_probs_mean": torch.zeros((n_experts,), dtype=torch.float32,
                                            device=x.device),
           "dropped_frac": torch.zeros((), device=x.device), "sel": None}
    return y.reshape(b, s, d), aux


def router_aux_losses(aux, n_experts: int):
    """Load-balance loss (Switch-style): ``E * sum(frac * probs_mean)``, with
    ``frac`` each expert's share of the routed choices; and the dropped
    fraction."""
    pm = aux["router_probs_mean"]  # [E]
    frac = torch.bincount(aux["sel"].reshape(-1),
                          minlength=n_experts).to(torch.float32)
    frac = frac / torch.clamp(frac.sum(), min=1.0)
    lb = n_experts * torch.sum(frac * pm)
    return {"load_balance": lb, "dropped_frac": aux["dropped_frac"]}
