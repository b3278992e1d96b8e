"""K8's own kernels: the routed FFN inside the whole-step layer plan.

Counterpart of the MoE branch of ``repro.kernels.layer_plan.step_plan_matmul``
(Pallas TPU, body ``moe_block``).  A decode step's MoE layer runs

    route -> stage eg (K6: the dispatch as its gathered input, SwiGLU in
                       its gated epilogue)
          -> stage ed (K6, the combine in its combining epilogue)

where :func:`moe_route` is this module's hand-written CUDA kernel
(``csrc/moe_route.cu``): router logits (one pass over d, spread over blocks
of ``ROUTE_ROWS`` rows, their sums added in block order by the second of its
two kernels), softmax, top-k (ties to the lower expert index, as
``jax.lax.top_k``), renormalisation and the capacity rank of every (token,
choice) by the reference's exclusive cumsum over the token-major
flattening; it emits each choice's expert, weight (gate * keep) and slot
(``e * C + rank``, or ``E * C`` when dropped) and, per slot, its source
token.

:func:`moe_dispatch_plain` — the e-major expert input ``src [E * d, C]``
scatter-added as the reference does — is the plain version of the eg
stage's gathered input (``layer_plan.stage_matmul(gather=...)``), and
:func:`moe_combine_plain` — ``x + sum_j w_j * ob[slot_j]`` over the kept
choices — that of the ed stage's combining epilogue
(``layer_plan.stage_matmul(combine=...)``).

Routing is the reference's to the letter: every column of the batch is
routed, idle slots included (they take capacity), and the capacity is the
same static function of the batch (:func:`capacity`).  :func:`route_tokens`
is that math in PyTorch operations, shared with ``models.moe.moe_ffn``.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version beside it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build, dispatch

__all__ = ["MAX_TOP_K", "capacity", "route_tokens", "moe_route",
           "moe_route_plain", "moe_dispatch_plain",
           "moe_combine_plain"]

MAX_TOP_K = 8  # the route kernel's bound on k (csrc/moe_route.cu)
ROUTE_ROWS = 512  # rows of d a logits block sums (kRouteRows)


def capacity(n_tokens: int, top_k: int, capacity_factor: float,
             n_experts: int, min_capacity: int = 4) -> int:
    """Slots per expert: Python's ``round`` (half to even), as the reference
    computes it on the host."""
    return int(max(min_capacity,
                   round(n_tokens * top_k * capacity_factor / n_experts)))


def route_tokens(xt: torch.Tensor, router: torch.Tensor | None, *,
                 top_k: int, cap: int, norm_topk: bool, logits=None):
    """Routing of ``T`` tokens, ``xt [T, d]`` float32, ``router [d, E]``
    float32 -> ``(probs [T, E], gates [T, k], sel [T, k], keep [T, k],
    slot [T, k])``: softmax, top-k by a stable descending sort (an equal
    probability keeps the lower expert first), renormalisation, the rank of
    each (token, choice) in its expert's queue by the exclusive cumsum over
    the ``[T * k, E]`` one-hot, and the flat slot ``e * cap + rank``
    (``E * cap`` when the rank is beyond capacity).  ``logits [T, E]``, when
    given, are ``xt @ router`` already computed (a partitioned router)."""
    t = xt.shape[0]
    if logits is None:
        logits = xt @ router
    n_exp = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    gates, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, sel = gates[:, :top_k], sel[:, :top_k]
    if norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    sel_oh = F.one_hot(sel, n_exp)  # [T, k, E]
    flat = sel_oh.reshape(t * top_k, n_exp)
    ranks = (torch.cumsum(flat, dim=0) - flat).reshape(t, top_k, n_exp)
    rank = torch.sum(ranks * sel_oh, dim=-1)
    keep = rank < cap
    slot = torch.where(keep, sel * cap + torch.clamp(rank, max=cap - 1),
                       torch.full_like(sel, n_exp * cap))
    return probs, gates, sel, keep, slot


# ------------------------------------------------------------------ route


def moe_route_plain(h2: torch.Tensor, router: torch.Tensor, *, top_k: int,
                    cap: int, norm_topk: bool,
                    dropped: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`moe_route` (same arguments and
    outputs)."""
    b = h2.shape[1]
    n_exp = router.shape[1]
    _, gates, sel, keep, slot = route_tokens(
        h2.T.to(torch.float32), router.to(torch.float32), top_k=top_k,
        cap=cap, norm_topk=norm_topk)
    wgt = gates * keep.to(torch.float32)
    src_tok = torch.full((n_exp * cap,), -1, dtype=torch.int32,
                         device=h2.device)
    kept = keep.reshape(-1)
    tok = torch.arange(b, device=h2.device).repeat_interleave(top_k)
    src_tok[slot.reshape(-1)[kept]] = tok[kept].to(torch.int32)
    if dropped is not None:
        dropped += (~keep).sum().to(dropped.dtype)
    return (sel.to(torch.int32), wgt, slot.to(torch.int32), src_tok)


def moe_route(h2: torch.Tensor, router: torch.Tensor, *, top_k: int,
              cap: int, norm_topk: bool,
              dropped: torch.Tensor | None = None):
    """Route the ``B`` columns of ``h2 [d, B]`` (float32, feature-major)
    through one layer's ``router [d, E]`` (float32).

    Returns ``(sel [B, k] int32, wgt [B, k] f32, slot [B, k] int32,
    src_tok [E * cap] int32)``: each choice's expert, its weight (the
    renormalised gate when kept, 0 when dropped) and its flat slot
    (``e * cap + rank``; ``E * cap`` when dropped), and each slot's source
    token (-1 when empty).  ``dropped`` (int32 ``[1]``, optional) is
    incremented by the number of dropped choices.  CUDA tensors launch the
    kernel (or raise); CPU tensors take :func:`moe_route_plain`."""
    if not dispatch.on_device(h2):
        return moe_route_plain(h2, router, top_k=top_k, cap=cap,
                               norm_topk=norm_topk, dropped=dropped)
    dev = h2.device
    d, b = h2.shape
    n_exp = router.shape[1]
    dispatch.check_tensor("h2", h2, torch.float32, (d, b), dev)
    dispatch.check_tensor("router", router, torch.float32, (d, n_exp), dev)
    if dropped is not None:
        dispatch.check_tensor("dropped", dropped, torch.int32, (1,), dev)
    if not 0 < top_k <= min(n_exp, MAX_TOP_K) or cap <= 0:
        raise ValueError(f"top_k {top_k} (at most {min(n_exp, MAX_TOP_K)}) "
                         f"and cap {cap} (positive)")
    i32 = dict(dtype=torch.int32, device=dev)
    sel = torch.empty((b, top_k), **i32)
    slot = torch.empty((b, top_k), **i32)
    wgt = torch.empty((b, top_k), dtype=torch.float32, device=dev)
    src_tok = torch.empty((n_exp * cap,), **i32)
    ws = torch.empty(-(-d // ROUTE_ROWS) * b * n_exp, dtype=torch.float32,
                     device=dev)  # each logits block's sums
    lib = build.load()
    with torch.cuda.device(dev):
        code = lib.repro_moe_route(
            h2.data_ptr(), router.data_ptr(), sel.data_ptr(), wgt.data_ptr(),
            slot.data_ptr(), src_tok.data_ptr(),
            None if dropped is None else dropped.data_ptr(), ws.data_ptr(), d,
            b, n_exp, top_k, cap, int(bool(norm_topk)),
            torch.cuda.current_stream().cuda_stream)
    dispatch.check_launch(code, "repro_moe_route")
    dispatch.record_launch("moe_route", shape=(d, b, n_exp, top_k, cap))
    return sel, wgt, slot, src_tok


# --------------------------------------------------------------- dispatch


def moe_dispatch_plain(h2: torch.Tensor, slot: torch.Tensor,
                       src_tok: torch.Tensor, n_experts: int,
                       cap: int) -> torch.Tensor:
    """The experts' input ``src [E * d, cap]`` (e-major, feature-major):
    the reference's scatter-add of every choice's token ``h2[:, t]`` into
    its slot (dropped choices fall off the end), then the e-major
    flattening, so ``src[e * d + i, c]`` is ``h2[i, t]`` for the token
    routed to slot ``e * cap + c`` and zero for an empty slot.  The plain
    version of the gathered input of ``layer_plan.stage_matmul``, whose
    kernel reads ``h2`` through ``src_tok``: kept slots are unique, so the
    two agree in every value (a -0.0 of ``h2`` lands here as +0.0, which the
    stage's sums from +0.0 do not tell apart).  ``src_tok`` is not read
    here."""
    d, b = h2.shape
    top_k = slot.shape[1]
    xt = h2.T.to(torch.float32)
    buf = torch.zeros((n_experts * cap + 1, d), dtype=torch.float32,
                      device=h2.device)  # row E * C: the dropped choices
    for j in range(top_k):
        buf.index_add_(0, slot[:, j].long(), xt)
    return (buf[:-1].reshape(n_experts, cap, d).permute(0, 2, 1)
            .reshape(n_experts * d, cap))


# ---------------------------------------------------------------- combine


def moe_combine_plain(x: torch.Tensor, ob: torch.Tensor, slot: torch.Tensor,
                      wgt: torch.Tensor, n_experts: int,
                      cap: int) -> torch.Tensor:
    """``x [d, B] + y``, ``y[:, b] = sum_j wgt[b, j] * (expert output of
    slot[b, j])`` over the choices in order, from the experts' output ``ob
    [E * d, cap]`` (e-major): the reference's gated gather loop (a dropped
    choice reads the last slot and weighs it 0).  The plain version of the
    combining mode of ``layer_plan.stage_matmul``."""
    d, b = x.shape
    out_buf = (ob.reshape(n_experts, d, cap).permute(0, 2, 1)
               .reshape(n_experts * cap, d))
    y = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    for j in range(slot.shape[1]):
        g = out_buf[torch.clamp(slot[:, j].long(), max=n_experts * cap - 1)]
        y = y + wgt[:, j][:, None] * g
    return x + y.T
