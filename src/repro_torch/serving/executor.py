"""Site-keyed compressed execution: route every compressed site through fused
kernels at serving time.

:class:`CompressedExecutor` is built from a
:class:`~repro_torch.core.artifact.CompressedModel`; it maps every site name
(the keys of ``artifact.records``: ``attn.q.l0``, ``ffn.down.l3``, ...) to a
fused-kernel callable, and the model decode path consults it inside the step.

Three kernel routes:

* :class:`StepPlan` — the whole decode step of the dense and MoE families:
  every site of every layer packed into four stacked stages (q+k+v, o, and
  gate+up, down — or, for MoE, all experts' gates+ups and all downs) and run
  by ``layer_plan.step_plan_matmul``, a fixed sequence of hand-written
  kernels with no PyTorch operation between them (an MoE layer routes inside
  the step).  The default for float32 configs (``use_plans=True``), as in
  the reference.
* :class:`MoEPlan` — one MoE layer's experts (all gates+ups, SwiGLU, all
  downs) through ``layer_plan.moe_plan_matmul`` (K9), where the whole-step
  plan is refused (MLA attention, shared experts) and the compute dtype is
  float32; the layer's attention and shared experts stay per-region.
* :class:`LCCMatvec` — one dense site: prune gather and eq. (10)
  segment-sum in one region-prep launch (``shared_matmul.RegionPrep``) ->
  the whole FP chain in ONE ``lcc_chain_matmul`` launch.
* :class:`GroupedLCCMatvec` — one *fused region*: several sites (an attention
  layer's q/k/v, a SwiGLU's gate/up, one projection of all of an MoE
  layer's experts) prepare their inputs in ONE region-prep launch and apply
  their chains in ONE ``lcc_group_matmul`` launch.

The last two are the per-region route, taken where no plan applies (other
compute dtypes, ``use_plans=False``).  :class:`ConvLCC` serves one
compressed conv site of the ResNet: every decomposed input channel's chain
in ONE ``lcc_group_matmul`` launch over the FK or PK window extraction.
Models never import this module —
they receive the executor as an opaque object with the protocol
``matvec(name)``, ``grouped(names)``, ``conv(name)``, ``step_plan(cfg)``
(each returning a callable, a plan or None).  Nothing here is traced or
compiled: the callables run eagerly, at any batch width (the kernels mask
their own ragged edges, so there is no batch bucketing).
"""
from __future__ import annotations

import re
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compress import CompressedDense
from repro_torch.core.conv_reshape import (extract_patches,
                                           extract_vert_windows, same_pad_2d)
from repro_torch.distributed import tp
from repro_torch.distributed.act_shard import get_mesh
from repro_torch.kernels import layer_plan, ops
from repro_torch.kernels.shared_matmul import RegionPrep
from repro_torch.models.attention import _paged_index
from repro_torch.models.layers import _rope_sincos

__all__ = ["CompressedExecutor", "LCCMatvec", "GroupedLCCMatvec", "ConvLCC",
           "StepPlan", "MoEPlan", "matvecs_from_artifact", "site_prep"]


def site_prep(records) -> RegionPrep:
    """The input preparation of the sites ``records`` (one site or a fused
    region): their kept columns and weight-sharing labels, composed once,
    named by the sites without their layer (``attn.q+attn.k+attn.v``,
    ``moe.up`` for one projection's experts)."""
    name = "+".join(dict.fromkeys(region_site(cd.name) for cd in records))
    return RegionPrep([
        (cd.kept_columns,
         None if cd.shared is None else cd.shared.labels,
         0 if cd.shared is None else cd.shared.n_clusters) for cd in records],
        name)


def region_site(name: str) -> str:
    """A site's name without its layer and expert (``attn.q.l3`` ->
    ``attn.q``, ``moe.up.l0.e5`` -> ``moe.up``)."""
    return re.sub(r"\.l\d+(\.e\d+)?$", "", name)


class LCCMatvec:
    """One compressed projection as a fused-kernel matvec: x [K, B] -> [N, B].

    Prune (kept_columns gather) and the optional weight-sharing segment-sum
    (paper eq. (10)) in one region-prep launch (none for an identity keep
    without sharing) -> the whole FP decomposition in a single
    ``lcc_chain_matmul`` launch.  Built from a
    ``core.compress.CompressedDense`` record; pass ``packed=`` to reuse an
    artifact's pre-packed kernel buffers instead of re-packing the
    decomposition.  The streams go to the device at the first
    call, not at construction.
    """

    def __init__(self, cd, *, packed=None, block: int = 128, device="cuda"):
        self.name = cd.name
        self.device = torch.device(device)
        self.packed = (packed if packed is not None
                       else ops.pack_decomposition(cd.decomposition, block))
        self.prep = site_prep([cd])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        vec = x.dim() == 1
        if vec:
            x = x[:, None]
        y = ops.apply_packed_decomposition(self.packed, self.prep(x))
        return y[:, 0] if vec else y


class GroupedLCCMatvec:
    """Several compressed sites applied in ONE fused launch (a *fused region*).

    Call with the region's features-major input ``[K, B]``: one tensor shared
    by every site, or a per-site list of views of one stacked tensor (see
    ``shared_matmul.region_layout``).  One region-prep launch gathers every
    member's kept columns, segment-sums its clusters and writes the
    concatenated input of the one ``lcc_group_matmul`` launch.  Returns the
    per-site ``[N_g, B]`` outputs.
    """

    def __init__(self, records, *, packed=None, block: int = 128,
                 device="cuda"):
        packed = packed or [None] * len(records)
        members = [pk if pk is not None
                   else ops.pack_decomposition(cd.decomposition, block)
                   for cd, pk in zip(records, packed)]
        self.names = tuple(cd.name for cd in records)
        self.device = torch.device(device)
        self.group = ops.pack_group(members)
        self.prep = site_prep(records)

    def __call__(self, xs) -> list[torch.Tensor]:
        return ops.apply_packed_group(self.group, self.prep(xs))


class ConvLCC:
    """One compressed conv layer executed in the compressed domain (the
    reference's ``ConvLCC``), a drop-in for the "SAME"/"VALID" conv of
    ``models.resnet`` at any stride.

    The decomposed input channels run their FK/PK chains in ONE
    ``lcc_group_matmul`` (K2) launch, one group member a channel, in
    ascending channel order:

    * FK: member c reads channel c's patches ``[O*O, B*P*P]`` (rows the
      kernel's (kh, kw), columns the output positions (b, p, q)) and writes
      ``[N, B*P*P]``;
    * PK: member c reads channel c's vertical windows ``[O, B*P*Zp]`` and
      writes the column products ``[N*O, B*P*Zp]`` (rows (n, j)); output
      ``(p, q)`` adds the products at input column ``q*stride + j`` over j.

    The members' outputs are summed after the launch, member 0 first (the
    reference's ``sum(ys)``); channels without a decomposition (subsampled
    or pruned) go through one ``F.conv2d`` on the residual kernel, whose
    decomposed channels are zero.  A group that fails to pack or launch
    raises.
    """

    def __init__(self, name: str, kernel: np.ndarray, record: dict,
                 method: str, *, block: int = 128, device="cuda"):
        if method not in ("fk", "pk"):
            raise ValueError(f"conv site {name!r}: unknown conv method {method!r}")
        self.name = name
        self.method = method
        self.device = torch.device(device)
        self.n, _, self.o, _ = kernel.shape
        self.channels = sorted(record["decompositions"])
        packed = [ops.pack_decomposition(record["decompositions"][ch], block)
                  for ch in self.channels]
        self.group = ops.pack_group(packed) if packed else None
        rest = np.array(kernel, np.float32)
        rest[:, self.channels] = 0.0  # chain channels leave the dense conv
        self.rest = (torch.from_numpy(rest).to(self.device)
                     if np.abs(rest).max() > 0 else None)
        self._chan = torch.tensor(self.channels, dtype=torch.long,
                                  device=self.device)

    def _padded(self, x: torch.Tensor, stride: int, padding: str):
        """(x padded as ``padding`` asks, output rows P, padded width Zp)."""
        if padding == "SAME":
            lo, hi = same_pad_2d(x.shape[2], self.o, stride)
            x = F.pad(x, (lo, hi, lo, hi))
        elif padding != "VALID":
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        zp = x.shape[2]
        return x, (zp - self.o) // stride + 1, zp

    def group_input(self, x: torch.Tensor, *, stride: int = 1,
                    padding: str = "SAME") -> torch.Tensor:
        """The K2 launch's concatenated input: the decomposed channels'
        patches ``[C*O*O, B*P*P]`` (FK) or vertical windows
        ``[C*O, B*P*Zp]`` (PK), member by member."""
        xp, p, zp = self._padded(x, stride, padding)
        return self._windows(xp, p, zp, stride)

    def _windows(self, xp, p, zp, stride):
        b, o, c = xp.shape[0], self.o, len(self.channels)
        xc = xp.index_select(1, self._chan).to(torch.float32)
        if self.method == "fk":
            pat = extract_patches(xc, o, stride)  # [B, C, P, P, O, O]
            return pat.permute(1, 4, 5, 0, 2, 3).reshape(c * o * o, b * p * p)
        win = extract_vert_windows(xc, o, stride)  # [B, C, P, Zp, O]
        return win.permute(1, 4, 0, 2, 3).reshape(c * o, b * p * zp)

    def __call__(self, x: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
        b, o, n = x.shape[0], self.o, self.n
        xp, p, zp = self._padded(x, stride, padding)
        y = None
        if self.rest is not None:
            y = F.conv2d(xp.to(torch.float32), self.rest, stride=stride)
        if self.group is not None:
            ys = ops.apply_packed_group(self.group,
                                        self._windows(xp, p, zp, stride))
            if self.method == "fk":
                yc = _member_sum(ys).reshape(n, b, p, p).permute(1, 0, 2, 3)
            else:
                part = _member_sum(ys).reshape(n, o, b, p, zp)
                # y[b, n, p, q] = sum_j part[(n, j), (b, p, q*stride + j)]
                yc = None
                for j in range(o):
                    t = part[:, j, :, :, j: j + stride * (p - 1) + 1: stride]
                    yc = t if yc is None else yc + t
                yc = yc.permute(1, 0, 2, 3)
            y = yc if y is None else y + yc
        if y is None:
            raise ValueError(f"conv site {self.name!r}: nothing to execute")
        return y.to(x.dtype).contiguous()


def _member_sum(ys: list[torch.Tensor]) -> torch.Tensor:
    """The group members' outputs summed one after another, member 0 first
    (the order of the reference's ``sum(ys)``)."""
    acc = ys[0].clone()
    for yg in ys[1:]:
        acc += yg
    return acc


def matvecs_from_artifact(artifact, *, include=None, block: int = 128,
                          device="cuda") -> dict[str, LCCMatvec]:
    """Per-site :class:`LCCMatvec` table for an artifact's dense records.
    ``include`` filters site names (callable or prefix string)."""
    keep = (include if callable(include)
            else (lambda n: n.startswith(include)) if include is not None
            else (lambda n: True))
    return {name: LCCMatvec(rec, packed=artifact.packed.get(name),
                            block=block, device=device)
            for name, rec in artifact.records.items()
            if isinstance(rec, CompressedDense) and keep(name)}


class StepPlan:
    """Whole-decode-step layer plan for the dense and MoE transformer families.

    Packs every site of every layer — attention q/k/v/o and FFN gate/up/down,
    compressed (CSD shift-add streams) or not (baked dense blocks) — into four
    stacked :class:`~repro_torch.kernels.ops.PackedStage` buffers and runs the
    step through :func:`~repro_torch.kernels.layer_plan.step_plan_matmul`.
    MoE families (``cfg.moe``): the FFN stages become the two expert
    super-stages — "eg" (all experts' gates then all ups, e-major, ``[E*d] ->
    [2*E*dff]``) and "ed" (all downs, ``[E*dff] -> [E*d]``) — and the router
    goes to the device beside them, so the routed block runs inside the step
    (the reference's layout, ``min_capacity`` 4).
    The KV cache is read in place (through the block table when paged) and
    the new K/V rows are written back after the step, for both cache layouts.
    A plan already in ``artifact.plans["step"]`` is reused; a new one is
    stored there.  ``pack_s`` is the host time the packing took (0 when
    reused).
    """

    def __init__(self, executor, cfg):
        self.executor = executor
        self.cfg = cfg
        art = executor.artifact
        blocks = art.params["blocks"]
        d, dff = cfg.d_model, cfg.d_ff
        nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        covered: list[str] = []

        def host(t):
            return None if t is None else t.detach().to("cpu", torch.float32).numpy()

        def spec(name, w, li, out_off, src_off=0, b=None):
            """Layer ``li``'s site ``name``: weight stack ``w [L, in, out]``,
            bias stack ``b [L, out]`` or None."""
            rec = art.records.get(name)
            bias = host(b[li]) if b is not None else None
            if not isinstance(rec, CompressedDense):
                # uncovered site: bake its dense weights into the stage so the
                # plan still emits the layer's full output
                return {"kind": "dense", "out_off": out_off,
                        "src_off": src_off, "w": host(w[li]), "bias": bias}
            covered.append(name)
            return {**_lcc_spec(executor, name, out_off, src_off),
                    "bias": bias}

        def lin(name, p, li, out_off):
            return spec(name, p["w"], li, out_off, b=p.get("b"))

        ab, fb = blocks["attn"], blocks["ffn"]
        qkv, o_ = [], []
        for li in range(cfg.n_layers):
            qkv.append([lin(f"attn.q.l{li}", ab["q"], li, 0),
                        lin(f"attn.k.l{li}", ab["k"], li, nq * hd),
                        lin(f"attn.v.l{li}", ab["v"], li, (nq + nkv) * hd)])
            o_.append([lin(f"attn.o.l{li}", ab["o"], li, 0)])
        stage_specs = {"qkv": (qkv, d, (nq + 2 * nkv) * hd),
                       "o": (o_, nq * hd, d)}
        self.moe = None
        if getattr(cfg, "moe", None) is None:
            gu, dn = [], []
            for li in range(cfg.n_layers):
                gu.append([lin(f"ffn.gate.l{li}", fb["gate"], li, 0),
                           lin(f"ffn.up.l{li}", fb["up"], li, dff)])
                dn.append([lin(f"ffn.down.l{li}", fb["down"], li, 0)])
            stage_specs["gu"] = (gu, d, 2 * dff)
            stage_specs["dn"] = (dn, dff, d)
        else:
            ne, edff = cfg.moe.n_experts, cfg.moe.d_ff_expert
            eg, ed = [], []
            for li in range(cfg.n_layers):
                a_sites, b_sites = [], []
                for ei in range(ne):
                    # expert stacks are raw [L, E, in, out] (no "w" level)
                    a_sites.append(spec(f"moe.gate.l{li}.e{ei}",
                                        fb["gate"][:, ei], li, ei * edff,
                                        ei * d))
                    a_sites.append(spec(f"moe.up.l{li}.e{ei}", fb["up"][:, ei],
                                        li, ne * edff + ei * edff, ei * d))
                    b_sites.append(spec(f"moe.down.l{li}.e{ei}",
                                        fb["down"][:, ei], li, ei * d,
                                        ei * edff))
                eg.append(a_sites)
                ed.append(b_sites)
            stage_specs["eg"] = (eg, ne * d, 2 * ne * edff)
            stage_specs["ed"] = (ed, ne * edff, ne * d)
            self.moe = {"router": fb["router"].to(executor.device,
                                                  torch.float32).contiguous(),
                        "n_experts": ne, "top_k": cfg.moe.top_k,
                        "capacity_factor": cfg.moe.capacity_factor,
                        "norm_topk": cfg.moe.norm_topk, "min_capacity": 4,
                        "d_ff": ne * edff,
                        "dropped": executor.moe_drop_counter()}
        pre = art.plans.get("step")
        t0 = time.perf_counter()
        if (pre is not None and set(pre) == set(stage_specs)
                and all(ps.n_layers == cfg.n_layers for ps in pre.values())):
            self.stages = pre  # the artifact carries plan-ready stages
            self.pack_s = 0.0
        else:
            self.stages = ops.pack_layer(stage_specs)
            art.plans["step"] = self.stages
            self.pack_s = time.perf_counter() - t0
        stats = art.pipeline_stats
        for name, ps in self.stages.items():
            if ps.waste is not None:
                stats.setdefault("padding_waste", {})[f"plan.{name}"] = ps.waste
            if ps.seg_stats is not None:
                stats.setdefault("segment_layout",
                                 {})[f"plan.{name}"] = ps.seg_stats
        dev = executor.device
        self.ln1 = self.ln2 = None
        if cfg.norm == "rms":
            self.ln1 = blocks["ln1"].to(dev, torch.float32).contiguous()
            self.ln2 = blocks["ln2"].to(dev, torch.float32).contiguous()
        self.covered = frozenset(covered)

    def decode_layers(self, state, x, pos):
        """x [B, 1, d] embedded tokens -> (x' [B, 1, d], state), the KV state
        updated in place.

        Under a serving mesh (``act_shard.get_mesh()``) this is the plan per
        shard, the counterpart of the reference's ``_mesh_wrap``: ``x``,
        ``pos``, ``kpos`` and the block table are the rank's slots (all of
        them where the engine replicates), the stages are whole on every
        rank, and the cache — this rank's slice over "model" — is gathered
        whole for the kernels; the new rows' slice is written back."""
        cfg = self.cfg
        self.executor.routed.update(self.covered)
        k_state, v_state, kpos = state["k"], state["v"], state["kpos"]
        tbl = state.get("block_tbl")
        nkv, hd = cfg.n_kv_heads, cfg.hd
        b = x.shape[0]
        mesh = get_mesh()
        kc, vc, split = k_state, v_state, None
        if mesh is not None:
            split = tp.kv_split(mesh, nkv, hd, k_state.shape[2])
            kc, vc = (tp.gather_kv(t, mesh, split) for t in (k_state, v_state))
        pos = pos.to(torch.int32)
        cos = sin = None
        rope = cfg.pos == "rope"
        if rope:
            sin, cos = _rope_sincos(pos, hd, cfg.rope_theta)
        y, kn, vn = layer_plan.step_plan_matmul(
            self.stages, n_heads=cfg.n_heads, n_kv_heads=nkv, head_dim=hd,
            d_ff=cfg.d_ff, norm=cfg.norm, rope=rope,
            x0=x[:, 0, :].to(torch.float32).T.contiguous(), pos=pos, cos=cos,
            sin=sin, ln1=self.ln1, ln2=self.ln2, kc=kc, vc=vc,
            kpos=kpos, moe=self.moe, window=cfg.attn_window, block_tbl=tbl)
        if split is not None:
            kn, vn = (tp.kv_local(t, mesh, split) for t in (kn, vn))
        # write the new rows back; an idle slot (pos == -1) writes nothing:
        # its K/V row goes to the null block (paged) or rewrites the old
        # value (contiguous), and its kpos stays -1
        smax = kpos.shape[2]
        pos = pos.long()
        slot = (torch.where(pos >= 0, pos % smax, torch.full_like(pos, -1))
                if cfg.attn_window is not None else pos)
        active = slot >= 0
        safe = slot.clamp(min=0)
        bi = torch.arange(b, device=pos.device)
        if tbl is None:
            am = active[None, :, None, None]
            k_state[:, bi, safe] = torch.where(am, kn.to(k_state.dtype),
                                               k_state[:, bi, safe])
            v_state[:, bi, safe] = torch.where(am, vn.to(v_state.dtype),
                                               v_state[:, bi, safe])
        else:
            bidx, off = _paged_index(tbl, slot, k_state.shape[2])
            k_state[:, bidx, off] = kn.to(k_state.dtype)
            v_state[:, bidx, off] = vn.to(v_state.dtype)
        kpos[:, bi, safe] = torch.where(active[None], pos[None].to(kpos.dtype),
                                        kpos[:, bi, safe])
        return y.T[:, None, :].to(x.dtype), state


def _lcc_spec(executor, name: str, out_off: int, src_off: int) -> dict:
    """A compressed site as a stage entry (its packed chains, prune and
    weight-sharing prep) at ``out_off`` of the stage's output, reading its
    input from ``src_off``."""
    rec = executor.artifact.records[name]
    return {"kind": "lcc", "name": name, "out_off": out_off,
            "src_off": src_off,
            "kept": np.asarray(rec.kept_columns, np.int64),
            "labels": (np.asarray(rec.shared.labels, np.int64)
                       if rec.shared is not None else None),
            "n_clusters": (rec.shared.n_clusters
                           if rec.shared is not None else 0),
            "packed": executor._matvecs[name].packed, "bias": None}


class MoEPlan:
    """One MoE layer's expert FFNs as one plan call (K9).

    Two one-layer stages over flattened expert buffers — A: every expert's
    gate at rows ``[e*dff, (e+1)*dff)`` and up at ``E*dff + e*dff``, reading
    ``[E*d, C]`` from ``e*d``; B: every down, ``[E*dff] -> [E*d]`` — in place
    of the three grouped per-region launches of the layer's experts (the
    reference's layout and plan key ``moe:<tag>``).  A plan already in
    ``artifact.plans`` is reused; a new one is stored there.  ``pack_s`` is
    the host time the packing took (0 when reused).  Under a serving mesh
    the stages are whole on every rank and ``buf`` holds every slot's
    tokens (the MoE family keeps every slot on every rank), so the plan
    runs as it does unmeshed, as do the per-region sites of every family."""

    def __init__(self, executor, site_tag: str, *, n_experts: int,
                 d_model: int, d_ff: int):
        self.executor = executor
        art = executor.artifact
        e, d, dff = n_experts, d_model, d_ff
        sa, sb, names = [], [], []
        for ei in range(e):
            sa.append(_lcc_spec(executor, f"moe.gate.{site_tag}.e{ei}",
                                ei * dff, ei * d))
            sa.append(_lcc_spec(executor, f"moe.up.{site_tag}.e{ei}",
                                e * dff + ei * dff, ei * d))
            sb.append(_lcc_spec(executor, f"moe.down.{site_tag}.e{ei}",
                                ei * d, ei * dff))
            names += [f"moe.{p}.{site_tag}.e{ei}"
                      for p in ("gate", "up", "down")]
        key = f"moe:{site_tag}"
        pre = art.plans.get(key)
        t0 = time.perf_counter()
        if pre is not None and set(pre) == {"a", "b"}:
            self.stages = pre
            self.pack_s = 0.0
        else:
            self.stages = ops.pack_layer({"a": ([sa], e * d, 2 * e * dff),
                                          "b": ([sb], e * dff, e * d)})
            art.plans[key] = self.stages
            self.pack_s = time.perf_counter() - t0
        self.covered = frozenset(names)
        self.d_ff_total = e * dff

    def __call__(self, buf: torch.Tensor) -> torch.Tensor:
        """buf [E, C, d] dispatched tokens -> [E, C, d] expert outputs."""
        self.executor.routed.update(self.covered)
        e, c, d = buf.shape
        src = buf.to(torch.float32).permute(0, 2, 1).reshape(e * d, c)
        out = layer_plan.moe_plan_matmul(
            self.stages["a"], self.stages["b"], d_ff_total=self.d_ff_total,
            src=src.contiguous())
        return out.reshape(e, d, c).permute(0, 2, 1).to(buf.dtype)


def _plan_ineligible_reason(cfg, has_sites: bool) -> str | None:
    """Why ``cfg`` cannot take the whole-step plan route (None = eligible).
    The reason strings are the reference's; ``Engine.plan_stats()`` reports
    them."""
    if getattr(cfg, "mla", None) is not None:
        return "mla"
    family = getattr(cfg, "family", "")
    if family in ("ssm", "hybrid"):
        return f"family:{family}"
    if getattr(cfg, "enc_layers", 0) != 0:
        return "encoder_decoder"
    pos = getattr(cfg, "pos", "rope")
    if pos not in ("rope", "none"):
        return f"pos:{pos}"
    norm = getattr(cfg, "norm", "rms")
    if norm not in ("rms", "nonparam"):
        return f"norm:{norm}"
    if cfg.cdtype != torch.float32:
        return "cdtype"
    moe = getattr(cfg, "moe", None)
    if moe is not None:
        if getattr(cfg, "moe_manual", False):
            return "moe_manual"  # manual EP shards experts across devices
        if getattr(moe, "n_shared", 0) > 0:
            return "moe_shared"  # shared experts keep their own site route
    if not has_sites:
        return "no_sites"
    return None


class CompressedExecutor:
    """Site-keyed registry mapping every compressed site of an artifact to a
    fused-kernel callable.

    Protocol consumed by the model decode paths (duck-typed — models never
    import serving):

    * ``matvec(name)``   -> features-major callable ``[K, B] -> [N, B]`` or
      None when the site is not compressed (dense fallback).
    * ``grouped(names)`` -> one-launch callable over a *fused region* (list of
      per-site ``[K_g, B]`` inputs -> list of ``[N_g, B]`` outputs), or None
      unless every name is a compressed dense site.
    * ``conv(name)``     -> :class:`ConvLCC` of a conv record, or None.
    * ``step_plan(cfg)`` -> :class:`StepPlan` or None: the whole-step plan,
      built on first use and cached, when ``use_plans`` is set and the config
      is eligible (dense family, float32 compute dtype, ...); otherwise the
      reason is recorded in :attr:`plan_fallbacks` and decode takes the
      per-region route.  A plan that fails to build raises: there is no
      silent fallback to the per-region route.
    * ``moe_plan(tag, ...)`` -> :class:`MoEPlan` or None: one MoE layer's
      experts (K9), asked for by ``moe_ffn`` where the step plan is not
      taken; the same rules.

    ``routed`` records every site actually served by a fused kernel — tests
    assert it covers the artifact, and the engine reports it.
    """

    def __init__(self, artifact, *, block: int = 128, use_plans: bool = True,
                 device="cuda"):
        self.artifact = artifact
        self.block = block
        self.device = torch.device(device)
        self.use_plans = bool(use_plans)
        # plan key ("step", "moe:<tag>") -> why it took the per-region route
        self.plan_fallbacks: dict[str, str] = {}
        self._plans: dict[str, StepPlan | MoEPlan | None] = {}
        self._matvecs = matvecs_from_artifact(artifact, block=block,
                                              device=device)
        # record ineligibility eagerly, as the reference does (plans are a
        # transformer route: a ResNet or MLP artifact has no step)
        if self.use_plans and isinstance(artifact.config, ArchConfig):
            reason = _plan_ineligible_reason(artifact.config,
                                             bool(self._matvecs))
            if reason is not None:
                self.plan_fallbacks.setdefault("step", reason)
        self._groups: dict[tuple, GroupedLCCMatvec | None] = {}
        self.routed: set[str] = set()
        self._convs: dict[str, ConvLCC] = {}
        conv_names = [n for n, r in artifact.records.items()
                      if not isinstance(r, CompressedDense)]
        if conv_names:
            from repro_torch.models import compress_adapters as ca

            conv_sites = {s.name: s for s in ca.sites_for(artifact.params,
                                                          artifact.config)
                          if isinstance(s, ca.ConvSite)}
            for name in conv_names:
                cv = ConvLCC(name, conv_sites[name].kernel(artifact.params),
                             artifact.records[name],
                             artifact.unit_config_for(name).conv_method,
                             block=block, device=device)
                self._convs[name] = cv
                if cv.group is not None and cv.group.waste is not None:
                    artifact.pipeline_stats.setdefault(
                        "padding_waste", {})[name] = cv.group.waste
        # dropped (token, choice) assignments of the MoE layers over every
        # decode step on either route, int32 [1] on the device (made on
        # first use)
        self.moe_dropped: torch.Tensor | None = None

    def moe_drop_counter(self) -> torch.Tensor:
        """The device counter :attr:`moe_dropped` (made on first use)."""
        if self.moe_dropped is None:
            self.moe_dropped = torch.zeros(1, dtype=torch.int32,
                                           device=self.device)
        return self.moe_dropped

    def count_moe_drops(self, keep: torch.Tensor) -> None:
        """Add one MoE layer's dropped choices (``~keep``) to the counter."""
        c = self.moe_drop_counter()
        c += (~keep).sum().to(c.device, torch.int32)

    @property
    def sites(self) -> set[str]:
        """Every site this executor can serve through a fused kernel."""
        return set(self._matvecs) | set(self._convs)

    def __contains__(self, name: str) -> bool:
        return name in self._matvecs or name in self._convs

    def matvec(self, name: str):
        fn = self._matvecs.get(name)
        if fn is not None:
            self.routed.add(name)
        return fn

    def grouped(self, names):
        names = tuple(names)
        if names not in self._groups:
            if names and all(n in self._matvecs for n in names):
                recs = [self.artifact.records[n] for n in names]
                # reuse the per-site packed buffers (host side); only the
                # group's re-padded copy of the streams goes to the device
                packed = [self._matvecs[n].packed for n in names]
                g = GroupedLCCMatvec(recs, packed=packed, block=self.block,
                                     device=self.device)
                self._groups[names] = g
                if g.group.waste is not None:
                    self.artifact.pipeline_stats.setdefault(
                        "padding_waste", {})["+".join(names)] = g.group.waste
            else:
                self._groups[names] = None
        g = self._groups[names]
        if g is not None:
            self.routed.update(names)
        return g

    def conv(self, name: str):
        fn = self._convs.get(name)
        if fn is not None:
            self.routed.add(name)
        return fn

    def step_plan(self, cfg):
        """Whole-decode-step plan, or None (the reason in
        :attr:`plan_fallbacks`)."""
        if not self.use_plans:
            self.plan_fallbacks.setdefault("step", "plans_disabled")
            return None
        if "step" not in self._plans:
            reason = _plan_ineligible_reason(cfg, bool(self._matvecs))
            plan = StepPlan(self, cfg) if reason is None else None
            if reason is not None:
                self.plan_fallbacks["step"] = reason
            self._plans["step"] = plan
        plan = self._plans["step"]
        if plan is not None:
            self.routed.update(plan.covered)
        return plan

    def moe_plan(self, site_tag: str, *, n_experts: int, d_model: int,
                 d_ff: int):
        """The per-layer expert plan (:class:`MoEPlan`, K9) of layer
        ``site_tag``, built on first use and cached, or None: the reason
        (the reference's — ``plans_disabled``, ``moe_sites_missing``,
        ``cdtype``) is recorded in :attr:`plan_fallbacks` under
        ``moe:<tag>`` and the layer's experts take the grouped per-region
        route.  A plan that fails to build raises."""
        key = f"moe:{site_tag}"
        if not self.use_plans:
            self.plan_fallbacks.setdefault(key, "plans_disabled")
            return None
        if key not in self._plans:
            names = [f"moe.{p}.{site_tag}.e{e}" for e in range(n_experts)
                     for p in ("gate", "up", "down")]
            plan = None
            if not all(n in self._matvecs for n in names):
                self.plan_fallbacks[key] = "moe_sites_missing"
            elif self.artifact.config.cdtype != torch.float32:
                self.plan_fallbacks[key] = "cdtype"
            else:
                plan = MoEPlan(self, site_tag, n_experts=n_experts,
                               d_model=d_model, d_ff=d_ff)
            self._plans[key] = plan
        plan = self._plans[key]
        if plan is not None:
            self.routed.update(plan.covered)
        return plan

    @property
    def n_layer_plans(self) -> int:
        """Distinct layer plans built (a whole-step plan counts once)."""
        return sum(1 for p in self._plans.values() if p is not None)
