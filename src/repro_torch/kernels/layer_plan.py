"""Layer plans on the GPU: a whole stage per launch, and the whole decode step.

Counterpart of ``repro.kernels.layer_plan`` (Pallas TPU), dense and MoE
families:

* :func:`stage_matmul` (K6) evaluates one :class:`~repro_torch.kernels.ops.
  PackedStage` — every compressed site that reads one activation (q+k+v,
  o, gate+up, down), plus baked dense blocks and biases — for one layer or
  for all L: prep scatter-add, the fused CSD shift-add levels, the output
  gather and the dense epilogue.  CUDA source ``csrc/stage_matmul.cu``.
* :func:`step_plan_matmul` (K7) runs the whole decode step over L identical
  layers as a fixed sequence of hand-written kernels a layer: norm, stage
  qkv, RoPE + decode attention (emits the new K/V rows), stage o + residual,
  norm, stage gate+up, SwiGLU, stage down + residual.  No PyTorch operation
  runs between them.  CUDA source ``csrc/step_plan.cu`` (norm, attention,
  SwiGLU) beside the stage kernel.
* ``step_plan_matmul(moe=...)`` (K8) replaces a layer's FFN with the routed
  experts inside the same sequence: route, dispatch, stage eg (all experts'
  gates and ups, e-major), SwiGLU, stage ed (all downs), gated combine +
  residual.  The route, dispatch and combine kernels are
  :mod:`~repro_torch.kernels.moe_route` (``csrc/moe_route.cu``).
* :func:`moe_plan_matmul` (K9) runs one MoE layer's experts where the
  whole-step plan does not apply (MLA, shared experts): stage A (all gates
  and ups), the step's SwiGLU kernel, stage B (all downs) — three launches,
  no PyTorch operation between them; dispatch and combine stay with the
  caller, as in the reference.

Both evaluate the shift-add streams at every size.  The reference folds a
large stage into one dense matrix (``PackedStage.eff``) and picks between two
lowerings of a level by a row-count threshold; both choices were tuned to the
dispatch costs of an interpreter host and turn the paper's shift-add
evaluation into dense products, so neither is taken here.  ``eff`` stays a
test surface (:func:`stage_apply_eff`).

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions (:func:`stage_matmul_plain`, :func:`step_plan_matmul_plain`), which
repeat the arithmetic in PyTorch operations.  Public layouts are the
reference's: feature-major ``x [d, B]``, caches ``[L, B, S, Hkv, hd]``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from . import build, dispatch
from .lcc_chain_matmul import SMEM_LIMIT, signed_pow2
from .moe_route import (capacity, moe_combine, moe_combine_plain, moe_dispatch,
                        moe_dispatch_plain, moe_route, moe_route_plain)
from .ops import PackedStage

__all__ = ["DeviceStage", "device_stage", "stage_blocks", "stage_matmul",
           "stage_matmul_plain", "stage_apply_eff", "step_plan_matmul",
           "step_plan_matmul_plain", "moe_plan_matmul",
           "moe_plan_matmul_plain"]

_NEG = -1e30
# blocks of rows smaller than this are merged with their neighbours (a block
# is one instruction at the main paths' widths: 2048 or 8192 rows for
# olmo-1b, 16384 or 6144 for mixtral-8x22b's experts)
MERGE_ROWS = 1024
_STAGE_ORDER = ("qkv", "o", "gu", "dn")
_MOE_STAGE_ORDER = ("qkv", "o", "eg", "ed")


# ---------------------------------------------------------------- upload


def stage_blocks(ps: PackedStage, layer: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Row blocks of one layer of a stage: ``(r0, r1, depth, live_terms)``.

    The blocks partition ``[0, R)`` so that no live term of a level >= 1
    reads a row outside its own block (the finest such partition, with
    pieces below ``MERGE_ROWS`` rows merged into their neighbours up to the
    size of the largest piece).  ``depth`` is the number of levels a block
    must run: the levels after it are identity rows (``gidx[p, r, 0] == r``,
    sign 1, exponent 0, no other live term) for every row of the block.
    ``live_terms`` counts the terms with sign != 0 in the levels the blocks
    run — the work the data needs.  Raises on indices outside the stage."""
    gidx, gexp, gsgn = ps.gidx[layer], ps.gexp[layer], ps.gsgn[layer]
    n_p, r, n_s = gidx.shape
    rows = np.arange(r, dtype=gidx.dtype)
    lo, hi = rows.copy(), rows.copy()
    depth_row = np.ones(r, np.int32)
    live_rows = np.zeros(r, bool)  # a live term in any level
    # loops over the few term columns: reductions over a short last axis
    # are slow in numpy, elementwise passes over [R] are not
    for s in range(n_s):
        live_rows |= (gsgn[:, :, s] != 0).any(axis=0)
    for p in range(1, n_p):
        other = np.zeros(r, bool)  # a live term past column 0
        for s in range(n_s):
            g, live = gidx[p, :, s], gsgn[p, :, s] != 0
            if (live & ((g < 0) | (g >= r))).any():
                raise ValueError(f"stage level {p} reads a row outside [0, {r})")
            np.minimum(lo, np.where(live, g, r), out=lo)
            np.maximum(hi, np.where(live, g, -1), out=hi)
            if s:
                other |= live
        ident = ((gsgn[p, :, 0] == 1) & (gexp[p, :, 0] == 0)
                 & (gidx[p, :, 0] == rows) & ~other)
        depth_row[~ident] = p + 1
    # a row dead in every level is zero after level 0 already
    depth_row[~live_rows] = 1
    cuts = np.arange(1, r)
    ok = ((np.maximum.accumulate(hi)[:-1] < cuts)
          & (np.minimum.accumulate(lo[::-1])[::-1][1:] >= cuts))
    starts = np.concatenate([[0], cuts[ok]])
    sizes = np.diff(np.concatenate([starts, [r]]))
    cap = max(int(sizes.max()), min(r, MERGE_ROWS))
    merged, run = [0], 0
    for i, n in enumerate(sizes):
        if run + n > cap:
            merged.append(int(starts[i]))
            run = 0
        run += int(n)
    r0 = np.asarray(merged, np.int64)
    r1 = np.append(r0[1:], r)
    depth = np.maximum.reduceat(depth_row, r0)
    # live terms in the levels each block runs
    row_depth = np.repeat(depth, r1 - r0)
    live_terms = 0
    for p in range(n_p):
        run = row_depth > p
        for s in range(n_s):
            live_terms += int(np.count_nonzero((gsgn[p, :, s] != 0) & run))
    return (r0.astype(np.int32), r1.astype(np.int32), depth.astype(np.int32),
            live_terms)


def _check_stage(ps: PackedStage) -> None:
    """Host-side validation, once per upload (layer by layer, so the
    temporaries stay small): every index inside its buffer, every live
    exponent inside the float32 exponent field."""
    if ps.has_prep:
        if (ps.prep_src.min() < 0 or ps.prep_src.max() >= ps.d_src
                or ps.prep_tgt.min() < 0 or ps.prep_tgt.max() >= ps.k_alloc):
            raise ValueError("stage prep pairs address rows outside the stage")
    if not ps.has_fp:
        return
    if not ps.has_prep:
        raise ValueError("a stage with streams needs prep pairs (level 0 "
                         "reads the prep buffer)")
    r = ps.gidx.shape[2]
    for l in range(ps.n_layers):
        live = ps.gsgn[l] != 0
        g0 = ps.gidx[l, 0]
        if ((g0 < 0) | (g0 >= ps.k_alloc))[live[0]].any():
            raise ValueError("stage level 0 reads a row outside the prep buffer")
        if (ps.gexp[l] < -126)[live].any():
            raise ValueError("stage exponent outside the float32 exponent range")
    if ps.outg.min() < 0 or ps.outg.max() > r:
        raise ValueError(f"stage output gather outside [0, {r}]")


@dataclass
class DeviceStage:
    """One stage's operands on one device.  The prep pairs come twice: in
    pair order (the plain version's ``index_add_``) and sorted by target with
    per-target offsets (the kernel's fixed-order sums).  The block tables
    (:func:`stage_blocks`) exist wherever the stage has streams."""

    ps: PackedStage
    device: torch.device
    prep_src: torch.Tensor | None  # [L, M] int32
    prep_tgt: torch.Tensor | None  # [L, M] int32
    prep_sorted_src: torch.Tensor | None  # [L, M] int32, pairs by target
    prep_off: torch.Tensor | None  # [L, K_alloc + 1] int32
    gidx: torch.Tensor | None  # [L, P, R, S] int32
    gexp: torch.Tensor | None  # [L, P, R, S] int8
    gsgn: torch.Tensor | None  # [L, P, R, S] int8
    outg: torch.Tensor | None  # [L, J, O] int32
    fs_mat: torch.Tensor | None
    dw_mat: torch.Tensor | None
    bias: torch.Tensor | None
    fs_live: tuple[bool, ...] = ()  # per layer: the block holds a nonzero
    dw_live: tuple[bool, ...] = ()
    bias_live: tuple[bool, ...] = ()
    blk_r0: torch.Tensor | None = None  # [L, NB] int32 (padding: r0 == r1)
    blk_r1: torch.Tensor | None = None
    blk_depth: torch.Tensor | None = None
    max_rows: int = 0
    live_terms: tuple[int, ...] = ()  # per layer, in the levels run
    _geometry: dict = field(default_factory=dict, repr=False)

    @property
    def dims(self) -> dict:
        """(M, K, P, R, S, NB, J, O, D) of the kernel's argument list."""
        ps = self.ps
        p, r, s = ps.gidx.shape[1:] if ps.has_fp else (0, 0, 0)
        return dict(M=ps.prep_src.shape[1] if ps.has_prep else 0,
                    K=ps.k_alloc if ps.has_prep else 0, P=p, R=r, S=s,
                    NB=self.blk_r0.shape[1] if self.blk_r0 is not None else 0,
                    J=ps.outg.shape[1] if ps.has_fp else 0, O=ps.out_dim,
                    D=ps.d_src)

    def shape_key(self, b: int, n_layers: int) -> tuple:
        """``(P, R, S, K_alloc, D_src, O, J, B, layers per launch)``."""
        d = self.dims
        return (d["P"], d["R"], d["S"], d["K"], d["D"], d["O"], d["J"], b,
                n_layers)

    def geometry(self, b: int) -> tuple[int, int]:
        """``(bb, threads)``: batch columns per block (the widest of 8/4/2/1
        not beyond the batch whose two ``[rows, bb]`` buffers fit in shared
        memory) and threads per block.  Refuses a stage whose largest block
        does not fit even one column."""
        if b not in self._geometry:
            rows = max(self.max_rows, 1)
            if 2 * rows * 4 > SMEM_LIMIT:
                raise NotImplementedError(
                    f"stage_matmul kernel: a block of {rows} rows needs "
                    f"{2 * rows * 4} bytes of shared memory per batch column, "
                    f"above the {SMEM_LIMIT}-byte limit")
            bb = next(c for c in (8, 4, 2, 1)
                      if (c == 1 or c < 2 * b) and 2 * rows * c * 4 <= SMEM_LIMIT)
            self._geometry[b] = (bb, min(1024, -(-rows // 32) * 32))
        return self._geometry[b]


def _tensor(a, device):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _upload(ps: PackedStage, device: torch.device) -> DeviceStage:
    _check_stage(ps)
    n_l = ps.n_layers
    sorted_src = off = None
    if ps.has_prep:
        sorted_src = np.empty_like(ps.prep_src)
        off = np.zeros((n_l, ps.k_alloc + 1), np.int32)
        for l in range(n_l):
            tgt = ps.prep_tgt[l].astype(np.int64)
            order = np.argsort(tgt, kind="stable")
            sorted_src[l] = ps.prep_src[l][order]
            np.cumsum(np.bincount(tgt, minlength=ps.k_alloc), out=off[l, 1:])

    def live(a):
        return (tuple(bool(np.any(a[l])) for l in range(n_l))
                if a is not None else (False,) * n_l)

    ds = DeviceStage(
        ps=ps, device=device, prep_src=_tensor(ps.prep_src, device),
        prep_tgt=_tensor(ps.prep_tgt, device),
        prep_sorted_src=_tensor(sorted_src, device),
        prep_off=_tensor(off, device), gidx=_tensor(ps.gidx, device),
        gexp=_tensor(ps.gexp, device), gsgn=_tensor(ps.gsgn, device),
        outg=_tensor(ps.outg, device), fs_mat=_tensor(ps.fs_mat, device),
        dw_mat=_tensor(ps.dw_mat, device), bias=_tensor(ps.bias, device),
        fs_live=live(ps.fs_mat), dw_live=live(ps.dw_mat),
        bias_live=live(ps.bias))
    if ps.has_fp:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as pool:  # numpy frees the GIL
            tables = list(pool.map(lambda l: stage_blocks(ps, l), range(n_l)))
        nb = max(t[0].size for t in tables)
        r0 = np.zeros((n_l, nb), np.int32)
        r1 = np.zeros((n_l, nb), np.int32)
        dp = np.zeros((n_l, nb), np.int32)
        for l, (a, z, d, _) in enumerate(tables):
            r0[l, :a.size], r1[l, :z.size], dp[l, :d.size] = a, z, d
        ds.max_rows = int((r1 - r0).max())
        ds.blk_r0, ds.blk_r1, ds.blk_depth = (_tensor(a, device)
                                             for a in (r0, r1, dp))
        ds.live_terms = tuple(t[3] for t in tables)
    _check_ranges(ds)
    return ds


_INT32_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535  # the levels kernel puts the row blocks on grid y


def _check_ranges(ds: DeviceStage) -> None:
    """The kernel takes every dimension as a 32-bit int and indexes rows
    (< R, < K_alloc) and per-layer offsets in 32 bits; flat offsets into
    ``[L, P, R, S]`` are formed in 64 bits (a layer of mixtral's expert
    stage holds 1.3e9 slots, two layers more than 2^31).  Refuse a stage
    whose dimensions or row blocks do not fit."""
    big = {k: v for k, v in ds.dims.items() if v > _INT32_MAX}
    if big:
        raise ValueError(f"stage dimensions beyond 32 bits: {big}")
    if ds.dims["NB"] > _GRID_Y_MAX:
        raise ValueError(f"stage has {ds.dims['NB']} row blocks a layer, the "
                         f"levels kernel's grid takes {_GRID_Y_MAX}")


def device_stage(ps: PackedStage, device) -> DeviceStage:
    """The stage's operands on ``device``, uploaded (and validated) at first
    use and cached on the stage."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in ps._dev:
        ps._dev[device] = _upload(ps, device)
    return ps._dev[device]


# ------------------------------------------------------------ K6: a stage


def _stage_layer_plain(ds: DeviceStage, l: int, src: torch.Tensor
                       ) -> torch.Tensor:
    """One layer of a stage in PyTorch operations: src [D_src, B] -> [O, B].
    The ``segs`` descriptors, when present, skip the all-identity levels and
    the term columns no active row uses."""
    ps = ds.ps
    src = src.to(torch.float32)
    b = src.shape[1]
    out = torch.zeros((ps.out_dim, b), dtype=torch.float32, device=src.device)
    inbuf = None
    if ps.has_prep:
        inbuf = torch.zeros((ps.k_alloc, b), dtype=torch.float32,
                            device=src.device)
        inbuf.index_add_(0, ds.prep_tgt[l].long(), src[ds.prep_src[l].long()])
    if ps.has_fp:
        n_p, r, s = ps.gidx.shape[1:]
        work = None
        for p in range(n_p):
            s_l = s
            if ps.segs is not None:
                a_end, _, s_live = (int(v) for v in ps.segs[l, p])
                if p > 0 and a_end == 0:
                    continue  # every chain has ended: an identity level
                s_l = max(s_live, 1)
            buf = inbuf if p == 0 else work
            g = buf[ds.gidx[l, p, :, :s_l].reshape(-1).long()].reshape(r, s_l, b)
            coef = signed_pow2(ds.gsgn[l, p, :, :s_l], ds.gexp[l, p, :, :s_l])
            work = (coef[..., None] * g).sum(dim=1)
        wext = torch.cat([work, work.new_zeros((1, b))])
        n_j = ps.outg.shape[1]
        out = out + wext[ds.outg[l].reshape(-1).long()].reshape(
            n_j, ps.out_dim, b).sum(dim=0)
    if ps.fs_mat is not None:
        out = out + ds.fs_mat[l] @ inbuf
    if ps.dw_mat is not None:
        out = out + ds.dw_mat[l] @ src
    if ps.bias is not None:
        out = out + ds.bias[l][:, None]
    return out


def stage_matmul_plain(ps: PackedStage, src: torch.Tensor, *,
                       layer: int | None = None,
                       resid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`stage_matmul` (same arguments): the
    kernel's arithmetic step by step, sums in PyTorch's own order."""
    ds = device_stage(ps, src.device)
    if layer is None:
        if resid is not None:
            raise ValueError("resid= needs layer=")
        return torch.stack([_stage_layer_plain(ds, l, src[l])
                            for l in range(ps.n_layers)])
    out = _stage_layer_plain(ds, layer, src)
    return out if resid is None else resid + out


def stage_apply_eff(ps: PackedStage, src: torch.Tensor, layer: int
                    ) -> torch.Tensor:
    """The reference's folded-effective evaluation of one layer (one product
    with ``ps.eff``): a test surface only, never on the serving path."""
    eff = torch.from_numpy(ps.eff[layer]).to(src.device)
    out = eff @ src.to(torch.float32)
    if ps.bias is not None and np.any(ps.bias[layer]):
        out = out + torch.from_numpy(ps.bias[layer]).to(src.device)[:, None]
    return out


def _ptr(t: torch.Tensor | None, layer: int = 0) -> int | None:
    """Address of layer ``layer`` of a contiguous ``[L, ...]`` tensor."""
    if t is None:
        return None
    return t.data_ptr() + layer * (t[0].numel() if t.dim() else 0) * t.element_size()


def stage_matmul(ps: PackedStage, src: torch.Tensor, *,
                 layer: int | None = None,
                 resid: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a stage: ``src [L, D_src, B] -> [L, O, B]`` over every layer in
    one launch, or with ``layer=l``: ``src [D_src, B] -> [O, B]`` for layer
    ``l`` alone, plus ``resid [O, B]`` when given (the decode step's residual
    add, folded into the kernel's epilogue).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`stage_matmul_plain`."""
    if not dispatch.on_device(src):
        return stage_matmul_plain(ps, src, layer=layer, resid=resid)
    dev = src.device
    ds = device_stage(ps, dev)
    d = ds.dims
    l0, nl = (0, ps.n_layers) if layer is None else (layer, 1)
    if not 0 <= l0 < ps.n_layers:
        raise ValueError(f"layer {layer} outside [0, {ps.n_layers})")
    b = src.shape[-1]
    lead = (nl,) if layer is None else ()
    dispatch.check_tensor("src", src, torch.float32, (*lead, ps.d_src, b), dev)
    if resid is not None:
        if layer is None:
            raise ValueError("resid= needs layer=")
        dispatch.check_tensor("resid", resid, torch.float32, (ps.out_dim, b), dev)
    if b <= 0:
        raise ValueError("empty batch")
    bb, threads = ds.geometry(b) if ps.has_fp else (1, 32)
    out = torch.empty((*lead, ps.out_dim, b), dtype=torch.float32, device=dev)
    inbuf = (torch.empty((nl, d["K"], b), dtype=torch.float32, device=dev)
             if d["K"] else None)
    work = (torch.empty((nl, d["R"], b), dtype=torch.float32, device=dev)
            if ps.has_fp else None)
    one = layer is not None

    def dense(t, live):  # a layer whose block is all zero adds nothing
        return None if t is None or (one and not live[l0]) else _ptr(t, l0)

    ptrs = [src.data_ptr(), _ptr(ds.prep_sorted_src, l0), _ptr(ds.prep_off, l0),
            _ptr(inbuf), _ptr(ds.gidx, l0), _ptr(ds.gexp, l0),
            _ptr(ds.gsgn, l0), _ptr(ds.blk_r0, l0), _ptr(ds.blk_r1, l0),
            _ptr(ds.blk_depth, l0), _ptr(work), _ptr(ds.outg, l0),
            dense(ds.fs_mat, ds.fs_live), dense(ds.dw_mat, ds.dw_live),
            dense(ds.bias, ds.bias_live),
            None if resid is None else resid.data_ptr(), out.data_ptr()]
    lib = build.load()
    with torch.cuda.device(dev):
        code = lib.repro_stage_matmul(
            *ptrs, nl, d["D"], b, d["M"], d["K"], d["P"], d["R"], d["S"],
            d["NB"], d["J"], d["O"], bb, threads, ds.max_rows,
            torch.cuda.current_stream().cuda_stream)
    dispatch.check_launch(code, "repro_stage_matmul")
    dispatch.record_launch("stage_matmul", shape=ds.shape_key(b, nl))
    return out


# ------------------------------------------------- K7: the decode step


def _rot(v, cos, sin, half):
    v1, v2 = v[..., :half], v[..., half:]
    return torch.cat([v1 * cos - v2 * sin, v2 * cos + v1 * sin], dim=-1)


def step_plan_matmul_plain(stages: dict[str, PackedStage], *, n_heads: int,
                           n_kv_heads: int, head_dim: int, d_ff: int,
                           norm: str, rope: bool, x0, pos, cos, sin, ln1, ln2,
                           kc, vc, kpos, moe=None, window: int | None = None,
                           block_tbl=None):
    """Plain PyTorch version of :func:`step_plan_matmul` (same arguments):
    the reference's dense step body, operation by operation.  With
    ``block_tbl`` the caches are block pools and are gathered into the
    ``[L, B, S, Hkv, hd]`` view first, as the reference's caller does.  With
    ``moe`` each layer's FFN is the routed block of the reference's
    ``moe_block``, through the plain versions of the route, dispatch and
    combine kernels."""
    if block_tbl is not None:
        n_l, b = kc.shape[0], block_tbl.shape[0]
        tbl = block_tbl.long()
        kc = kc[:, tbl].reshape(n_l, b, -1, *kc.shape[3:])
        vc = vc[:, tbl].reshape(n_l, b, -1, *vc.shape[3:])
    n_layers, b, smax, n_kv, hd = kc.shape
    nq, half = n_heads, head_dim // 2
    dev = x0.device
    pos = pos.long()
    kc, vc = kc.to(torch.float32), vc.to(torch.float32)

    def norm_fn(v, w):
        if norm == "rms":
            var = torch.mean(v * v, dim=0, keepdim=True)
            return v * torch.rsqrt(var + 1e-6) * w[:, None]
        mu = torch.mean(v, dim=0, keepdim=True)
        var = torch.mean((v - mu) ** 2, dim=0, keepdim=True)
        return (v - mu) * torch.rsqrt(var + 1e-5)

    cos_v = cos.to(torch.float32)[:, None, :] if rope else None
    sin_v = sin.to(torch.float32)[:, None, :] if rope else None
    sidx = torch.arange(smax, device=dev)[None, :].expand(b, smax)
    slot = (torch.where(pos >= 0, pos % smax, torch.full_like(pos, -1))
            if window is not None else pos)
    hit = sidx == slot[:, None]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                          device=dev))
    kn = torch.empty((n_layers, b, n_kv, hd), dtype=torch.float32, device=dev)
    vn = torch.empty_like(kn)
    x = x0.to(torch.float32)
    for l in range(n_layers):
        h = norm_fn(x, ln1[l] if norm == "rms" else None)
        qkv = stage_matmul_plain(stages["qkv"], h, layer=l)
        qb = qkv[: nq * hd].reshape(nq, hd, b).permute(2, 0, 1)
        kb = qkv[nq * hd: (nq + n_kv) * hd].reshape(n_kv, hd, b).permute(2, 0, 1)
        vb = qkv[(nq + n_kv) * hd:].reshape(n_kv, hd, b).permute(2, 0, 1)
        if rope:
            qb, kb = _rot(qb, cos_v, sin_v, half), _rot(kb, cos_v, sin_v, half)
        kn[l], vn[l] = kb, vb
        qg = qb.reshape(b, n_kv, nq // n_kv, hd)
        scores = torch.einsum("bhgd,bshd->bhgs", qg, kc[l])
        s_new = torch.einsum("bhgd,bhd->bhg", qg, kb)
        scores = torch.where(hit[:, None, None, :], s_new[..., None], scores)
        kp = kpos[l].long()
        ok = (kp >= 0) & (kp <= pos[:, None])
        if window is not None:
            ok = ok & (kp > pos[:, None] - window)
        valid = torch.where(hit, (pos >= 0)[:, None], ok)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        mask = torch.where(valid, zero, zero + _NEG)
        probs = torch.softmax(scores * scale + mask[:, None, None, :], dim=-1)
        hitf = hit.to(torch.float32)[:, None, None, :]
        p_hit = torch.sum(probs * hitf, dim=-1)
        att = (torch.einsum("bhgs,bshd->bhgd", probs * (1.0 - hitf), vc[l])
               + p_hit[..., None] * vb[:, :, None, :])
        x = x + stage_matmul_plain(stages["o"], att.reshape(b, nq * hd).T,
                                   layer=l)
        h2 = norm_fn(x, ln2[l] if norm == "rms" else None)
        if moe is not None:
            x = _moe_layer_plain(stages, moe, l, h2, x)
            continue
        gu = stage_matmul_plain(stages["gu"], h2, layer=l)
        hf = F.silu(gu[:d_ff]) * gu[d_ff:]
        x = x + stage_matmul_plain(stages["dn"], hf, layer=l)
    return x, kn, vn


def _moe_args(moe: dict, b: int, device) -> tuple:
    """``(router [L, d, E] f32 on device, E, k, cap, E * d_ff_expert)``."""
    n_exp, top_k = moe["n_experts"], moe["top_k"]
    cap = capacity(b, top_k, moe["capacity_factor"], n_exp,
                   moe.get("min_capacity", 4))
    router = torch.as_tensor(moe["router"], dtype=torch.float32, device=device)
    return router, n_exp, top_k, cap, moe["d_ff"]


def _moe_layer_plain(stages, moe, l, h2, x):
    """One layer's routed FFN plus residual (the reference's ``moe_block``):
    x [d, B] + experts(h2 [d, B])."""
    router, n_exp, top_k, cap, eff = _moe_args(moe, h2.shape[1], h2.device)
    sel, wgt, slot, src_tok = moe_route_plain(
        h2, router[l], top_k=top_k, cap=cap, norm_topk=moe["norm_topk"],
        dropped=moe.get("dropped"))
    src = moe_dispatch_plain(h2, slot, src_tok, n_exp, cap)
    eg = stage_matmul_plain(stages["eg"], src, layer=l)
    hf = F.silu(eg[:eff]) * eg[eff:]
    ob = stage_matmul_plain(stages["ed"], hf, layer=l)
    return moe_combine_plain(x, ob, slot, wgt, n_exp, cap)


def step_plan_matmul(stages: dict[str, PackedStage], *, n_heads: int,
                     n_kv_heads: int, head_dim: int, d_ff: int, norm: str,
                     rope: bool, x0, pos, cos, sin, ln1, ln2, kc, vc, kpos,
                     moe=None, window: int | None = None, block_tbl=None):
    """Whole decode step for all L identical layers (dense and MoE families).

      x0   [d, B] f32    embedded tokens (feature-major)
      pos  [B] int32     decode positions (-1 = idle slot)
      cos/sin [B, hd/2]  rope tables for ``pos`` (None when rope=False)
      ln1/ln2 [L, d]     rms weights (None when norm == "nonparam")
      kc/vc [L, B, S, Hkv, hd], kpos [L, B, S]   the KV cache
      block_tbl [B, mb] int32 (optional): kc/vc are then block pools
                         [L, Nb, bs, Hkv, hd] read through the table

    ``moe`` (the MoE family, K8): every layer's FFN is the routed experts,
    stages ``eg``/``ed`` in place of ``gu``/``dn``.  Keys: ``router``
    [L, d, E] float32, ``n_experts``, ``top_k``, ``capacity_factor``,
    ``norm_topk``, ``min_capacity``, ``d_ff`` (= E * d_ff_expert) as in the
    reference, and optionally ``dropped`` (int32 ``[1]`` on the step's
    device), incremented by the dropped choices.  All B columns are routed,
    idle slots included, as in the reference.

    Returns ``(y [d, B], k_new [L, B, Hkv, hd], v_new)``: the final hidden
    state and the per-layer K/V rows for the caller to write back.  The cache
    is read, never written.  CUDA tensors launch the kernels (or raise); CPU
    tensors take :func:`step_plan_matmul_plain`."""
    args = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
                d_ff=d_ff, norm=norm, rope=rope, x0=x0, pos=pos, cos=cos,
                sin=sin, ln1=ln1, ln2=ln2, kc=kc, vc=vc, kpos=kpos, moe=moe,
                window=window, block_tbl=block_tbl)
    if not dispatch.on_device(x0):
        return step_plan_matmul_plain(stages, **args)
    dev = x0.device
    d, b = x0.shape
    nq, nkv, hd = n_heads, n_kv_heads, head_dim
    n_layers = kpos.shape[0]
    smax = kpos.shape[2]
    f32, i32 = torch.float32, torch.int32
    dispatch.check_tensor("x0", x0, f32, (d, b), dev)
    dispatch.check_tensor("pos", pos, i32, (b,), dev)
    dispatch.check_tensor("kpos", kpos, i32, (n_layers, b, smax), dev)
    if block_tbl is None:
        bs = mb = 0
        cache_shape = (n_layers, b, smax, nkv, hd)
    else:
        mb = block_tbl.shape[1]
        bs = kc.shape[2]
        dispatch.check_tensor("block_tbl", block_tbl, i32, (b, mb), dev)
        cache_shape = (n_layers, kc.shape[1], bs, nkv, hd)
        if mb * bs != smax:
            raise ValueError(f"block table covers {mb * bs} slots, kpos {smax}")
    dispatch.check_tensor("kc", kc, f32, cache_shape, dev)
    dispatch.check_tensor("vc", vc, f32, cache_shape, dev)
    if rope:
        dispatch.check_tensor("cos", cos, f32, (b, hd // 2), dev)
        dispatch.check_tensor("sin", sin, f32, (b, hd // 2), dev)
    if norm == "rms":
        dispatch.check_tensor("ln1", ln1, f32, (n_layers, d), dev)
        dispatch.check_tensor("ln2", ln2, f32, (n_layers, d), dev)
    elif norm != "nonparam":
        raise ValueError(f"norm {norm!r}: the step takes 'rms' or 'nonparam'")
    for name in _STAGE_ORDER if moe is None else _MOE_STAGE_ORDER:
        if stages[name].n_layers != n_layers:
            raise ValueError(f"stage {name} has {stages[name].n_layers} "
                             f"layers, the cache {n_layers}")
    mode, eps = (0, 1e-6) if norm == "rms" else (1, 1e-5)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    key = (n_layers, d, d_ff, b, smax, nq, nkv, hd)
    if moe is not None:
        router, n_exp, top_k, cap, eff = _moe_args(moe, b, dev)
        dispatch.check_tensor("router", router, f32, (n_layers, d, n_exp), dev)
    kn = torch.empty((n_layers, b, nkv, hd), dtype=f32, device=dev)
    vn = torch.empty_like(kn)
    lib = build.load()

    def norm_(x, w, l):
        out = torch.empty_like(x)
        dispatch.check_launch(lib.repro_step_norm(
            x.data_ptr(), _ptr(w, l), out.data_ptr(), d, b, mode, eps, stream),
            "repro_step_norm")
        dispatch.record_launch("step_plan_matmul", shape=key)
        return out

    def swiglu_(gu, n, cols):
        hf = torch.empty((n, cols), dtype=f32, device=dev)
        dispatch.check_launch(lib.repro_step_swiglu(
            gu.data_ptr(), hf.data_ptr(), n, cols, stream), "repro_step_swiglu")
        dispatch.record_launch("step_plan_matmul", shape=key)
        return hf

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        x = x0
        for l in range(n_layers):
            h = norm_(x, ln1, l)
            qkv = stage_matmul(stages["qkv"], h, layer=l)
            att = torch.empty((nq * hd, b), dtype=f32, device=dev)
            dispatch.check_launch(lib.repro_step_attention(
                qkv.data_ptr(), pos.data_ptr(), _ptr(cos), _ptr(sin),
                _ptr(kc, l), _ptr(vc, l), _ptr(kpos, l), _ptr(block_tbl),
                att.data_ptr(), _ptr(kn, l), _ptr(vn, l), b, smax, nq, nkv,
                hd, bs, mb, window or 0, scale, stream), "repro_step_attention")
            dispatch.record_launch("step_plan_matmul", shape=key)
            x = stage_matmul(stages["o"], att, layer=l, resid=x)
            h2 = norm_(x, ln2, l)
            if moe is None:
                gu = stage_matmul(stages["gu"], h2, layer=l)
                x = stage_matmul(stages["dn"], swiglu_(gu, d_ff, b), layer=l,
                                 resid=x)
                continue
            sel, wgt, slot, src_tok = moe_route(
                h2, router[l], top_k=top_k, cap=cap,
                norm_topk=moe["norm_topk"], dropped=moe.get("dropped"))
            src = moe_dispatch(h2, slot, src_tok, n_exp, cap)
            eg = stage_matmul(stages["eg"], src, layer=l)
            ob = stage_matmul(stages["ed"], swiglu_(eg, eff, cap), layer=l)
            x = moe_combine(x, ob, slot, wgt, n_exp, cap)
    return x, kn, vn


# ------------------------------------------- K9: one MoE layer's experts


def moe_plan_matmul_plain(stage_a: PackedStage, stage_b: PackedStage, *,
                          d_ff_total: int, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_plan_matmul` (same arguments):
    stage A, SwiGLU, stage B through :func:`stage_matmul_plain`."""
    h = stage_matmul_plain(stage_a, src, layer=0)
    hf = F.silu(h[:d_ff_total]) * h[d_ff_total:]
    return stage_matmul_plain(stage_b, hf, layer=0)


def moe_plan_matmul(stage_a: PackedStage, stage_b: PackedStage, *,
                    d_ff_total: int, src: torch.Tensor) -> torch.Tensor:
    """One MoE layer's expert FFNs: ``src [E*d, C] -> [E*d, C]`` float32.

    Stage A emits all experts' gates at rows ``[0, E*dff)`` and ups at
    ``[E*dff, 2*E*dff)`` (e-major, expert ``e`` reading ``src`` rows
    ``[e*d, (e+1)*d)``); SwiGLU; stage B applies the downs.  Both stages are
    one-layer :class:`~repro_torch.kernels.ops.PackedStage` s.  Replaces the
    reference's single ``pallas_call``; here K6 ``stage_matmul``, the
    ``repro_step_swiglu`` kernel of ``csrc/step_plan.cu`` and K6 again, with
    no PyTorch operation between them.  The SwiGLU launch is this wrapper's
    own count (``moe_plan_matmul``); the stages count as ``stage_matmul``.
    CUDA tensors launch the kernels (or raise); CPU tensors take
    :func:`moe_plan_matmul_plain`."""
    if stage_a.n_layers != 1 or stage_b.n_layers != 1:
        raise ValueError("an MoE plan's stages hold one layer each")
    if stage_a.out_dim != 2 * d_ff_total or stage_b.d_src != d_ff_total:
        raise ValueError(
            f"stage A emits {stage_a.out_dim} rows and stage B reads "
            f"{stage_b.d_src}, expected {2 * d_ff_total} and {d_ff_total}")
    if not dispatch.on_device(src):
        return moe_plan_matmul_plain(stage_a, stage_b, d_ff_total=d_ff_total,
                                     src=src)
    dev = src.device
    c = src.shape[-1]
    h = stage_matmul(stage_a, src, layer=0)  # checks src

    hf = torch.empty((d_ff_total, c), dtype=torch.float32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        code = lib.repro_step_swiglu(h.data_ptr(), hf.data_ptr(), d_ff_total, c,
                                     torch.cuda.current_stream().cuda_stream)
    dispatch.check_launch(code, "repro_step_swiglu")
    dispatch.record_launch("moe_plan_matmul", shape=(
        stage_a.d_src, d_ff_total, stage_b.out_dim, c))
    return stage_matmul(stage_b, hf, layer=0)
