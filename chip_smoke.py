#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # all phases, one GPU, no network

Drives the port's main paths — prox-regularized training (olmo-1b at full
width, the paper's MLP) and compressed serving at published width
through ``Scheduler`` + ``ServingEngine(artifact=...)``: olmo-1b (dense) and
mixtral-8x22b (MoE, 8 experts top-2, cut to 2 layers), each once through the
per-region route (bf16, kernels K1-K3; mixtral's experts as grouped K2
launches of 8) and once through the whole-step layer plan (float32, kernels
K6 and K7; for mixtral K8, the routed FFN inside the step) — and holds every
CUDA kernel on those paths against its plain PyTorch version:

1. device and build: needs a CUDA device (exits non-zero without one), prints
   the card's name and power limit, builds the kernels with ``nvcc``; then
   the full-width float32 artifact and its layer plan (stage packing timed);
2. kernels: ``lcc_chain_matmul``, ``lcc_group_matmul``, ``cluster_segment_sum``,
   ``stage_matmul`` and ``step_plan_matmul`` at reduced shapes and at the main
   paths' own dimensions (layer 0 of the full-width artifact and its plan, and
   one full-width step), each compared with its plain version and timed (CUDA
   events, L2 flushed between launches) beside a bound, the plain version and
   one library call where one computes the same function; the last phase
   fails if a serve launched a kernel at dimensions this phase did not check;
3. reduced serve: plan route == per-region route == plain route (CPU) ==
   dense-effective;
4. full-width serve, per-region route: olmo-1b in bf16 (the plan needs
   float32), d_model 2048, d_ff 8192, vocab 50304;
5. full-width serve, plan route: the same model in float32, 16 layers; one
   step's logits against the per-region route on the same artifact.
   ``--layers`` cuts the depth of both olmo serves (never the width);
6. mixtral-8x22b at full width (d_model 6144, 8 experts of d_ff 16384,
   vocab 32768), 2 layers: its K8 kernels (route, dispatch, combine) and a
   reduced serve (plan == per-region == plain == dense, capacity drops
   occurring); the per-region kernels at its shapes and the bf16 per-region
   serve; then the plan packed and uploaded, K6 on its expert stages, one
   full-width step, and the float32 plan serve; plan vs per-region logits;
7. training (``--only train`` runs these alone): K5 ``group_prox`` on the
   reference's hard cases and rows of every width to 16384 in float32 and
   bf16, then at the training runs' own views, each against its plain
   version and the oracle, bitwise from run to run, in place == out of
   place, timed; olmo-1b at full width (bf16, remat) trained by
   ``make_train_step`` with ProxSGD over every site (batch 8 x 512 tokens):
   a warm and five timed steps, 7 K5 launches a step, the update through K5
   against the other route, a profiled step; the paper's MLP through the
   port's launcher (``--arch mlp --prox``), 2 K5 launches a step.

One JSON object per line; a failed phase ends the run with a non-zero exit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import resource
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.data.synthetic import MarkovLM  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.kernels.group_prox import (  # noqa: E402
    group_prox, group_prox_plain)
from repro_torch.kernels.ref import group_prox_ref  # noqa: E402
from repro_torch.kernels.lcc_chain_matmul import (  # noqa: E402
    _levels_plain, _slice_inputs_plain, lcc_chain_matmul,
    lcc_chain_matmul_plain, plan_launch)
from repro_torch.kernels.layer_plan import (  # noqa: E402
    device_stage, stage_matmul, stage_matmul_plain, step_plan_matmul,
    step_plan_matmul_plain)
from repro_torch.kernels.lcc_group_matmul import (  # noqa: E402
    lcc_group_matmul, lcc_group_matmul_plain)
from repro_torch.kernels.moe_route import (  # noqa: E402
    capacity, moe_combine, moe_combine_plain, moe_dispatch, moe_dispatch_plain,
    moe_route, moe_route_plain)
from repro_torch.kernels.shared_matmul import (  # noqa: E402
    cluster_segment_sum, cluster_segment_sum_plain, csr_from_labels)
from repro_torch.models import api  # noqa: E402
from repro_torch.models.layers import _rope_sincos  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.executor import CompressedExecutor  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.testing import (decomposition_dense, dense_sites,  # noqa: E402
                                 moe_sites, seeded_artifact,
                                 seeded_decomposition)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BATCH = 8  # decode batch of the main path (n_slots)
# |kernel - plain| <= SUM_TOL * max(1, max|plain|): both sum the E slice
# results in float32, the kernel slice by slice in launch order, torch.sum in
# its own order
SUM_TOL = 2e-5

KERNELS = {
    "lcc_chain_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lcc_chain_matmul.cu",
        replaces="src/repro/kernels/lcc_chain_matmul.py:147"),
    "lcc_group_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lcc_group_matmul.cu",
        replaces="src/repro/kernels/lcc_group_matmul.py:92"),
    "cluster_segment_sum": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/cluster_segment_sum.cu",
        replaces="src/repro/kernels/shared_matmul.py:60"),
    "stage_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/stage_matmul.cu",
        replaces="src/repro/kernels/layer_plan.py:483"),
    "step_plan_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/step_plan.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    # K8: the MoE branch of step_plan_matmul, body moe_block (:332-365)
    "moe_route": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/moe_route.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    "moe_dispatch": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/moe_route.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    "moe_combine": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/moe_route.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    "group_prox": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/group_prox.cu",
        replaces="src/repro/kernels/group_prox.py:56"),
}
PER_REGION = ("lcc_chain_matmul", "lcc_group_matmul", "cluster_segment_sum")
PLAN = ("stage_matmul", "step_plan_matmul")
MOE = ("moe_route", "moe_dispatch", "moe_combine")
# the device kernels of this port, by name fragment (profiler rows)
PORT_KERNELS = ("lcc_chain_kernel", "lcc_reduce_kernel",
                "cluster_segment_sum_kernel", "stage_prep_kernel",
                "stage_levels_kernel", "stage_epilogue_kernel",
                "step_norm_kernel", "step_attention_kernel",
                "step_swiglu_kernel", "moe_route_kernel",
                "moe_dispatch_kernel", "moe_combine_kernel",
                "group_prox_kernel")
MIXTRAL_LAYERS = 2  # the one cut: 56 layers do not fit one card
MAX_LEN = 128  # the serves' KV view: 8 blocks of 16 tokens
# |step kernel - plain| <= STEP_TOL * max(1, max|plain|): float32 sums in
# other orders through every stage, norm and softmax of all the layers (each
# stage alone stays within SUM_TOL)
STEP_TOL = 1e-4
# plan route vs per-region route logits at full width: both float32, the
# chains evaluated in other groupings (fused CSD levels, one gather per
# stage) over 16 layers
ROUTE_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------- timing


class Timer:
    """Median device time of single launches, the L2 cache flushed before
    each (a decode step streams gigabytes between two launches of one site,
    so the real caller finds the cache cold).  A spin kernel is queued ahead
    of the first event so the host has enqueued everything before the device
    gets there: the events then bracket device time, not the wrapper's host
    time, which would swamp a kernel of a few microseconds."""

    SPIN_CYCLES = 1_000_000  # about half a millisecond at the card's clock

    def __init__(self, device, iters: int = 7):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        self.iters = iters

    def __call__(self, fn, cold: bool = True) -> float:
        fn()  # warm-up: first-launch set-up is not the kernel's time
        pairs = []
        for _ in range(self.iters):
            if cold:
                self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in pairs]))


# ------------------------------------------------------- phase 2: kernels


def dyadic(rng, shape, device):
    """Multiples of 1/8 in [-1, 1]."""
    return torch.from_numpy(rng.integers(-8, 9, size=shape).astype(np.float32)
                            / 8.0).to(device)


def ordered_plain(ds, x, sm_count):
    """The plain version's per-slice results summed in the kernel's order:
    slice by slice inside a block's chunk, then chunk by chunk."""
    idx = ds.idx if ds.idx.dim() == 5 else ds.idx[None]
    g, e, _, n, _ = idx.shape
    c0, w, ln = (t.reshape(g, e) for t in (ds.slice_c0, ds.slice_w, ds.chain_len))
    d = max(n, int(w.max()))
    per = _levels_plain(idx, ds.exp.reshape(idx.shape), ds.sign.reshape(idx.shape),
                        _slice_inputs_plain(x, c0, w, d))  # [G, E, N, B]
    _, _, chunks, spb = plan_launch(n, x.shape[1], g, e, sm_count)
    live = (ln > 0).cpu().numpy()
    out = torch.zeros((g, n, x.shape[1]), dtype=torch.float32, device=x.device)
    for gi in range(g):
        for c in range(chunks):
            acc = None
            for ei in range(c * spb, min(e, (c + 1) * spb)):
                if live[gi, ei]:
                    acc = per[gi, ei] if acc is None else acc + per[gi, ei]
            if acc is not None:
                out[gi] += acc
    return out


def live_terms(packed_list) -> int:
    """Terms the data needs: sign != 0 in real (not identity-padding) factors."""
    total = 0
    for pk in packed_list:
        for ei, ln in enumerate(pk.chain_lengths):
            total += int((pk.sign[ei, :ln] != 0).sum())
    return total


def chain_bound(packed_list, k_rows, n_out, b):
    """(bound_ms, bound_by): streams + input + output bytes over the memory
    rate against 2 operations per live term and column over the f32 rate."""
    terms = live_terms(packed_list)
    bytes_ = 6 * terms + 4 * b * (k_rows + n_out)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * terms * b / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, tol):
    err = float((got - want).abs().max())
    lim = tol * max(1.0, float(want.abs().max()))
    if not (err <= lim) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: max_abs_err {err:.3e} > {lim:.3e}")
    return err


def kernel_row(name, label, dims, key, err, exact, wrapper, plain, library,
               bound, timer, serve=None, **extra):
    """One row of the kernels line.  ``key`` is the dimension tuple under
    which the wrapper counts its launches (dispatch.launch_counts_by_shape);
    ``library`` is None where no single PyTorch call computes the function;
    ``serve`` names the full-width serve whose shapes the row checks (None
    for the reduced cases)."""
    ms = timer(wrapper)
    # one line a case as it completes: a later failure keeps the earlier ones
    emit(dict(phase="kernel_case", name=name, shape=label, ms=ms,
              max_abs_err=err))
    return dict(name=name, shape=label, dims=dims, shape_key=list(key),
                max_abs_err=err, max_err=err, exact_in_kernel_order=exact,
                ms=ms, kernel_ms=ms, **extra, plain_ms=timer(plain),
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=None if library is None else timer(library),
                serve=serve)


def kernel_case_chain(label, pk, rng, dev, timer, sm, batch=BATCH):
    """``lcc_chain_matmul`` on one packed decomposition at its own dims."""
    ds = pk.on(dev)
    k = pk.in_dim
    x = dyadic(rng, (k, batch), dev)
    args = (ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w, ds.chain_len)
    y = lcc_chain_matmul(*args)
    torch.cuda.synchronize()
    plain = lcc_chain_matmul_plain(*args)
    err = check_close(label, y, plain, SUM_TOL)
    # with two terms a row's sum is a single rounded add, so in the kernel's
    # slice order the plain version must match bit for bit; with more terms
    # torch.sum's order inside a row is its own
    exact = pk.idx.shape[3] == 2
    if exact and not torch.equal(y[None], ordered_plain(ds, x, sm)):
        fail(f"{label}: kernel differs from the plain version summed in the "
             "kernel's own (fixed) slice order")
    w_eff = decomposition_dense(pk, dev)
    check_close(label + " vs dense", y[: pk.out_dim], w_eff @ x, 1e-4)
    e, p, n, s = pk.idx.shape
    return kernel_row(
        "lcc_chain_matmul", label, dict(E=e, P=p, N=n, S=s, K=k, B=batch),
        (e, p, n, s, k, batch), err, exact,
        lambda: lcc_chain_matmul(*args), lambda: lcc_chain_matmul_plain(*args),
        lambda: torch.matmul(w_eff, x), chain_bound([pk], k, n, batch), timer,
        warm_l2_ms=timer(lambda: lcc_chain_matmul(*args), cold=False))


def kernel_case_group(label, members, rng, dev, timer, sm, batch=BATCH):
    """``lcc_group_matmul`` on packed decompositions grouped as the executor
    groups them; members may differ in input width."""
    pg = ops.pack_group(members)
    ds = pg.on(dev)
    xs = [dyadic(rng, (m.in_dim, batch), dev) for m in members]
    x = torch.cat(xs)
    args = (ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w, ds.chain_len)
    y = lcc_group_matmul(*args)
    torch.cuda.synchronize()
    plain = lcc_group_matmul_plain(*args)
    err = check_close(label, y, plain, SUM_TOL)
    if not torch.equal(y, ordered_plain(ds, x, sm)):
        fail(f"{label}: kernel differs from the plain version summed in the "
             "kernel's own (fixed) slice order")
    # the library yardstick is one bmm: members zero-padded to common dims
    g, e, p, n, s = pg.idx.shape
    k_max = max(m.in_dim for m in members)
    w_eff = torch.zeros((g, n, k_max), dtype=torch.float32, device=dev)
    xg = torch.zeros((g, k_max, batch), dtype=torch.float32, device=dev)
    for gi, (m, xm) in enumerate(zip(members, xs)):
        w_eff[gi, : m.out_dim, : m.in_dim] = decomposition_dense(m, dev)
        xg[gi, : m.in_dim] = xm
    check_close(label + " vs dense", y, torch.bmm(w_eff, xg), 1e-4)
    k = x.shape[0]
    return kernel_row(
        "lcc_group_matmul", label, dict(G=g, E=e, P=p, N=n, S=s, K=k, B=batch),
        (g, e, p, n, s, k, batch), err, True,
        lambda: lcc_group_matmul(*args), lambda: lcc_group_matmul_plain(*args),
        lambda: torch.bmm(w_eff, xg), chain_bound(members, k, g * n, batch),
        timer, warm_l2_ms=timer(lambda: lcc_group_matmul(*args), cold=False))


def kernel_case_segsum(label, sites, c, rng, dev, timer, batch=BATCH):
    """``cluster_segment_sum`` on every label vector of ``sites`` (name ->
    labels, all of one length, ``c`` clusters); the first one is timed."""
    first = None
    for site, labels_np in sites.items():
        k = labels_np.size
        labels = torch.from_numpy(labels_np.astype(np.int64)).to(dev)
        csr = csr_from_labels(labels_np, c, dev)
        x = dyadic(rng, (k, batch), dev)
        y = cluster_segment_sum(labels, x, c, csr=csr)
        torch.cuda.synchronize()
        plain = cluster_segment_sum_plain(labels, x, c)
        # dyadic inputs and short segments: every sum is exact, so the order
        # of the plain version's atomics cannot show
        if not torch.equal(y, plain):
            fail(f"{label} {site}: kernel differs from the plain version on "
                 "dyadic input")
        first = first or (labels, csr, x, k)
    labels, csr, x, k = first
    bytes_ = 4 * batch * (k + c) + 4 * (k + c + 1)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = k * batch / F32_FLOPS * 1e3
    out = torch.zeros((c, batch), dtype=torch.float32, device=dev)
    return kernel_row(
        "cluster_segment_sum", label, dict(K=k, C=c, B=batch), (k, c, batch),
        0.0, True, lambda: cluster_segment_sum(labels, x, c, csr=csr),
        lambda: cluster_segment_sum_plain(labels, x, c),
        lambda: out.zero_().index_add_(0, labels, x),
        (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"),
        timer, checked_sites=list(sites))


def seeded_labels(k, rng):
    """Labels of a weight-shared site as the fixture makes them: a sixteenth
    of the rows merged into other rows' clusters."""
    merged = max(1, k // 16)
    c = k - merged
    labels = np.concatenate([rng.permutation(c), rng.integers(0, c, merged)])
    return labels[rng.permutation(k)].astype(np.int64), c


def reduced_kernel_cases(cfg, dev, timer, sm):
    """Every kernel at the reduced widths, plus what the full-width path does
    not reach: other term counts per row and ragged batch widths."""
    d, dff = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(10)

    def pack(n, k, **kw):
        return ops.pack_decomposition(seeded_decomposition(n, k, rng, **kw))

    rows = [kernel_case_chain("reduced attn.o", pack(d, d), rng, dev, timer, sm),
            kernel_case_chain("reduced ffn.down", pack(d, dff), rng, dev, timer, sm),
            kernel_case_group("reduced attn.qkv", [pack(d, d) for _ in range(3)],
                              rng, dev, timer, sm),
            kernel_case_group("reduced ffn.gate+up", [pack(dff, d) for _ in range(2)],
                              rng, dev, timer, sm)]
    labels, c = seeded_labels(dff, rng)
    rows.append(kernel_case_segsum(f"reduced K={dff}", {"seeded": labels}, c,
                                   rng, dev, timer))
    for s_terms in (1, 3):
        rows.append(kernel_case_chain(f"reduced attn.o S={s_terms}",
                                      pack(d, d, s_terms=s_terms), rng, dev,
                                      timer, sm))
    for batch in (1, 5, 13):  # a ragged last block of columns
        rows.append(kernel_case_chain(f"reduced ffn.down B={batch}", pack(d, dff),
                                      rng, dev, timer, sm, batch=batch))
    rows.append(kernel_case_group("reduced attn.qkv B=3",
                                  [pack(d, d) for _ in range(3)], rng, dev,
                                  timer, sm, batch=3))
    return rows


def main_path_kernel_cases(art, dev, timer, sm):
    """Every kernel at exactly the dimensions the full-width serve launches
    it at: layer 0's own packed decompositions, grouped as the executor groups
    them, and the label vectors of its weight-shared sites, at B = n_slots."""
    rng = np.random.default_rng(20)
    pk = art.packed
    rows = [kernel_case_chain(f"full {site}", pk[f"{site}.l0"], rng, dev, timer, sm)
            for site in ("attn.o", "ffn.down")]
    for label, names in (("attn.qkv", ("attn.q", "attn.k", "attn.v")),
                         ("ffn.gate+up", ("ffn.gate", "ffn.up"))):
        rows.append(kernel_case_group(f"full {label}",
                                      [pk[f"{n}.l0"] for n in names], rng, dev,
                                      timer, sm))
        torch.cuda.empty_cache()
    by_dims = {}
    for name, rec in art.records.items():
        if name.endswith(".l0") and rec.shared is not None:
            labels = np.asarray(rec.shared.labels)
            by_dims.setdefault((labels.size, rec.shared.n_clusters), {})[name] = labels
    if not by_dims:
        fail("the fixture has no weight-shared site: cluster_segment_sum is "
             "not on the main path")
    for (k, c), sites in sorted(by_dims.items()):
        rows.append(kernel_case_segsum(f"full K={k} C={c}", sites, c, rng, dev, timer))
    return rows


# ------------------------------------------------ K6 and K7: layer plans


def bound_of(bytes_, flops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def stage_cost(ds, layers, batch) -> tuple[int, int]:
    """(bytes, operations) one stage needs for ``layers``: its live terms in
    the levels it runs (6 bytes and one multiply-add per batch column each),
    the nonzero dense blocks, input and output read/written once."""
    ps = ds.ps
    bytes_ = flops = 0
    for l in layers:
        terms = ds.live_terms[l] if ps.has_fp else 0
        dense = (ps.out_dim * ps.k_alloc if ds.fs_live[l] else 0) + \
            (ps.out_dim * ps.d_src if ds.dw_live[l] else 0)
        bytes_ += 6 * terms + 4 * dense + 4 * batch * (ps.d_src + ps.out_dim)
        flops += 2 * (terms + dense) * batch
    return bytes_, flops


STAGE_SITES = {"qkv": (("attn", "q"), ("attn", "k"), ("attn", "v")),
               "o": (("attn", "o"),), "gu": (("ffn", "gate"), ("ffn", "up")),
               "dn": (("ffn", "down"),)}


def stage_weights(art, name, layer, dev):
    """One stage's dense-effective ``[O, D_src]`` float32 matrix of one layer,
    from the artifact's parameters (never from the folded ``eff``)."""
    blocks = art.params["blocks"]
    return torch.cat([blocks[b][p]["w"][layer].to(dev, torch.float32).T
                      for b, p in STAGE_SITES[name]]).contiguous()


def kernel_case_stage(label, ps, rng, dev, timer, *, layer=0, batch=BATCH,
                      exact=False, w=None):
    """``stage_matmul`` on one layer of one stage at ``batch`` columns, held
    against its plain version (bit for bit when ``exact``: dyadic input on a
    stage whose every sum is exact) and against one dense product."""
    ds = device_stage(ps, dev)
    src = dyadic(rng, (ps.d_src, batch), dev)
    y = stage_matmul(ps, src, layer=layer)
    torch.cuda.synchronize()
    plain = stage_matmul_plain(ps, src, layer=layer)
    err = check_close(label, y, plain, SUM_TOL)
    if exact and not torch.equal(y, plain):
        fail(f"{label}: kernel differs from the plain version on dyadic input")
    bias = (torch.from_numpy(ps.bias[layer]).to(dev)
            if ps.bias is not None else None)
    if w is None:  # the stage's own linear map, column by column
        eye = torch.eye(ps.d_src, dtype=torch.float32, device=dev)
        w = stage_matmul_plain(replace(ps, bias=None), eye, layer=layer)
    library = ((lambda: torch.addmm(bias[:, None], w, src)) if bias is not None
               else (lambda: torch.matmul(w, src)))
    check_close(label + " vs dense", y, library(), 1e-4)
    d = ds.dims
    bb, threads = ds.geometry(batch)
    return kernel_row(
        "stage_matmul", label,
        dict(P=d["P"], R=d["R"], S=d["S"], K=d["K"], D=d["D"], O=d["O"],
             J=d["J"], B=batch, blocks=int((ds.blk_r1[layer] > ds.blk_r0[layer]).sum()),
             max_rows=ds.max_rows, bb=bb, threads=threads),
        ds.shape_key(batch, 1), err, exact,
        lambda: stage_matmul(ps, src, layer=layer),
        lambda: stage_matmul_plain(ps, src, layer=layer), library,
        bound_of(*stage_cost(ds, [layer], batch)), timer,
        live_terms=ds.live_terms[layer], segs=ps.segs is not None,
        warm_l2_ms=timer(lambda: stage_matmul(ps, src, layer=layer), cold=False))


def handbuilt_stage(rng, *, p, s=4, r=4096, group=512, k_in=256, d_src=300,
                    dense=False):
    """A one-layer stage around raw CSD levels: level 0 reads the prep
    buffer, level >= 1 rows read rows of their own ``group`` (so the kernel
    gets several blocks); prep pairs share targets (weight sharing) and
    carry padding pairs into the dead row; with ``dense``, nonzero dyadic
    fs/dw blocks and a bias.  Exponents and inputs are small dyadic numbers,
    so every sum is exact."""
    idx = np.zeros((p, r, s), np.int64)
    idx[0] = rng.integers(0, k_in, (r, s))
    for q in range(1, p):
        idx[q] = (np.arange(r) // group * group)[:, None] + rng.integers(0, group, (r, s))
    exp = rng.integers(-2, 2, (p, r, s))
    sgn = rng.choice([-1, 0, 1, 1], (p, r, s))
    labels = np.concatenate([np.arange(k_in), rng.integers(0, k_in, d_src - k_in)])
    labels = labels[rng.permutation(d_src)]
    m = d_src + 5  # five padding pairs: source 0 into the dead row
    prep_src = np.zeros(m, np.int32)
    prep_src[:d_src] = np.arange(d_src)
    prep_tgt = np.full(m, k_in, np.int32)
    prep_tgt[:d_src] = labels
    out = r // 2  # every output row sums two rows of the last level
    outg = np.stack([np.arange(out), out + np.arange(out)]).astype(np.int32)
    outg[1, ::7] = r  # some entries read the zero row
    fs = dw = bias = None
    if dense:
        fs = (rng.integers(-4, 5, (1, out, k_in + 1)) / 8).astype(np.float32)
        fs[..., -1] = 0.0  # the dead row's column
        dw = (rng.integers(-4, 5, (1, out, d_src)) / 8).astype(np.float32)
        bias = (rng.integers(-8, 9, (1, out)) / 8).astype(np.float32)
    return ops.PackedStage(
        prep_src=prep_src[None], prep_tgt=prep_tgt[None],
        gidx=idx.astype(np.int32)[None], gexp=exp.astype(np.int8)[None],
        gsgn=sgn.astype(np.int8)[None], outg=outg[None], fs_mat=fs,
        dw_mat=dw, bias=bias, k_alloc=k_in + 1, d_src=d_src, out_dim=out,
        n_layers=1, site_names=("handbuilt",))


def reduced_stage_cases(red_plan, dev, timer):
    """K6 where the full-width path does not reach: hand-built exact stages
    (odd and even level counts, S = 4 and S = 3 slots a row, weight-shared
    prep with padding pairs, nonzero fs/dw/bias), the reduced plan's stages
    with and without ``segs``, and ragged batch widths."""
    rng = np.random.default_rng(30)
    rows = [kernel_case_stage("hand P=3", handbuilt_stage(rng, p=3), rng, dev,
                              timer, exact=True),
            kernel_case_stage("hand P=2 S=3", handbuilt_stage(rng, p=2, s=3),
                              rng, dev, timer, exact=True),
            kernel_case_stage("hand P=3 fs+dw+bias",
                              handbuilt_stage(rng, p=3, dense=True), rng, dev,
                              timer, exact=True)]
    st = red_plan.stages
    for name in ("qkv", "o", "gu", "dn"):
        rows.append(kernel_case_stage(f"reduced {name}", st[name], rng, dev, timer))
    rows.append(kernel_case_stage("reduced qkv segs=None layer 1",
                                  replace(st["qkv"], segs=None), rng, dev,
                                  timer, layer=1))
    for batch in (1, 5, 13):  # a ragged last block of columns
        rows.append(kernel_case_stage(f"reduced gu B={batch}", st["gu"], rng,
                                      dev, timer, batch=batch))
    return rows


def main_path_stage_cases(art, plan, dev, timer):
    """K6 at exactly the dimensions the plan serve launches it at: layer 0
    of each of the full-width plan's four stages, B = n_slots; the library
    yardstick is one product with the stage's dense-effective matrix."""
    rng = np.random.default_rng(40)
    rows = []
    for name in ("qkv", "o", "gu", "dn"):
        rows.append(kernel_case_stage(f"full {name}", plan.stages[name], rng,
                                      dev, timer,
                                      w=stage_weights(art, name, 0, dev)))
        torch.cuda.empty_cache()
    return rows


def step_inputs(cfg, plan, rng, dev, *, batch=BATCH, smax=MAX_LEN,
                paged=True, norm=None, window=None):
    """Arguments of one decode step: random hidden states and caches, every
    row at its own position with the slots before it filled, row 1 idle."""
    n_l, d, nkv, hd = cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd
    f32 = dict(dtype=torch.float32, device=dev)
    pos_np = rng.integers(1, smax, batch).astype(np.int32)
    pos_np[1] = -1
    kpos_np = np.where(np.arange(smax)[None, None, :] < pos_np[None, :, None],
                       np.arange(smax)[None, None, :], -1)
    kpos_np = np.ascontiguousarray(np.broadcast_to(kpos_np, (n_l, batch, smax)),
                                   dtype=np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    sin, cos = _rope_sincos(pos, hd, cfg.rope_theta)
    norm = norm or cfg.norm
    args = dict(n_heads=cfg.n_heads, n_kv_heads=nkv, head_dim=hd, d_ff=cfg.d_ff,
                norm=norm, rope=cfg.pos == "rope", x0=torch.randn((d, batch), **f32),
                pos=pos, cos=cos, sin=sin, kpos=torch.from_numpy(kpos_np).to(dev),
                window=window, ln1=None, ln2=None)
    if norm == "rms":
        args["ln1"] = 1.0 + 0.1 * torch.randn((n_l, d), **f32)
        args["ln2"] = 1.0 + 0.1 * torch.randn((n_l, d), **f32)
    if paged:
        bs = 16
        mb = smax // bs
        args["kc"] = torch.randn((n_l, batch * mb + 1, bs, nkv, hd), **f32)
        args["vc"] = torch.randn((n_l, batch * mb + 1, bs, nkv, hd), **f32)
        args["block_tbl"] = torch.from_numpy(
            (1 + rng.permutation(batch * mb)).reshape(batch, mb)
            .astype(np.int32)).to(dev)
    else:
        args["kc"] = torch.randn((n_l, batch, smax, nkv, hd), **f32)
        args["vc"] = torch.randn((n_l, batch, smax, nkv, hd), **f32)
    return args


def kernel_case_step(label, cfg, plan, rng, dev, timer, serve=None, **kw):
    """``step_plan_matmul`` on one decode step, held against its plain
    version: the final hidden state and every layer's new K/V rows.  An MoE
    plan routes every layer's FFN inside the step (K8); the kernel and its
    plain version each count their dropped choices, which must agree."""
    torch.manual_seed(int(rng.integers(1 << 31)))
    args = step_inputs(cfg, plan, rng, dev, **kw)
    n_l, b, smax = cfg.n_layers, args["x0"].shape[1], args["kpos"].shape[2]
    nq, nkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    cap = b
    moe = moe_plain = None
    if plan.moe is not None:
        moe = dict(plan.moe, dropped=torch.zeros(1, dtype=torch.int32, device=dev))
        moe_plain = dict(moe, dropped=torch.zeros(1, dtype=torch.int32, device=dev))
        cap = capacity(b, cfg.moe.top_k, cfg.moe.capacity_factor,
                       cfg.moe.n_experts)
    y, kn, vn = step_plan_matmul(plan.stages, **args, moe=moe)
    torch.cuda.synchronize()
    want = step_plan_matmul_plain(plan.stages, **args, moe=moe_plain)
    err = max(check_close(f"{label} {part}", got, ref, STEP_TOL)
              for part, got, ref in zip(("y", "k_new", "v_new"), (y, kn, vn), want))
    drops = None
    if moe is not None:
        drops = int(moe["dropped"])
        if drops != int(moe_plain["dropped"]):
            fail(f"{label}: {drops} dropped choices in the kernels, "
                 f"{int(moe_plain['dropped'])} in the plain version")
        torch.cuda.empty_cache()
    bytes_ = flops = 0
    for name, ps in plan.stages.items():
        sb, sf = stage_cost(device_stage(ps, dev), range(n_l),
                            cap if name in ("eg", "ed") else b)
        bytes_ += sb
        flops += sf
    if moe is not None:  # K8: router, expert input and output, once a layer
        n_exp = cfg.moe.n_experts
        bytes_ += n_l * 4 * (d * n_exp + 2 * n_exp * d * cap)
        flops += n_l * 2 * d * b * n_exp
    # the KV view and kpos read once, new rows and hidden state in and out
    bytes_ += n_l * b * (2 * smax * nkv * hd * 4 + smax * 4 + 2 * nkv * hd * 4)
    bytes_ += 2 * 4 * d * b
    flops += 4 * n_l * b * nq * smax * hd
    key = (n_l, d, cfg.d_ff, b, smax, nq, nkv, hd)
    return kernel_row(
        "step_plan_matmul", label,
        dict(L=n_l, d=d, d_ff=cfg.d_ff, B=b, S=smax, Hq=nq, Hkv=nkv, hd=hd,
             norm=args["norm"], window=args["window"],
             paged=args.get("block_tbl") is not None,
             moe=moe is not None, cap=cap if moe is not None else None,
             dropped=drops),
        key, err, False, lambda: step_plan_matmul(plan.stages, **args, moe=moe),
        lambda: step_plan_matmul_plain(plan.stages, **args, moe=moe_plain),
        None, bound_of(bytes_, flops), timer, serve=serve)


def phase_kernels(dev, art, plan, red_cfg):
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = reduced_kernel_cases(red_cfg, dev, timer, sm)
    torch.cuda.empty_cache()
    rows += main_path_kernel_cases(art, dev, timer, sm)
    torch.cuda.empty_cache()
    red_art = seeded_artifact(red_cfg, seed=1, device=dev)
    red_plan = CompressedExecutor(red_art, device=dev).step_plan(red_cfg)
    rows += reduced_stage_cases(red_plan, dev, timer)
    rows += main_path_stage_cases(art, plan, dev, timer)
    gqa_cfg = replace(red_cfg, n_kv_heads=2)
    gqa_plan = CompressedExecutor(seeded_artifact(gqa_cfg, seed=3, device=dev),
                                  device=dev).step_plan(gqa_cfg)
    rng = np.random.default_rng(50)
    rows.append(kernel_case_step("reduced GQA contiguous rms window=5", gqa_cfg,
                                 gqa_plan, rng, dev, timer, paged=False,
                                 norm="rms", window=5))
    rows.append(kernel_case_step("reduced GQA paged", gqa_cfg, gqa_plan, rng,
                                 dev, timer))
    rows.append(kernel_case_step("full step", art.config, plan, rng, dev, timer))
    torch.cuda.empty_cache()
    arch = art.config.name
    for row in rows:  # the main-path rows: the serve whose shapes they check
        if row["shape"].startswith("full"):
            row["serve"] = f"{arch} " + ("per-region" if row["name"] in PER_REGION
                                         else "plan")
    return rows


# --------------------------------------------------------- phases 3 and 4


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def prompts_for(cfg, n):
    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    return [lm.sample(1, 8, seed=100 + i)[0, :8].tolist() for i in range(n)]


def serve(art, device, *, use_kernel, n_slots, prompts, max_new):
    eng = ServingEngine(artifact=art, n_slots=n_slots, max_len=MAX_LEN,
                        use_kernel=use_kernel, kv_block=16, device=device)
    sched = Scheduler(eng)
    rids = [sched.enqueue(p, max_new=max_new) for p in prompts]
    step_s = []
    while sched.pending or sched.inflight or eng.active.any():
        t0 = time.perf_counter()
        sched.step()  # ends in the step's device->host copy: host time is right
        step_s.append(time.perf_counter() - t0)
    return eng, [sched.take_result(r) for r in rids], step_s


def phase_reduced_serve(dev, cfg, *, n_slots=4, n_prompts=3):
    """The reduced config on the plan route (kernels), its plain version on
    the CPU and the dense-effective weights: the same greedy tokens, one
    step's logits within 1e-4; for MoE the same dropped choices (some)."""
    art = seeded_artifact(cfg, seed=1, device=dev)
    art_cpu = replace(art, params=to_device(art.params, "cpu"))
    prompts = prompts_for(cfg, n_prompts)
    dispatch.reset_launch_count()
    eng_k, res_k, _ = serve(art, dev, use_kernel=True, n_slots=n_slots,
                            prompts=prompts, max_new=8)
    counts = dispatch.launch_counts()
    eng_p, res_p, _ = serve(art_cpu, "cpu", use_kernel=True, n_slots=n_slots,
                            prompts=prompts, max_new=8)
    _, res_d, _ = serve(art, dev, use_kernel=False, n_slots=n_slots,
                        prompts=prompts, max_new=8)
    for r in res_k + res_p + res_d:
        if r.error or not r.finished:
            fail(f"reduced serve: request failed: {r.error}")
    if not ([r.tokens for r in res_k] == [r.tokens for r in res_p]
            == [r.tokens for r in res_d]):
        fail("reduced serve: greedy tokens differ between kernel, plain and "
             "dense-effective routes")
    drops = None
    if cfg.moe is not None:
        drops = [int(e.executor.moe_dropped) for e in (eng_k, eng_p)]
        if drops[0] != drops[1] or drops[0] <= 0:
            fail(f"reduced serve: dropped choices kernel/plain {drops}: they "
                 "must agree and some must occur")
    # one decode step, logits of the three routes
    tok = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (n_slots, 1))).to(dev)
    pos = torch.zeros(n_slots, dtype=torch.long, device=dev)

    def logits(a, device, executor):
        st = api.init_decode_state(cfg, n_slots, 16, device=device)
        with torch.no_grad():
            lg, _ = api.decode(a.params, cfg, st, tok.to(device), pos.to(device),
                               executor=executor)
        return lg.float().cpu()

    # the reduced config computes in float32: its default route is the plan
    l_k = logits(art, dev, CompressedExecutor(art, device=dev))
    l_r = logits(art, dev, CompressedExecutor(art, use_plans=False, device=dev))
    l_p = logits(art_cpu, "cpu", CompressedExecutor(art_cpu, device="cpu"))
    l_d = logits(art, dev, None)
    errs = dict(kernel_vs_plain=float((l_k - l_p).abs().max()),
                kernel_vs_dense=float((l_k - l_d).abs().max()),
                plan_vs_per_region=float((l_k - l_r).abs().max()))
    if max(errs.values()) > 1e-4 or not bool(torch.isfinite(l_k).all()):
        fail(f"reduced serve: logits disagree: {errs}")
    if eng_k.executor.routed != eng_k.executor.sites:
        fail("reduced serve: not every site was routed through a kernel")
    if eng_k.n_layer_plans != 1:
        fail("reduced serve: the float32 engine did not take the plan route")
    return dict(phase="reduced_serve", arch=cfg.name, logits_max_abs_err=errs,
                tol=1e-4, tokens_equal=True, launches=counts,
                launches_per_step=eng_k.kernel_launches_per_step,
                dropped_kernel_plain=drops)


def profile_steps(eng, prompts, n_steps: int = 4):
    """Where a steady decode step's time goes on a warm engine, three windows
    of ``n_steps`` steps each: the host's wall time with every profiler off;
    torch.profiler (device activity only) for device time and launches by
    kernel name; cProfile for the host functions the step spends its time in
    (its proportions, not its inflated total).  Busy over wall is the share of
    a step the device works; the rest it idles, waiting for the host to
    enqueue."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new=3 * n_steps + 4)
    eng.step()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    host = cProfile.Profile()
    host.enable()
    for _ in range(n_steps):
        eng.step()
    host.disable()
    while eng.active.any():
        eng.step()
    by_name, launched = {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3 / n_steps
            launched += ev.count
    busy = sum(by_name.values())
    if busy <= 0:
        fail("the profiler reported no device time for the decode steps")
    def is_port(name):
        return any(k in name for k in PORT_KERNELS)

    ours = sum(v for k, v in by_name.items() if is_port(k))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    port = {k.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ")[:48]: round(v, 4)
            for k, v in by_name.items() if is_port(k)}
    stats = pstats.Stats(host).stats  # (file, line, fn) -> (cc, nc, tt, ct, _)
    host_total = sum(v[2] for v in stats.values())
    host_top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return dict(wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy,
                device_idle_share=max(0.0, 1.0 - busy / wall_ms),
                port_kernels_ms_per_step=ours,
                port_device_ms_per_step_by_kernel=port,
                device_kernels_per_step=launched / n_steps,
                top_device_ms_per_step={k[:48]: round(v, 4) for k, v in top},
                host_share_by_function={
                    f"{Path(f).name}:{ln}:{fn}"[:60]: round(v[2] / host_total, 4)
                    for (f, ln, fn), v in host_top})


def site_weight(params, name):
    """Site ``name``'s dense-effective ``[K, N]`` weight in ``params``:
    ``attn.q.l0`` -> blocks.attn.q.w[0], ``moe.up.l1.e3`` -> blocks.ffn.up[1, 3]."""
    parts = name.split(".")
    li = int(parts[2][1:])
    if parts[0] == "moe":
        return params["blocks"]["ffn"][parts[1]][li, int(parts[3][1:])]
    return params["blocks"][parts[0]][parts[1]]["w"][li]


def site_groups(cfg):
    """Layer 0's fused regions as the per-region route groups them."""
    if cfg.moe is None:
        return (("attn.q.l0", "attn.k.l0", "attn.v.l0"), ("attn.o.l0",),
                ("ffn.gate.l0", "ffn.up.l0"), ("ffn.down.l0",))
    ne = cfg.moe.n_experts
    return ((("attn.q.l0", "attn.k.l0", "attn.v.l0"), ("attn.o.l0",))
            + tuple(tuple(f"moe.{p}.l0.e{e}" for e in range(ne))
                    for p in ("gate", "up", "down")))


def phase_full_serve(dev, cfg, art, fixture_s, ref_params=None):
    """The per-region route at full width: every projection a K1 or K2
    launch (an MoE projection's experts one K2 launch of E), K3 on the
    weight-shared sites.  ``ref_params``: float32 dense-effective weights
    for the per-site check where the records keep none on the host."""
    n_shared = sum(1 for r in art.records.values() if r.shared is not None)
    per_layer = 4 if cfg.moe is None else 5  # K1/K2 launches a layer
    predicted = per_layer * cfg.n_layers + n_shared
    prompts = prompts_for(cfg, 6)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_count()  # counts of the main path start here ...
    t0 = time.perf_counter()
    eng, res, step_s = serve(art, dev, use_kernel=True, n_slots=BATCH,
                             prompts=prompts, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated()
    for r in res:
        if r.error or not r.finished or len(r.tokens) != r.prompt_len + 16:
            fail(f"full serve: request did not finish cleanly: {r.error}")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            fail("full serve: token outside the vocabulary")
    ex = eng.executor
    if ex.routed != ex.sites:
        fail(f"full serve: unrouted sites {sorted(ex.sites - ex.routed)[:5]}")
    if eng.kernel_launches_per_step != predicted:
        fail(f"full serve: {eng.kernel_launches_per_step} launches per step, "
             f"the site table predicts {predicted}")
    if set(counts) != set(PER_REGION):
        fail(f"full serve: launched {sorted(counts)}, expected exactly the "
             f"per-region kernels {PER_REGION}")
    steps = eng.step_dispatches  # decode steps of the serve
    dropped = int(ex.moe_dropped) if ex.moe_dropped is not None else None
    # per-site float32 output of layer 0 against the dense-effective matrix
    rng = np.random.default_rng(3)
    site_err = {}
    with torch.no_grad():
        for names in site_groups(cfg):
            k_in = site_weight(art.params, names[0]).shape[0]
            x = torch.from_numpy(rng.standard_normal((k_in, BATCH)).astype(np.float32)).to(dev)
            ys = (ex.grouped(names)([x] * len(names)) if len(names) > 1
                  else [ex.matvec(names[0])(x)])
            for nm, y in zip(names, ys):
                rec = art.records[nm]
                if rec.effective is not None:
                    kept = torch.from_numpy(rec.kept_columns).to(dev)
                    ref = torch.from_numpy(np.asarray(rec.effective, np.float32)
                                           ).to(dev) @ x[kept]
                else:
                    ref = site_weight(ref_params, nm).to(dev, torch.float32).T @ x
                site_err[nm] = float((y - ref).abs().max() / ref.abs().max())
    torch.cuda.synchronize()
    if max(site_err.values()) > 1e-3:
        fail(f"full serve: per-site output off the dense-effective: {site_err}")
    profile = profile_steps(eng, prompts)
    tokens = sum(len(r.tokens) - r.prompt_len for r in res)
    steady = step_s[1:] or step_s
    return dict(phase="full_serve", arch=cfg.name, layers=cfg.n_layers,
                d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
                dtype=cfg.compute_dtype,
                n_slots=BATCH, requests=len(prompts), max_new=16,
                fixture_s=fixture_s, tokens=tokens, wall_s=wall,
                # the route packs and uploads its groups at their first use
                # (as the reference builds them): inside the first step
                pack_s=None, upload_s=None,
                tokens_per_s=tokens / wall, steps=len(step_s),
                first_step_ms=step_s[0] * 1e3,
                ms_per_step=float(np.median(steady)) * 1e3,
                steady_tokens_per_s=len(prompts) / float(np.median(steady)),
                profile=profile,
                launches_per_step=eng.kernel_launches_per_step,
                decode_steps=steps,
                predicted_launches_per_step=predicted, launches=counts,
                routed=len(ex.routed), sites=len(ex.sites),
                routed_equals_sites=ex.routed == ex.sites,
                plan_fallbacks=eng.plan_stats()["fallbacks"],
                dropped_per_step=None if dropped is None else dropped / steps,
                site_rel_err_max=max(site_err.values()), site_rel_tol=1e-3,
                peak_device_bytes=peak,
                resident_device_bytes=torch.cuda.memory_allocated(),
                sample_tokens=res[0].tokens[res[0].prompt_len:]), counts, by_shape, eng


def two_step_logits(cfg, art, executor, dev):
    """Two decode steps' logits [2, B, V] float32 from a fresh cache."""
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, BATCH, 1))).to(dev)
    st = api.init_decode_state(cfg, BATCH, MAX_LEN, device=dev)
    out = []
    with torch.no_grad():
        for t in range(2):
            pos = torch.full((BATCH,), t, dtype=torch.long, device=dev)
            lg, st = api.decode(art.params, cfg, st, toks[t], pos,
                                executor=executor)
            out.append(lg.float())
    return torch.stack(out)


def phase_plan_serve(dev, cfg, art, plan, l_reg=None):
    """The whole-step plan route at full width, float32: the same 6 prompts
    x 16 new tokens on 8 slots, paged KV.  A dense layer launches 4 stages
    (K6) and 4 step kernels (K7: 2 norms, attention, SwiGLU); an MoE layer
    the same with its FFN stages eg/ed and K8's route, dispatch and combine.
    ``l_reg``: the per-region route's two-step logits on the same artifact
    (computed here when not given)."""
    moe = cfg.moe is not None
    predicted = (11 if moe else 8) * cfg.n_layers
    expected = set(PLAN) | (set(MOE) if moe else set())
    prompts = prompts_for(cfg, 6)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what the card holds before the serve: the artifact's parameters and
    # the plan's uploaded stages (the per-region copies were freed)
    resident = torch.cuda.memory_allocated()
    param_bytes = sum(tensor_bytes(t) for t in leaves(art.params))
    stage_bytes = sum(tensor_bytes(*vars(device_stage(ps, dev)).values())
                      for ps in plan.stages.values())
    dispatch.reset_launch_count()  # counts of the plan path start here ...
    t0 = time.perf_counter()
    eng, res, step_s = serve(art, dev, use_kernel=True, n_slots=BATCH,
                             prompts=prompts, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated()
    for r in res:
        if r.error or not r.finished or len(r.tokens) != r.prompt_len + 16:
            fail(f"plan serve: request did not finish cleanly: {r.error}")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            fail("plan serve: token outside the vocabulary")
    ex = eng.executor
    if ex.routed != ex.sites:
        fail(f"plan serve: unrouted sites {sorted(ex.sites - ex.routed)[:5]}")
    if eng.n_layer_plans != 1 or ex.plan_fallbacks:
        fail(f"plan serve: {eng.n_layer_plans} plans, fallbacks "
             f"{ex.plan_fallbacks}")
    if eng.kernel_launches_per_step != predicted:
        fail(f"plan serve: {eng.kernel_launches_per_step} launches per step, "
             f"the plan predicts {predicted}")
    if set(counts) != expected:
        fail(f"plan serve: launched {sorted(counts)}, expected exactly the "
             f"plan's kernels {sorted(expected)}")
    steps = eng.step_dispatches  # decode steps of the serve
    dropped = int(ex.moe_dropped) if ex.moe_dropped is not None else None
    # two decode steps' logits: plan route against the per-region route
    # (K1-K3) and the dense-effective weights, on the same float32 artifact
    l_plan = two_step_logits(cfg, art, ex, dev)
    if l_reg is None:
        l_reg = two_step_logits(
            cfg, art, CompressedExecutor(art, use_plans=False, device=dev), dev)
    torch.cuda.empty_cache()
    l_dense = two_step_logits(cfg, art, None, dev)
    scale = max(1.0, float(l_reg.abs().max()))
    route = dict(plan_vs_per_region=float((l_plan - l_reg).abs().max()) / scale,
                 plan_vs_dense=float((l_plan - l_dense).abs().max()) / scale)
    if not max(route.values()) <= ROUTE_TOL or not bool(torch.isfinite(l_plan).all()):
        fail(f"plan serve: logits off the other routes: {route}")
    profile = profile_steps(eng, prompts)
    tokens = sum(len(r.tokens) - r.prompt_len for r in res)
    steady = step_s[1:] or step_s
    return dict(phase="plan_serve", arch=cfg.name, dtype=cfg.compute_dtype,
                layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
                vocab=cfg.vocab, n_slots=BATCH, requests=len(prompts),
                max_new=16, pack_s=plan.pack_s, tokens=tokens, wall_s=wall,
                tokens_per_s=tokens / wall, steps=len(step_s),
                first_step_ms=step_s[0] * 1e3,
                ms_per_step=float(np.median(steady)) * 1e3,
                steady_tokens_per_s=len(prompts) / float(np.median(steady)),
                profile=profile, launches_per_step=eng.kernel_launches_per_step,
                predicted_launches_per_step=predicted, decode_steps=steps,
                launches=counts, routed=len(ex.routed), sites=len(ex.sites),
                routed_equals_sites=ex.routed == ex.sites,
                n_layer_plans=eng.n_layer_plans, plan_fallbacks=ex.plan_fallbacks,
                dropped_per_step=None if dropped is None else dropped / steps,
                logits_rel_err=route, route_tol=ROUTE_TOL,
                peak_device_bytes=peak, resident_before_serve_bytes=resident,
                resident_device_bytes=torch.cuda.memory_allocated(),
                param_bytes=param_bytes, plan_stage_bytes=stage_bytes,
                sample_tokens=res[0].tokens[res[0].prompt_len:]), counts, by_shape


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def tensor_bytes(*objs) -> int:
    return sum(t.numel() * t.element_size() for t in objs
               if isinstance(t, torch.Tensor))


def drop_per_region_copies(art) -> None:
    """Free the per-region route's device copies (K1-K3 streams and FS
    blocks) that the kernel phase and the bf16 serve cached on the
    artifact's packed sites."""
    for pk in art.packed.values():
        pk._dev.clear()
    gc.collect()
    torch.cuda.empty_cache()


def cast(tree, dtype):
    """The parameters in ``dtype``; an MoE router stays float32, as in the
    reference and ``convert.params_from_numpy``."""
    if isinstance(tree, dict):
        return {k: v if k == "router" else cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def kernel_rows(rows, serves):
    """The main-path rows of the kernels line: each row checked at a serve's
    own shapes, with the launches that serve made at exactly the row's
    dimensions.  ``serves`` maps a serve's name to its ``(counts, by_shape,
    decode steps)``; every launch of a serve must be at dimensions a row
    checked."""
    kernels = []
    for row in rows:
        if row.get("serve") is None:
            continue
        counts, by_shape, steps = serves[row["serve"]]
        n = by_shape.get((row["name"], tuple(row["shape_key"])), 0)
        if n <= 0:
            fail(f"{row['name']} {row['shape']}: the {row['serve']} serve never "
                 f"launched at the checked dimensions {row['dims']}")
        kernels.append({**KERNELS[row["name"]], **row, "launches": n,
                        "launches_per_step": n / steps})
    for serve_name, (counts, by_shape, _) in serves.items():
        for name, total in counts.items():
            seen = sum(r["launches"] for r in kernels if r["name"] == name
                       and r["serve"] == serve_name)
            if seen != total:
                shapes = sorted(k for (nm, k) in by_shape if nm == name)
                fail(f"{name}: {total} launches on the {serve_name} serve, "
                     f"{seen} of them at dimensions the kernel phase checked; "
                     f"launched at {shapes}")
    return kernels


def host_peak_rss_bytes() -> int:
    """The process's peak resident host memory (ru_maxrss is in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# ------------------------------------------------- mixtral-8x22b (MoE, K8)


def kernel_case_moe(label, cfg, router, dev, timer, *, batch=BATCH, idle=0,
                    serve=None):
    """K8's own kernels on one layer's router at ``batch`` columns: route
    (held to the plain version's experts, slots, source tokens and dropped
    count exactly, weights within SUM_TOL), dispatch (exact: a gather of
    the same values the plain version scatter-adds into zeros) and combine.
    The last ``idle`` columns are equal, as idle slots are; they route
    alike and take capacity.  No single PyTorch call computes any of the
    three (top-k with capacity ranks; the e-major scatter; the gated
    gather-sum), so there is no library time."""
    d, n_exp, k = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    cap = capacity(batch, k, cfg.moe.capacity_factor, n_exp)
    kw = dict(top_k=k, cap=cap, norm_topk=cfg.moe.norm_topk)
    h2 = torch.randn((d, batch), device=dev)
    if idle:
        h2[:, batch - idle:] = h2[:, batch - idle: batch - idle + 1]
    i32 = dict(dtype=torch.int32, device=dev)
    dk, dp = torch.zeros(1, **i32), torch.zeros(1, **i32)
    got = moe_route(h2, router, dropped=dk, **kw)
    torch.cuda.synchronize()
    want = moe_route_plain(h2, router, dropped=dp, **kw)
    for part, a, b in zip(("experts", "slots", "source tokens"),
                          (got[0], got[2], got[3]), (want[0], want[2], want[3])):
        if not torch.equal(a, b):
            fail(f"{label} moe_route: {part} differ from the plain version")
    if int(dk) != int(dp):
        fail(f"{label} moe_route: {int(dk)} dropped, plain {int(dp)}")
    err = check_close(f"{label} moe_route weights", got[1], want[1], SUM_TOL)
    top = torch.sort(torch.softmax(h2.T @ router, -1), -1, descending=True).values
    margin = float((top[:, k - 1] - top[:, k]).min()) if k < n_exp else None
    sel, wgt, slot, src_tok = got
    dims = dict(d=d, B=batch, E=n_exp, k=k, cap=cap)
    rows = [kernel_row(
        "moe_route", label, dict(dims, dropped=int(dk), min_topk_margin=margin),
        (d, batch, n_exp, k, cap), err, True,
        lambda: moe_route(h2, router, **kw),
        lambda: moe_route_plain(h2, router, **kw), None,
        bound_of(4 * (d * batch + d * n_exp + 3 * batch * k + n_exp * cap),
                 2 * d * batch * n_exp), timer, serve=serve)]
    src = moe_dispatch(h2, slot, src_tok, n_exp, cap)
    torch.cuda.synchronize()
    if not torch.equal(src, moe_dispatch_plain(h2, slot, src_tok, n_exp, cap)):
        fail(f"{label} moe_dispatch: differs from the plain version")
    rows.append(kernel_row(
        "moe_dispatch", label, dims, (d, batch, n_exp, cap), 0.0, True,
        lambda: moe_dispatch(h2, slot, src_tok, n_exp, cap),
        lambda: moe_dispatch_plain(h2, slot, src_tok, n_exp, cap), None,
        bound_of(4 * (d * batch + n_exp * cap + n_exp * d * cap), 0), timer,
        serve=serve))
    x = torch.randn((d, batch), device=dev)
    ob = torch.randn((n_exp * d, cap), device=dev)
    out = moe_combine(x, ob, slot, wgt, n_exp, cap)
    torch.cuda.synchronize()
    ref = moe_combine_plain(x, ob, slot, wgt, n_exp, cap)
    err = check_close(f"{label} moe_combine", out, ref, SUM_TOL)
    rows.append(kernel_row(
        "moe_combine", label, dims, (d, batch, n_exp, k, cap), err,
        bool(torch.equal(out, ref)),
        lambda: moe_combine(x, ob, slot, wgt, n_exp, cap),
        lambda: moe_combine_plain(x, ob, slot, wgt, n_exp, cap), None,
        bound_of(4 * (2 * d * batch + n_exp * d * cap + 2 * batch * k),
                 2 * d * batch * k), timer, serve=serve))
    return rows


def reduced_moe_cases(cfg, dev, timer):
    """K8 and the MoE step at reduced widths: capacity drops, idle columns,
    another expert count, top-k and a ragged batch, contiguous and paged
    caches, a window."""
    torch.manual_seed(80)
    rows = []
    for c, batch, idle in ((cfg, 8, 2), (replace(cfg, moe=replace(
            cfg.moe, n_experts=5, top_k=3)), 13, 0)):
        router = torch.randn((c.d_model, c.moe.n_experts), device=dev) \
            * c.d_model ** -0.5
        rows += kernel_case_moe(f"reduced E={c.moe.n_experts} k={c.moe.top_k}",
                                c, router, dev, timer, batch=batch, idle=idle)
    plan = CompressedExecutor(seeded_artifact(cfg, seed=3, device=dev),
                              device=dev).step_plan(cfg)
    rng = np.random.default_rng(81)
    rows.append(kernel_case_step("reduced mixtral paged", cfg, plan, rng, dev,
                                 timer))
    rows.append(kernel_case_step("reduced mixtral contiguous window=5", cfg,
                                 plan, rng, dev, timer, paged=False, window=5))
    return rows


def mixtral_region_cases(art, dev, timer, sm, serve):
    """The per-region kernels at the mixtral serve's own dimensions: layer
    0's attention sites (K1 on o, K2 on q+k+v at B = n_slots), each
    projection's experts as one K2 launch of E at B = capacity, and K3 on
    the weight-shared sites (attention at B = n_slots, experts at B =
    capacity)."""
    cfg = art.config
    ne = cfg.moe.n_experts
    cap = capacity(BATCH, cfg.moe.top_k, cfg.moe.capacity_factor, ne)
    rng = np.random.default_rng(60)
    pk = art.packed
    rows = [kernel_case_chain("mixtral attn.o", pk["attn.o.l0"], rng, dev,
                              timer, sm),
            kernel_case_group("mixtral attn.qkv",
                              [pk[f"attn.{p}.l0"] for p in "qkv"], rng, dev,
                              timer, sm)]
    for proj in ("gate", "up", "down"):
        rows.append(kernel_case_group(
            f"mixtral moe.{proj} G={ne}",
            [pk[f"moe.{proj}.l0.e{e}"] for e in range(ne)], rng, dev, timer,
            sm, batch=cap))
        gc.collect()
        torch.cuda.empty_cache()
    for prefix, batch in (("attn.", BATCH), ("moe.", cap)):
        by_dims = {}
        for name, rec in art.records.items():
            if (name.startswith(prefix) and ".l0" in name
                    and rec.shared is not None):
                labels = np.asarray(rec.shared.labels)
                by_dims.setdefault((labels.size, rec.shared.n_clusters),
                                   {})[name] = labels
        if not by_dims:
            fail(f"the mixtral fixture has no weight-shared {prefix} site")
        for (k, c), sites in sorted(by_dims.items()):
            rows.append(kernel_case_segsum(f"mixtral K={k} C={c} B={batch}",
                                           sites, c, rng, dev, timer,
                                           batch=batch))
    for row in rows:
        row["serve"] = serve
    return rows


def kernel_case_expert_stage(label, name, art, ps, dev, timer, *, batch,
                             serve):
    """K6 on layer 0 of an expert super-stage (``eg``: every expert's gate
    and up, e-major; ``ed``: every down) at B = capacity.  The library
    yardstick is one ``torch.bmm`` over the E experts' dense-effective
    float32 weights; the plain version (tens of GB of gathers at this
    width) is timed apart from it."""
    cfg = art.config
    ne, dff, d = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    ds = device_stage(ps, dev)
    src = dyadic(np.random.default_rng(71), (ps.d_src, batch), dev)
    y = stage_matmul(ps, src, layer=0)
    torch.cuda.synchronize()
    plain = stage_matmul_plain(ps, src, layer=0)
    err = check_close(label, y, plain, SUM_TOL)
    del plain
    torch.cuda.empty_cache()
    ms = timer(lambda: stage_matmul(ps, src, layer=0))
    warm = timer(lambda: stage_matmul(ps, src, layer=0), cold=False)
    plain_ms = timer(lambda: stage_matmul_plain(ps, src, layer=0))
    torch.cuda.empty_cache()
    ffn = art.params["blocks"]["ffn"]
    if name == "eg":  # [E, 2 dff, d] @ [E, d, C]: gates then ups per expert
        w = torch.cat([ffn["gate"][0], ffn["up"][0]], dim=2).transpose(1, 2)
        x3 = src.reshape(ne, d, batch)

        def unpack(o):
            return torch.cat([o[:, :dff].reshape(ne * dff, batch),
                              o[:, dff:].reshape(ne * dff, batch)])
    else:  # [E, d, dff] @ [E, dff, C]
        w = ffn["down"][0].transpose(1, 2)
        x3 = src.reshape(ne, dff, batch)

        def unpack(o):
            return o.reshape(ne * d, batch)
    check_close(label + " vs dense", y, unpack(torch.bmm(w, x3)), 1e-4)
    library_ms = timer(lambda: torch.bmm(w, x3))
    del w
    torch.cuda.empty_cache()
    emit(dict(phase="kernel_case", name="stage_matmul", shape=label, ms=ms,
              max_abs_err=err))
    dd = ds.dims
    bb, threads = ds.geometry(batch)
    return dict(name="stage_matmul", shape=label,
                dims=dict(P=dd["P"], R=dd["R"], S=dd["S"], K=dd["K"],
                          D=dd["D"], O=dd["O"], J=dd["J"], B=batch,
                          blocks=int((ds.blk_r1[0] > ds.blk_r0[0]).sum()),
                          max_rows=ds.max_rows, bb=bb, threads=threads),
                shape_key=list(ds.shape_key(batch, 1)), max_abs_err=err,
                max_err=err, exact_in_kernel_order=False, ms=ms, kernel_ms=ms,
                live_terms=ds.live_terms[0], segs=ps.segs is not None,
                warm_l2_ms=warm, plain_ms=plain_ms,
                bound_ms=bound_of(*stage_cost(ds, [0], batch))[0],
                bound_by=bound_of(*stage_cost(ds, [0], batch))[1],
                library_ms=library_ms, serve=serve)


def mixtral_plan_cases(art, plan, dev, timer, serve):
    """K6, K7 and K8 at the mixtral plan serve's own dimensions: layer 0 of
    the attention stages (B = n_slots) and of the expert super-stages (B =
    capacity), the route/dispatch/combine on layer 0's router (two idle
    columns, as the serve has), and one full-width step."""
    cfg = art.config
    cap = capacity(BATCH, cfg.moe.top_k, cfg.moe.capacity_factor,
                   cfg.moe.n_experts)
    rng = np.random.default_rng(70)
    rows = []
    for name in ("qkv", "o"):
        rows.append(kernel_case_stage(f"mixtral {name}", plan.stages[name],
                                      rng, dev, timer,
                                      w=stage_weights(art, name, 0, dev)))
        torch.cuda.empty_cache()
    for name in ("eg", "ed"):
        rows.append(kernel_case_expert_stage(f"mixtral {name}", name, art,
                                             plan.stages[name], dev, timer,
                                             batch=cap, serve=serve))
        gc.collect()
        torch.cuda.empty_cache()
    torch.manual_seed(72)
    rows += kernel_case_moe("mixtral", cfg, plan.moe["router"][0], dev, timer,
                            idle=2)
    rows.append(kernel_case_step("mixtral full step", cfg, plan, rng, dev,
                                 timer, window=cfg.attn_window))
    torch.cuda.empty_cache()
    for row in rows:
        row["serve"] = serve
    return rows


def run_mixtral(dev):
    """mixtral-8x22b at full width, cut to 2 layers: K8 and the reduced
    serve, the fixture, the per-region kernels and serve (bf16), the plan
    (packed and uploaded), its kernels and the float32 plan serve.  Returns
    the kernel rows and the serves' launch counts."""
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    red = reduced_config(get_arch("mixtral-8x22b"), vocab=256)
    # capacity 4 for 8 slots x 2 choices over 4 experts: drops occur
    red = replace(red, moe=replace(red.moe, capacity_factor=0.5))
    rows = reduced_moe_cases(red, dev, timer)
    emit(dict(phase="kernels", arch="mixtral-8x22b reduced",
              rows=[r for r in rows]))
    emit(phase_reduced_serve(dev, red, n_slots=8, n_prompts=8))
    torch.cuda.empty_cache()

    base = replace(get_arch("mixtral-8x22b"), n_layers=MIXTRAL_LAYERS)
    cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    art32 = seeded_artifact(cfg32, seed=2, device=dev, host_effective=False)
    torch.cuda.synchronize()
    fixture_s = time.perf_counter() - t0
    emit(dict(phase="fixture", arch=base.name, layers=base.n_layers,
              fixture_s=fixture_s, sites=len(art32.records),
              param_bytes=sum(tensor_bytes(t) for t in leaves(art32.params)),
              packed_host_bytes=sum(pk.idx.nbytes + pk.exp.nbytes + pk.sign.nbytes
                                    for pk in art32.packed.values()),
              host_peak_rss_bytes=host_peak_rss_bytes()))

    # per-region route: bf16, a cast of the same parameters
    region = f"{base.name} per-region"
    art16 = replace(art32, config=base, params=cast(art32.params, torch.bfloat16),
                    plans={})
    rows += mixtral_region_cases(art16, dev, timer, sm, region)
    full, counts, by_shape, eng = phase_full_serve(dev, base, art16, fixture_s,
                                                   ref_params=art32.params)
    full["host_peak_rss_bytes"] = host_peak_rss_bytes()
    emit(full)
    # the float32 per-region logits on the same artifact, through the groups
    # the serve uploaded
    ex32 = CompressedExecutor(art32, use_plans=False, device=dev)
    ex32._groups = eng.executor._groups
    l_reg = two_step_logits(cfg32, art32, ex32, dev)
    serves = {region: (counts, by_shape, full["decode_steps"])}
    del eng, ex32, art16
    drop_per_region_copies(art32)

    # plan route: float32
    plan = CompressedExecutor(art32, device=dev).step_plan(cfg32)
    t0 = time.perf_counter()
    for ps in plan.stages.values():
        device_stage(ps, dev)  # validation, block tables, upload
    torch.cuda.synchronize()
    emit(dict(phase="fixture_and_plan", arch=base.name, pack_s=plan.pack_s,
              upload_s=time.perf_counter() - t0,
              host_peak_rss_bytes=host_peak_rss_bytes(),
              stages={name: dict(shape=list(ps.gidx.shape),
                                 outg=list(ps.outg.shape), k_alloc=ps.k_alloc,
                                 blocks=int(device_stage(ps, dev).blk_r0.shape[1]),
                                 max_rows=device_stage(ps, dev).max_rows,
                                 live_terms=sum(device_stage(ps, dev).live_terms),
                                 stream_bytes=6 * ps.gidx.size,
                                 waste=ps.waste)
                      for name, ps in plan.stages.items()}))
    psv = f"{base.name} plan"
    rows += mixtral_plan_cases(art32, plan, dev, timer, psv)
    planned, pcounts, pshape = phase_plan_serve(dev, cfg32, art32, plan,
                                                l_reg=l_reg)
    planned["host_peak_rss_bytes"] = host_peak_rss_bytes()
    emit(planned)
    serves[psv] = (pcounts, pshape, planned["decode_steps"])
    return rows, serves


def run_olmo(dev, layers):
    """olmo-1b at full width: the kernel phase, the reduced serve, the bf16
    per-region serve and the float32 plan serve.  Returns the kernel rows
    and the serves' launch counts."""
    base = get_arch("olmo-1b")
    if layers is not None:
        base = replace(base, n_layers=layers)
    # the plan needs a float32 compute dtype; the per-region serve keeps
    # olmo-1b's own bf16 and takes a cast of the same parameters
    cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
    red_cfg = reduced_config(get_arch("olmo-1b"), vocab=256)

    # the full-width artifact and its plan come first: the kernel phase takes
    # its main-path cases from them
    t0 = time.perf_counter()
    art32 = seeded_artifact(cfg32, seed=2, device=dev)
    torch.cuda.synchronize()
    fixture_s = time.perf_counter() - t0
    art16 = replace(art32, config=base, params=cast(art32.params, torch.bfloat16),
                    plans={})
    plan = CompressedExecutor(art32, device=dev).step_plan(cfg32)
    t0 = time.perf_counter()
    for ps in plan.stages.values():
        device_stage(ps, dev)  # validation, block tables, upload
    torch.cuda.synchronize()
    emit(dict(phase="fixture_and_plan", arch=base.name, fixture_s=fixture_s,
              pack_s=plan.pack_s, upload_s=time.perf_counter() - t0,
              stages={name: dict(shape=list(ps.gidx.shape),
                                 outg=list(ps.outg.shape), k_alloc=ps.k_alloc,
                                 blocks=int(device_stage(ps, dev).blk_r0.shape[1]),
                                 max_rows=device_stage(ps, dev).max_rows,
                                 live_terms=sum(device_stage(ps, dev).live_terms),
                                 stream_bytes=6 * ps.gidx.size,
                                 waste=ps.waste)
                      for name, ps in plan.stages.items()}))

    rows = phase_kernels(dev, art32, plan, red_cfg)
    emit(dict(phase="kernels", arch=base.name, tolerance=SUM_TOL,
              tolerance_reason="float32 sums in another order than the "
                               "plain version's (over E slices, J gathers, "
                               "S terms); where every sum is exact the "
                               "results are bit-identical",
              step_tolerance=STEP_TOL, rows=rows))
    emit(phase_reduced_serve(dev, red_cfg))
    full, full_counts, by_shape, eng = phase_full_serve(dev, base, art16,
                                                        fixture_s)
    emit(full)
    # the plan serve's peak counts the plan route's own bytes: the bf16 cast
    # and the per-region streams go first
    del eng, art16
    drop_per_region_copies(art32)
    planned, plan_counts, plan_shape = phase_plan_serve(dev, cfg32, art32, plan)
    emit(planned)
    return rows, {f"{base.name} per-region": (full_counts, by_shape,
                                              full["decode_steps"]),
                  f"{base.name} plan": (plan_counts, plan_shape,
                                        planned["decode_steps"])}


# ---------------------------------------------- training (K5, group_prox)

# K5 |kernel - plain| <= PROX_TOL * max(1, max|plain|) in float32: the row's
# sum of squares in another order; bf16: one bf16 ulp of the plain version's
# value (the same float32 product rounded once on either side) plus
# PROX_TOL * |a|: the two float32 scales differ by up to ~1e-6, which near
# the threshold (scale ~1e-4 and below) is more than an ulp of the output
PROX_TOL = 1e-6
PROX_MARGIN = 1e-5  # killed rows must agree where |norm - t| / t > this
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_LR, TRAIN_LAM = 3e-3, 0.1  # the launcher's defaults
TRAIN_STEPS = 5  # timed, after one warm step


def bf16_ulp(w: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``w`` (8 significant bits)."""
    _, e = torch.frexp(w.float().abs())
    return torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8)


def check_prox(label, got, want, a, t):
    """K5's result against a reference of the same prox: the tolerance of
    its dtype, and the same killed rows wherever the row's norm is not within
    PROX_MARGIN of the threshold.  Returns (max_abs_err, smallest margin)."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if got.dtype == torch.float32:
        check_close(label, got, want, PROX_TOL)
    else:
        over = diff - bf16_ulp(want) - PROX_TOL * a.float().abs()
        if bool((over > 0).any()):
            i = int(torch.argmax(over))
            r, c = divmod(i, a.shape[1])
            nr = float(torch.linalg.vector_norm(a[r], dtype=torch.float32))
            fail(f"{label}: beyond one bf16 ulp + {PROX_TOL}*|a| of the plain "
                 f"version at [{r}, {c}]: a {float(a[r, c])}, got "
                 f"{float(got[r, c])}, want {float(want[r, c])}, row norm "
                 f"{nr}, t {t} (max_abs_err {err:.3e})")
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite output")
    norms = torch.linalg.vector_norm(a, dim=1, dtype=torch.float32)
    margin = ((norms - t).abs() / t if t > 0
              else torch.full_like(norms, float("inf")))
    away = margin > PROX_MARGIN
    differ = ((got == 0).all(1) != (want == 0).all(1)) & away
    if bool(differ.any()):
        fail(f"{label}: {int(differ.sum())} rows killed on one side only")
    ulp = {}
    if got.dtype != torch.float32:  # where one ulp alone is not enough
        rows = (diff > bf16_ulp(want)).any(1)
        ulp = dict(rows_beyond_one_ulp=int(rows.sum()),
                   their_largest_margin=float(margin[rows].max())
                   if bool(rows.any()) else None)
    return err, float(margin.min()), ulp


def prox_input(rng, g, m, dtype, dev):
    """Rows of unequal norm (scaled by 0.5-1.5) with every 97th row zero,
    and a threshold that kills about half of them."""
    a = rng.standard_normal((g, m), dtype=np.float32)
    a *= rng.uniform(0.5, 1.5, (g, 1)).astype(np.float32)
    a[::97] = 0.0
    t = torch.from_numpy(a).to(dev, dtype)
    return t, mid_threshold(torch.linalg.vector_norm(t, dim=1, dtype=torch.float32))


def mid_threshold(norms: torch.Tensor) -> float:
    """Halfway between the two middle group norms: about half the groups
    die, and no group sits exactly on the threshold."""
    s = torch.sort(norms).values
    return float(s[(len(s) - 1) // 2] + s[len(s) // 2]) / 2


def kernel_case_prox(label, a, t, dev, timer, serve=None):
    """K5 on ``a`` at threshold ``t``: against the plain version and the
    oracle, bitwise from run to run and in place == out of place; timed
    (bound: the view read and written once, three operations a weight)."""
    g, m = a.shape
    got = group_prox(a, t)
    want = group_prox_plain(a, t)
    err, margin, ulp = check_prox(f"group_prox {label}", got, want, a, t)
    check_prox(f"group_prox {label} (oracle)", got, group_prox_ref(a, t), a, t)
    if not torch.equal(group_prox(a, t), got):
        fail(f"group_prox {label}: two runs differ")
    inplace = a.clone()
    group_prox(inplace, t, out=inplace)
    if not torch.equal(inplace, got):
        fail(f"group_prox {label}: in place differs from out of place")
    torch.cuda.synchronize()
    out = torch.empty_like(a)
    killed = int((got == 0).all(1).sum())
    return kernel_row("group_prox", label, [g, m], (g, m), err, None,
                      lambda: group_prox(a, t, out=out),
                      lambda: group_prox_plain(a, t), None,
                      bound_of(2 * a.numel() * a.element_size(), 3 * a.numel()),
                      timer, serve=serve, dtype=str(a.dtype).split(".")[-1],
                      killed_rows=killed, smallest_margin=margin, **ulp,
                      library_note="none: no single PyTorch call computes "
                                   "the prox")


def olmo_prox_views(cfg):
    """The [G, M] views of olmo-1b's seven regularized leaves (all in_rows:
    the leaf [L, K, N] viewed as [L*K, N]), grouped by shape."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    return {"attn.q/k/v/o": (L * d, cfg.n_heads * cfg.hd),
            "ffn.gate/up": (L * d, f), "ffn.down": (L * f, d)}


def phase_train_kernels(dev, cfg):
    """K5 on the reference's hard cases, rows of every width up to 16384 in
    float32 and bf16, then the main paths' own views: olmo-1b's (bf16) and
    the MLP's (float32, transposed copies of fc1 [300, 784] and fc2)."""
    timer = Timer(dev)
    rng = np.random.default_rng(60)
    rows = []
    hard = np.random.default_rng(5).standard_normal((37, 16)).astype(np.float32)
    hard[[3, 17, 36]] = 0.0
    for r, n in ((5, 2.0), (9, 1.995), (11, 2.005)):  # at, under, over t = 2
        hard[r] *= n / np.linalg.norm(hard[r])
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        rows.append(kernel_case_prox(f"hard 37x16 {name} t=2",
                                     torch.from_numpy(hard).to(dev, dt), 2.0,
                                     dev, timer))
        for m in (10, 33, 300, 2047, 2048, 8192, 16384):
            a, t = prox_input(rng, 1003, m, dt, dev)
            rows.append(kernel_case_prox(f"1003x{m} {name}", a, t, dev, timer))
        a, _ = prox_input(rng, 1003, 300, dt, dev)
        rows.append(kernel_case_prox(f"1003x300 {name} t=0", a, 0.0, dev, timer))
    torch.cuda.empty_cache()
    for leaves, (g, m) in olmo_prox_views(cfg).items():
        a, t = prox_input(rng, g, m, torch.bfloat16, dev)
        rows.append(kernel_case_prox(f"full olmo {leaves} [{g}, {m}] bf16", a, t,
                                     dev, timer, serve=f"{cfg.name} train"))
        del a
        torch.cuda.empty_cache()
    for leaf, (g, m) in (("fc1", (784, 300)), ("fc2", (300, 10))):
        a, t = prox_input(rng, g, m, torch.float32, dev)
        rows.append(kernel_case_prox(f"full mlp {leaf} [{g}, {m}] float32", a, t,
                                     dev, timer, serve="mlp train"))
    return rows


# device kernels by class, for where a train step's time goes (name fragments)
KERNEL_CLASSES = (("group_prox (K5)", ("group_prox_kernel",)),
                  ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
                  ("softmax", ("softmax",)),
                  ("reduction", ("reduce_kernel",)),
                  ("index / scatter / gather", ("index", "scatter", "gather",
                                                "embedding")),
                  ("elementwise", ("elementwise",)),
                  ("copy / fill", ("copy", "Memcpy", "Memset", "fill")))


def profile_train_step(cfg, opt, specs, state, batch):
    """Where one steady train step's time goes: CUDA events around the
    optimizer's update (the rest of the step is forward + backward + clip
    before it and the sparsity report after it) in one step, then
    torch.profiler's device time by kernel name and class in the next; K5's
    share, and the device's idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.training.trainer import make_train_step

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def timed_update(*a):
        ev[1].record()
        out = opt.update(*a)
        ev[2].record()
        return out

    step_fn = make_train_step(cfg, Optimizer(opt.init, timed_update),
                              lr=TRAIN_LR, prox_specs=specs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    state, _ = step_fn(state, batch)
    ev[3].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events_ms = dict(forward_backward_clip=ev[0].elapsed_time(ev[1]),
                     optimizer_update=ev[1].elapsed_time(ev[2]),
                     sparsity_report=ev[2].elapsed_time(ev[3]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    by_name, launched = {}, 0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + dev_us / 1e3
            launched += e.count
    busy = sum(by_name.values())
    if busy <= 0:
        fail("the profiler reported no device time for the train step")
    by_class = {}
    for name, ms in by_name.items():
        cls = next((c for c, frags in KERNEL_CLASSES
                    if any(f in name for f in frags)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    k5 = by_class.get("group_prox (K5)", 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return state, dict(
        wall_ms=wall_ms, device_busy_ms=busy,
        device_idle_share=max(0.0, 1.0 - busy / wall_ms),
        events_ms=events_ms,
        device_kernels=launched, group_prox_device_ms=k5,
        group_prox_share_of_busy=k5 / busy,
        device_ms_by_class={k: round(v, 4) for k, v in
                            sorted(by_class.items(), key=lambda kv: -kv[1])},
        top_device_ms={k.removeprefix("void ")[:110]: round(v, 4)
                       for k, v in top})


def check_update_routes(state, specs, step_batch, cfg, dev):
    """One ProxSGD update on the same parameters, gradients and momentum
    through K5 (``use_kernel=True``) and through the XLA-equivalent route
    (``use_kernel=False``: ``group_prox_rows`` in bf16, as the reference's):
    parameters within one bf16 ulp and the same dead groups.  Then the same
    pre-prox parameters at a threshold that kills about half of each
    leaf's groups, K5 against its float32 plain version."""
    from repro_torch.optim.optimizers import (apply_spec_prox, clip_by_global_norm,
                                              sgd, spec_group_norms, tree_get,
                                              tree_leaves, tree_map)

    params = state.params
    leaves = tree_leaves(params)
    loss = api.train_loss(params, cfg, step_batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    grads, _ = clip_by_global_norm(tree_map(lambda _: next(it), params), 1.0)
    with torch.no_grad():
        pre = tree_map(lambda p: p.detach().clone(), params)
        mu = tree_map(lambda m: m.clone(), state.opt_state["mu"])
        sgd(0.9).update(grads, {"mu": mu}, pre, TRAIN_LR)  # prox_sgd's first half
        del mu, grads
        out = dict(launches=0)
        for tag, thresh in (("run", lambda n: TRAIN_LR * TRAIN_LAM),
                            ("median", mid_threshold)):
            worst, dead_k, dead_x, margin = 0.0, 0, 0, float("inf")
            for gs in specs:
                leaf = tree_get(pre, gs.path)
                norms = spec_group_norms(leaf, gs.kind)
                t = thresh(norms)
                n0 = dispatch.launch_count("group_prox")
                k = apply_spec_prox(leaf.clone(), gs.kind, t, use_kernel=True)
                out["launches"] += dispatch.launch_count("group_prox") - n0
                if tag == "run":
                    x = apply_spec_prox(leaf.clone(), gs.kind, t, use_kernel=False)
                else:  # the bf16 XLA route rounds the scale itself: plain f32
                    x = group_prox_plain(leaf.reshape(-1, leaf.shape[-1]), t
                                         ).reshape(leaf.shape)
                k2, x2 = k.reshape(-1, k.shape[-1]), x.reshape(-1, x.shape[-1])
                err, m, _ = check_prox(f"train update {gs.name} ({tag})", k2,
                                       x2, leaf.reshape(-1, leaf.shape[-1]), t)
                worst, margin = max(worst, err), min(margin, m)
                dead_k += int((spec_group_norms(k, gs.kind) == 0).sum())
                dead_x += int((spec_group_norms(x, gs.kind) == 0).sum())
                del k, x, k2, x2
            if margin > PROX_MARGIN and dead_k != dead_x:  # else: row by row
                fail(f"train update ({tag}): {dead_k} dead groups through K5, "
                     f"{dead_x} through the other route")
            out[tag] = dict(max_abs_err=worst, dead_groups=dead_k,
                            smallest_margin=margin)
    del pre
    torch.cuda.empty_cache()
    return out


def phase_train_olmo(dev):
    """olmo-1b at full width (configs/olmo_1b.py unchanged: bf16 parameters
    and compute, remat on) trained by the port's ``make_train_step`` with
    ProxSGD over every site's groups: one warm step and TRAIN_STEPS timed
    ones, the kernel-vs-XLA-route update check, and a profiled step."""
    from repro_torch.optim.optimizers import prox_sgd, tree_leaves
    from repro_torch.training.regularize import site_group_specs
    from repro_torch.training.trainer import init_train_state, make_train_step

    cfg = get_arch("olmo-1b")
    specs = site_group_specs(api.abstract_params(cfg), cfg, TRAIN_LAM)
    opt = prox_sgd(momentum=0.9, specs=specs)
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, opt, prox_specs=specs, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(cfg, opt, lr=TRAIN_LR, prox_specs=specs)
    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                lm.batch(TRAIN_BATCH, TRAIN_SEQ, seed=i).items()}
               for i in range(TRAIN_STEPS + 3)]
    param_bytes = tensor_bytes(*tree_leaves(state.params))
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_count()  # counts of the main path start here ...
    step_ms, losses, dead, penalty, gnorm = [], [], [], [], []
    for i in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
        dead.append(int(m["dead_groups"]))
        penalty.append(float(m["prox_penalty"]))
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_STEPS + 1
    if not all(np.isfinite(losses)):
        fail(f"train olmo: non-finite loss {losses}")
    if set(counts) != {"group_prox"} or counts["group_prox"] != len(specs) * steps:
        fail(f"train olmo: launched {counts}, expected {len(specs)} group_prox "
             f"launches a step over {steps} steps and nothing else")
    state, prof = profile_train_step(cfg, opt, specs, state, batches[steps])
    check = check_update_routes(state, specs, batches[steps + 1], cfg, dev)
    ms = float(np.median(step_ms[1:]))
    return dict(phase="train_olmo", arch=cfg.name, layers=cfg.n_layers,
                d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
                param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
                remat=cfg.remat, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                lam=TRAIN_LAM, specs=[(s.name, s.kind) for s in specs],
                init_s=init_s, first_step_ms=step_ms[0], step_ms=step_ms,
                ms_per_step=ms, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                peak_device_bytes=peak, param_bytes=param_bytes,
                group_prox_launches_per_step=counts["group_prox"] / steps,
                group_prox_ms_per_step=prof["group_prox_device_ms"],
                group_prox_share_of_step=prof["group_prox_device_ms"] / ms,
                loss=losses, grad_norm=gnorm, dead_groups=dead,
                prox_penalty=penalty, update_check=check, profile=prof
                ), counts, by_shape, steps


def phase_train_mlp():
    """The port's launcher on the paper's MLP: --arch mlp --prox --lambda 0.1
    --epochs 3, in process; K5 twice a step (fc1, fc2)."""
    from repro_torch.launch import train

    dispatch.reset_launch_count()  # counts of the main path start here ...
    stats = train.main(["--arch", "mlp", "--prox", "--lambda", "0.1",
                        "--epochs", "3"])
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    if counts != {"group_prox": 2 * stats["steps"]}:
        fail(f"train mlp: launched {counts} over {stats['steps']} steps, "
             "expected 2 group_prox launches a step and nothing else")
    if not 0.0 <= stats["accuracy"] <= 1.0:
        fail(f"train mlp: accuracy {stats['accuracy']}")
    return (dict(phase="train_mlp", **stats,
                 group_prox_launches_per_step=counts["group_prox"] / stats["steps"]),
            counts, by_shape, stats["steps"])


def run_train(dev):
    """The training phases: K5's cases, olmo-1b at full width, the MLP.
    Returns the kernel rows and the training runs' launch counts."""
    cfg = get_arch("olmo-1b")
    rows = phase_train_kernels(dev, cfg)
    emit(dict(phase="train_kernels", tolerance_float32=PROX_TOL,
              tolerance_bf16=f"one bf16 ulp of the plain version + "
                             f"{PROX_TOL} * |a|",
              killed_rows_margin=PROX_MARGIN, rows=rows))
    torch.cuda.empty_cache()
    olmo, counts, by_shape, steps = phase_train_olmo(dev)
    emit(olmo)
    serves = {f"{cfg.name} train": (counts, by_shape, steps)}
    gc.collect()
    torch.cuda.empty_cache()
    mlp, counts, by_shape, steps = phase_train_mlp()
    emit(mlp)
    serves["mlp train"] = (counts, by_shape, steps)
    return rows, serves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth of the olmo-1b serves (never the width)")
    ap.add_argument("--only", choices=("kernels", "mixtral", "train"),
                    default=None,
                    help="kernels: stop after olmo-1b's kernel phase; "
                         "mixtral: run the mixtral-8x22b phases alone; "
                         "train: run the training phases alone (no final ok "
                         "line in any case)")
    args = ap.parse_args()

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this script measures "
                         "the GPU path and has no CPU fallback")
    dev = torch.device("cuda", 0)
    # float32 products in full float32, never TF32, for every yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.load()
    emit(dict(phase="device_and_build", card=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              build_seconds=build.last_build_seconds,
              sources=[p.name for p in build.sources()]))

    rows, serves = [], {}
    if args.only not in ("mixtral", "train"):
        if args.only == "kernels":
            base = get_arch("olmo-1b")
            if args.layers is not None:
                base = replace(base, n_layers=args.layers)
            cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
            art32 = seeded_artifact(cfg32, seed=2, device=dev)
            plan = CompressedExecutor(art32, device=dev).step_plan(cfg32)
            emit(dict(phase="kernels", rows=phase_kernels(
                dev, art32, plan, reduced_config(get_arch("olmo-1b"), vocab=256))))
            return
        rows, serves = run_olmo(dev, args.layers)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only != "train":
        mrows, mserves = run_mixtral(dev)
        rows += mrows
        serves.update(mserves)
        del mrows, mserves
        gc.collect()
        torch.cuda.empty_cache()
    trows, tserves = run_train(dev)
    rows += trows
    serves.update(tserves)

    # the kernels of the main paths at the dimensions they gave them:
    # ``launches`` is what a serve launched at exactly the row's dimensions
    kernels = kernel_rows(rows, serves)
    emit(dict(phase="done", seconds=time.perf_counter() - t_start,
              host_peak_rss_bytes=host_peak_rss_bytes()))
    emit(dict(kernels=kernels))
    print(smi, flush=True)
    if args.only is not None:
        return
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
