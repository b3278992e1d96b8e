#!/usr/bin/env python3
"""Sweep the split of K7's decode attention over the cache on a GPU, and
split its time between its two kernels.

    python3 tools/attention_sweep.py                   # every case
    python3 tools/attention_sweep.py --shapes serve    # labels with a word

Cases are ``chip_smoke.attention_cases`` (the ``--only attention`` cases:
the olmo-1b and mixtral-8x22b plan serves' shapes and their long caches,
with the same seeded inputs).  For each case:

* ``plan``: ``plan_attention``'s split, timed as ``chip_smoke.py`` times
  (CUDA events, L2 flushed, median of 7) and warm (L2 not flushed), and
  profiled (``torch.profiler``, 20 warm launches): device time a launch of
  the split kernel and of the merge kernel;
* the sweep: every chunk of 16 to 512 slots (a multiple of the page), each
  launched through the same entry point with that split, held against the
  plain version within ``chip_smoke.SUM_TOL`` and timed cold;
* ``scaled_dot_product_attention`` on the same function, cold;

and K8's route at mixtral-8x22b's width (``chip_smoke.route_case_inputs``),
timed cold and warm and profiled (the logits kernel and the routing kernel).

One JSON object per line; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src/ on the path)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.layer_plan import (  # noqa: E402
    AttentionPlan, _attend, _attention_ws, attention_key, attention_smem,
    plan_attention, step_attention, step_attention_plain)
from repro_torch.kernels.lcc_chain_matmul import SMEM_LIMIT  # noqa: E402
from repro_torch.kernels.moe_route import capacity, moe_route  # noqa: E402


def launcher(a, plan):
    """One launch of the attention kernels of ``a`` split by ``plan``."""
    lib, dev = build.load(), a["qkv"].device
    b, smax = a["kpos"].shape
    nq, nkv, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    tbl = a["block_tbl"]
    bs, mb = a["kc"].shape[1], tbl.shape[1]
    kn = torch.empty((b, nkv, hd), device=dev)
    vn = torch.empty_like(kn)
    ws = _attention_ws(plan, b, nkv, nq // nkv, hd, dev)
    key = attention_key(b, smax, nq, nkv, hd, bs, a["window"])

    def run():
        att = _attend(lib, torch.cuda.current_stream().cuda_stream, plan, key,
                      a["qkv"], a["pos"], a["cos"], a["sin"],
                      a["kc"].data_ptr(), a["vc"].data_ptr(),
                      a["kpos"].data_ptr(), tbl, kn.data_ptr(), vn.data_ptr(),
                      ws, b=b, smax=smax, nq=nq, nkv=nkv, hd=hd, bs=bs, mb=mb,
                      window=a["window"])
        return att, kn, vn
    return run


def profiled(fn, n=20):
    """Device ms a launch by kernel name over ``n`` warm launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            name = (ev.key.replace("(anonymous namespace)::", "")
                    .removeprefix("void ").split("(")[0])
            out[name] = out.get(name, 0.0) + us / 1e3 / n
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=None,
                    help="comma-separated words; keep labels containing one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep: needs a CUDA device")
    dev = torch.device("cuda", 0)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    build.load()
    timer, warm = cs.Timer(dev), cs.Timer(dev)
    words = args.shapes.split(",") if args.shapes else None
    for label, cfg, smax, window, pos in cs.attention_cases(
            np.random.default_rng(60)):
        if words and not any(w in label for w in words):
            continue
        seed = cs.zlib.crc32(label.encode())
        torch.manual_seed(seed)
        a = cs.attention_inputs(cfg, smax, window, pos,
                                np.random.default_rng(seed), dev)
        want = step_attention_plain(**a)
        b, nq, nkv, hd = len(pos), cfg.n_heads, cfg.n_kv_heads, cfg.hd
        g = nq // nkv
        plan = plan_attention(b, nkv, g, smax, sm, cs.PAGE, head_dim=hd)
        rows_kv, rows_v = cs.live_rows(a)
        bound = cs.bound_of(*cs.attention_cost(a, rows_kv, rows_v))
        fn = lambda: step_attention(**a)  # noqa: E731
        q, kx, vx, mask = cs.sdpa_inputs(a)
        cs.emit(dict(shape=label, what="plan", splits=plan.splits,
                     chunk=plan.chunk, blocks=plan.splits * nkv * b,
                     ms=timer(fn), warm_ms=warm(fn, cold=False),
                     device_ms_by_kernel=profiled(fn), bound_ms=bound[0],
                     sdpa_ms=timer(lambda: F.scaled_dot_product_attention(
                         q, kx, vx, attn_mask=mask))))
        del q, kx, vx, mask
        for chunk in (16, 32, 64, 128, 256, 512):
            if chunk % cs.PAGE or chunk > max(cs.PAGE, 2 * smax):
                continue
            splits = -(-smax // chunk)
            if (splits - 1) * chunk >= smax:
                continue
            p = AttentionPlan(splits, chunk, attention_smem(g, hd, chunk),
                              4 * (splits + 1))
            if max(p.smem, p.merge_smem) > SMEM_LIMIT:
                continue
            run = launcher(a, p)
            got = run()
            torch.cuda.synchronize()
            err = max(cs.check_close(f"{label} chunk {chunk}", x, y, cs.SUM_TOL)
                      for x, y in zip(got, want))
            cs.emit(dict(shape=label, what="sweep", splits=splits, chunk=chunk,
                         blocks=splits * nkv * b, ms=timer(run),
                         max_abs_err=err))
        del a, want
        torch.cuda.empty_cache()
    if not words or any(w in "mixtral route" for w in words):
        cfg, router = cs.route_case_inputs(dev)
        h2 = torch.randn((cfg.d_model, cs.BATCH), device=dev)
        kw = dict(top_k=cfg.moe.top_k, norm_topk=cfg.moe.norm_topk,
                  cap=capacity(cs.BATCH, cfg.moe.top_k,
                               cfg.moe.capacity_factor, cfg.moe.n_experts))
        fn = lambda: moe_route(h2, router, **kw)  # noqa: E731
        cs.emit(dict(shape="mixtral route", what="route", ms=timer(fn),
                     warm_ms=warm(fn, cold=False),
                     device_ms_by_kernel=profiled(fn)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
