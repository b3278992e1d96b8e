#!/usr/bin/env python3
"""K7's decode attention and K8's route of another checkout (the parent
commit) against this one's, on a GPU, in one process.

    git archive HEAD~1 | tar -x -C _parent      # any checkout of the parent
    python3 tools/parent_kernels.py --root _parent

Builds the kernels of ``--root`` with that checkout's own build module (into
its own ``build/``) beside this checkout's.  At every case of ``chip_smoke.py
--only attention`` (``chip_smoke.attention_cases``, the same seeded inputs)
it launches the other checkout's attention through its C entry point
``repro_step_attention`` (the one-block-a-(kv-head, row) kernel this tree
replaced) and this tree's ``step_attention``; at mixtral-8x22b's route case
both trees' ``repro_moe_route``.  Each result is held against this tree's
plain version (attention within ``chip_smoke.SUM_TOL``; the route's experts,
slots and source tokens exactly), then both are timed as ``chip_smoke.py``
times (CUDA events, L2 flushed, median of 7) in turns: other, this, this,
other.  One JSON object a case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src/ on the path)
from repro_torch.kernels.layer_plan import (  # noqa: E402
    step_attention, step_attention_plain)
from repro_torch.kernels.moe_route import (  # noqa: E402
    capacity, moe_route, moe_route_plain)


def other_library(root: Path):
    """The other checkout's kernel library, built by its own build module."""
    spec = importlib.util.spec_from_file_location(
        "other_build", root / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def other_attention(lib, a):
    """``(att, k_new, v_new)`` through the other tree's
    ``repro_step_attention`` (paged inputs of ``chip_smoke.attention_inputs``)."""
    qkv, kpos, tbl = a["qkv"], a["kpos"], a["block_tbl"]
    b, smax = kpos.shape
    nq, nkv, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    att = torch.empty((nq * hd, b), device=qkv.device)
    kn = torch.empty((b, nkv, hd), device=qkv.device)
    vn = torch.empty_like(kn)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    code = lib.repro_step_attention(
        qkv.data_ptr(), a["pos"].data_ptr(), a["cos"].data_ptr(),
        a["sin"].data_ptr(), a["kc"].data_ptr(), a["vc"].data_ptr(),
        kpos.data_ptr(), tbl.data_ptr(), att.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), b, smax, nq, nkv, hd, a["kc"].shape[1], tbl.shape[1],
        a["window"] or 0, scale, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"repro_step_attention: CUDA error {code}")
    return att, kn, vn


def other_route(lib, h2, router, *, top_k, cap, norm_topk):
    d, b = h2.shape
    n_exp = router.shape[1]
    i32 = dict(dtype=torch.int32, device=h2.device)
    sel, slot = torch.empty((b, top_k), **i32), torch.empty((b, top_k), **i32)
    wgt = torch.empty((b, top_k), device=h2.device)
    src_tok = torch.empty((n_exp * cap,), **i32)
    code = lib.repro_moe_route(
        h2.data_ptr(), router.data_ptr(), sel.data_ptr(), wgt.data_ptr(),
        slot.data_ptr(), src_tok.data_ptr(), None, d, b, n_exp, top_k, cap,
        int(bool(norm_topk)), torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"repro_moe_route: CUDA error {code}")
    return sel, wgt, slot, src_tok


def in_turns(timer, other, this):
    """Times in the order other, this, this, other."""
    o1, t1, t2, o2 = timer(other), timer(this), timer(this), timer(other)
    return [o1, o2], [t1, t2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, required=True,
                    help="the other checkout (its src/ and csrc/ are used)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("parent_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    lib = other_library(args.root.resolve())
    timer = cs.Timer(dev)
    for label, cfg, smax, window, pos in cs.attention_cases(
            np.random.default_rng(60)):
        seed = cs.zlib.crc32(label.encode())
        torch.manual_seed(seed)
        a = cs.attention_inputs(cfg, smax, window, pos,
                                np.random.default_rng(seed), dev)
        want = step_attention_plain(**a)
        errs = {}
        for tree, fn in (("other", lambda: other_attention(lib, a)),
                         ("this", lambda: step_attention(**a))):
            got = fn()
            torch.cuda.synchronize()
            errs[tree] = max(cs.check_close(f"{tree} {label}", x, y, cs.SUM_TOL)
                             for x, y in zip(got, want))
        other_ms, this_ms = in_turns(timer, lambda: other_attention(lib, a),
                                     lambda: step_attention(**a))
        rows_kv, rows_v = cs.live_rows(a)
        bound = cs.bound_of(*cs.attention_cost(a, rows_kv, rows_v))
        cs.emit(dict(kernel="step_attention", shape=label, other_ms=other_ms,
                     this_ms=this_ms, bound_ms=bound[0], max_abs_err=errs))
        del a, want
        torch.cuda.empty_cache()
    cfg, router = cs.route_case_inputs(dev)
    d, n_exp, k = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    cap = capacity(cs.BATCH, k, cfg.moe.capacity_factor, n_exp)
    kw = dict(top_k=k, cap=cap, norm_topk=cfg.moe.norm_topk)
    h2 = torch.randn((d, cs.BATCH), device=dev)
    h2[:, cs.BATCH - 2:] = h2[:, cs.BATCH - 2: cs.BATCH - 1]  # two idle columns
    want = moe_route_plain(h2, router, **kw)
    errs = {}
    for tree, fn in (("other", lambda: other_route(lib, h2, router, **kw)),
                     ("this", lambda: moe_route(h2, router, **kw))):
        got = fn()
        torch.cuda.synchronize()
        for i in (0, 2, 3):
            if not torch.equal(got[i], want[i]):
                cs.fail(f"{tree} route: output {i} differs from the plain version")
        errs[tree] = cs.check_close(f"{tree} route", got[1], want[1], cs.SUM_TOL)
    other_ms, this_ms = in_turns(timer, lambda: other_route(lib, h2, router, **kw),
                                 lambda: moe_route(h2, router, **kw))
    cs.emit(dict(kernel="moe_route", shape="mixtral route", other_ms=other_ms,
                 this_ms=this_ms, max_abs_err=errs))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
