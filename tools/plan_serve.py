#!/usr/bin/env python3
"""One checkout's float32 plan-route serves at full width on a GPU, as
``chip_smoke.py`` drives them, with their token streams and two-step logits
kept for a bitwise comparison with another checkout's.

    python3 tools/plan_serve.py                           # this checkout
    python3 tools/plan_serve.py --root _parent --out build/ps/parent.pt
    python3 tools/plan_serve.py --out build/ps/this.pt --archs olmo-1b
    python3 tools/plan_serve.py --compare build/ps/parent.pt build/ps/this.pt

Loads ``<root>/chip_smoke.py``, and with it that checkout's own package and
kernels.  For each architecture (``--archs``; olmo-1b uncut, mixtral-8x22b
and deepseek-v2-lite-16b cut as that script cuts them) it builds the seeded
full-width float32 artifact (seed 2) and its plan route — olmo-1b and
mixtral-8x22b the whole-step layer plan, deepseek-v2-lite-16b one expert
plan a layer (K9) beside per-region MLA and shared experts — packed and
uploaded, serves 6 prompts x 16 new tokens on 8 slots, paged KV, takes two
decode steps' logits from a fresh cache through the serve's executor, and
profiles a steady window (``chip_smoke.profile_steps``: the host's wall time
a step, device busy and kernels a step by the profiler).  One JSON line an
architecture (launches a step as the engine counts them), then the card's
name and power limit; tokens and logits go to ``--out``.  ``--compare``
checks two such files for equal token streams and bitwise equal logits
(on the architectures both hold).  To compare two commits, run it for each
in turns in one call.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ARCHS = ("olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b")


def load_chip_smoke(root: Path):
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts <root>/src first on the path
    return cs


def run_arch(cs, arch: str, dev) -> tuple[dict, dict]:
    base = cs.get_arch(arch)
    cut = {"mixtral-8x22b": cs.MIXTRAL_LAYERS,
           "deepseek-v2-lite-16b": cs.DEEPSEEK_LAYERS}.get(arch)
    if cut is not None:
        base = replace(base, n_layers=cut)
    cfg = replace(base, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    art = cs.seeded_artifact(cfg, seed=2, device=dev, host_effective=False)
    fixture_s = time.perf_counter() - t0
    ex = cs.CompressedExecutor(art, device=dev)
    t0 = time.perf_counter()
    if cfg.mla is not None:  # the K9 route: one expert plan a layer
        plans = [ex.moe_plan(f"l{li}", n_experts=cfg.moe.n_experts,
                             d_model=cfg.d_model, d_ff=cfg.moe.d_ff_expert)
                 for li in range(cfg.n_layers)]
    else:
        plans = [ex.step_plan(cfg)]
    stages = [ps for plan in plans for ps in plan.stages.values()]
    # a one-layer expert stage a thread, as chip_smoke.py uploads them (a
    # stacked stage spreads its own layers over threads)
    with ThreadPoolExecutor(max_workers=len(stages) if cfg.mla else 1) as pool:
        list(pool.map(lambda ps: cs.device_stage(ps, dev), stages))
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    del ex
    prompts = cs.prompts_for(cfg, 6)
    cs.dispatch.reset_launch_count()
    eng, res, step_s = cs.serve(art, dev, use_kernel=True, n_slots=cs.BATCH,
                                prompts=prompts, max_new=16)
    torch.cuda.synchronize()
    if any(r.error or not r.finished for r in res):
        raise SystemExit(f"plan_serve: {arch}: a request failed")
    launches = cs.dispatch.launch_counts()
    kept = {"tokens": [list(r.tokens) for r in res],
            "logits": cs.two_step_logits(cfg, art, eng.executor, dev).cpu()}
    line = dict(arch=arch, layers=cfg.n_layers, fixture_s=fixture_s,
                plan_s=plan_s, n_layer_plans=eng.n_layer_plans,
                plan_fallbacks=eng.executor.plan_fallbacks,
                first_step_ms=step_s[0] * 1e3,
                ms_per_step=float(np.median(step_s[1:])) * 1e3,
                launches_per_step=eng.kernel_launches_per_step,
                launches=launches, decode_steps=eng.step_dispatches,
                profile=cs.profile_steps(eng, prompts))
    del eng, art, plans, stages
    gc.collect()
    torch.cuda.empty_cache()
    return line, kept


def compare(a: Path, b: Path) -> None:
    x, y = torch.load(a), torch.load(b)
    out = {}
    for arch in [arch for arch in x if arch in y]:  # the archs both served
        out[arch] = {"tokens": x[arch]["tokens"] == y[arch]["tokens"],
                     "logits": bool(torch.equal(x[arch]["logits"],
                                                y[arch]["logits"])),
                     "logits_max_abs_diff": float(
                         (x[arch]["logits"] - y[arch]["logits"]).abs().max())}
    print(json.dumps(dict(compare=[str(a), str(b)], result=out)), flush=True)
    if not out or not all(r["tokens"] and r["logits"] for r in out.values()):
        raise SystemExit("plan_serve: the two checkouts differ")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="the checkout whose chip_smoke.py and package run")
    ap.add_argument("--archs", nargs="+", default=list(ARCHS), choices=ARCHS)
    ap.add_argument("--out", type=Path, help="where the tokens and logits go")
    ap.add_argument("--compare", nargs=2, type=Path, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if not torch.cuda.is_available():
        raise SystemExit("plan_serve: no CUDA device")
    cs = load_chip_smoke(args.root.resolve())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build.load()
    kept = {}
    for arch in args.archs:
        line, kept[arch] = run_arch(cs, arch, dev)
        print(json.dumps(dict(line, root=str(args.root))), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        torch.save(kept, args.out)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
