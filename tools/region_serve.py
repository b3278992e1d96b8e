#!/usr/bin/env python3
"""One checkout's bf16 per-region serves at full width on a GPU, as
``chip_smoke.py`` drives them, with their token streams and logits kept for
a bitwise comparison with another checkout's.

    python3 tools/region_serve.py --root _parent --out build/rs/parent.pt
    python3 tools/region_serve.py --out build/rs/this.pt
    python3 tools/region_serve.py --compare build/rs/parent.pt build/rs/this.pt

Loads ``<root>/chip_smoke.py``, and with it that checkout's own package and
kernels.  For each architecture (``--archs``; olmo-1b uncut, mixtral-8x22b
and deepseek-v2-lite-16b cut as that script cuts them) it builds the seeded
full-width artifact (seed 2), serves 6 prompts x 16 new tokens on 8 slots
through the bf16 per-region route, takes two decode steps' logits from a
fresh cache through the same executor, and times a steady window: the
host's wall time a step (profilers off), then the device's busy time and its
kernels a step by the profiler, with the per-region route's input
preparation counted by kind (gathers, concatenations, segment sums, region
preps; dtype conversions and copies apart).  For deepseek it also takes the
float32 K9 route's two-step logits (one expert plan a layer; MLA and the
shared experts per-region).  One JSON line an architecture, then the card's
name and power limit; the tokens and logits go to ``--out``.  ``--compare``
checks two such files for equal token streams and bitwise equal logits.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ARCHS = ("olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b")
# what the per-region input preparation runs, by profiler key: the PyTorch
# operations it was made of (a gather a member, a concatenation a region,
# float32 copies) and its kernels (K3's segment sum, the region prep); the
# step's other operations of these kinds are counted with them, so the
# preparation's share is the difference between two checkouts
PREP_KEYS = ("aten::index_select", "aten::cat", "aten::_to_copy",
             "cluster_segment_sum_kernel", "region_prep_kernel")


def load_chip_smoke(root: Path):
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts <root>/src first on the path
    return cs


def steady_window(cs, eng, prompts, n_steps: int = 8) -> dict:
    """Wall ms a step with the profilers off, then device busy ms and
    kernels a step by torch.profiler (device activity only), then the
    :data:`PREP_KEYS` operations and kernels a step (host and device
    activity), on a warm engine."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new=3 * n_steps + 4)
    eng.step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as ops:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    while eng.active.any():
        eng.step()
    busy, kernels, counts = 0.0, 0, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us <= 0:
            continue
        busy += dev_us / 1e3
        kernels += ev.count
        counts[ev.key] = counts.get(ev.key, 0) + ev.count
    prep = dict.fromkeys(PREP_KEYS, 0)
    for ev in ops.key_averages():
        for key in PREP_KEYS:
            prep[key] += ev.count if key in ev.key else 0
    wall = float(np.median(walls))
    return dict(wall_ms_per_step=wall, wall_ms_each=walls,
                device_busy_ms_per_step=busy / n_steps,
                device_idle_share=max(0.0, 1.0 - busy / n_steps / wall),
                device_kernels_per_step=kernels / n_steps,
                ops_per_step={k: v / n_steps for k, v in prep.items()},
                kernels_by_count={
                    k.replace("(anonymous namespace)::", "")[:72]: v / n_steps
                    for k, v in sorted(counts.items(), key=lambda kv: -kv[1])[:24]})


def run_arch(cs, arch: str, dev) -> tuple[dict, dict]:
    base = cs.get_arch(arch)
    cut = {"mixtral-8x22b": getattr(cs, "MIXTRAL_LAYERS", None),
           "deepseek-v2-lite-16b": getattr(cs, "DEEPSEEK_LAYERS", None)}.get(arch)
    if cut is not None:
        base = replace(base, n_layers=cut)
    cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    art32 = cs.seeded_artifact(cfg32, seed=2, device=dev, host_effective=False)
    fixture_s = time.perf_counter() - t0
    art16 = replace(art32, config=base,
                    params=cs.cast(art32.params, torch.bfloat16), plans={})
    prompts = cs.prompts_for(base, 6)
    cs.dispatch.reset_launch_count()
    eng, res, step_s = cs.serve(art16, dev, use_kernel=True, n_slots=cs.BATCH,
                                prompts=prompts, max_new=16)
    torch.cuda.synchronize()
    tokens = [list(r.tokens) for r in res]
    if any(r.error or not r.finished for r in res):
        raise SystemExit(f"region_serve: {arch}: a request failed")
    logits = cs.two_step_logits(base, art16, eng.executor, dev).cpu()
    window = steady_window(cs, eng, prompts)
    kept = {"tokens": tokens, "logits": logits}
    line = dict(arch=arch, layers=base.n_layers, fixture_s=fixture_s,
                first_step_ms=step_s[0] * 1e3,
                serve_ms_per_step=float(np.median(step_s[1:])) * 1e3,
                launches_per_step=eng.kernel_launches_per_step,
                launches=cs.dispatch.launch_counts(), **window)
    del eng, art16
    torch.cuda.empty_cache()
    if cfg32.mla is not None:  # the K9 route: per-region MLA and shared experts
        ex = cs.CompressedExecutor(art32, device=dev)
        kept["logits_k9"] = cs.two_step_logits(cfg32, art32, ex, dev).cpu()
        line["k9_plan_fallbacks"] = ex.plan_fallbacks
        del ex
    del art32
    torch.cuda.empty_cache()
    return line, kept


def compare(a: Path, b: Path) -> None:
    x, y = torch.load(a), torch.load(b)
    out = {}
    for arch in x:
        same = {"tokens": x[arch]["tokens"] == y[arch]["tokens"]}
        for key in x[arch]:
            if key.startswith("logits"):
                same[key] = bool(torch.equal(x[arch][key], y[arch][key]))
                same[key + "_max_abs_diff"] = float(
                    (x[arch][key] - y[arch][key]).abs().max())
        out[arch] = same
    print(json.dumps(dict(compare=[str(a), str(b)], result=out)), flush=True)
    if not all(v for r in out.values() for k, v in r.items()
               if not k.endswith("_diff")):
        raise SystemExit("region_serve: the two checkouts differ")


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
        raise SystemExit("region_serve: no CUDA device")
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
