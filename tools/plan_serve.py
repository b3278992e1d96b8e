#!/usr/bin/env python3
"""One checkout's olmo-1b plan serve at full width on a GPU, as
``chip_smoke.py`` drives it, and nothing else.

    python3 tools/plan_serve.py                 # this checkout
    python3 tools/plan_serve.py --root _parent  # another one (the parent)

Loads ``<root>/chip_smoke.py``, and with it that checkout's own package and
kernels; builds the seeded full-width float32 olmo-1b artifact and its layer
plan (packed and uploaded) and runs that script's plan-serve phase: 6
prompts x 16 new tokens on 8 slots, paged KV, launches a step against the
plan's prediction, logits against the per-region and dense routes, and a
profiled steady window (device busy, idle share, device ms by kernel).
Prints the phase's JSON line, then the card's name and power limit.  To
compare two commits, run it for each in turns in one call.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="the checkout whose chip_smoke.py and package run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("plan_serve: no CUDA device")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts <root>/src first on the path
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build.load()
    base = cs.get_arch("olmo-1b")
    cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
    art32 = cs.seeded_artifact(cfg32, seed=2, device=dev)
    plan = cs.CompressedExecutor(art32, device=dev).step_plan(cfg32)
    for ps in plan.stages.values():
        cs.device_stage(ps, dev)
    planned = cs.phase_plan_serve(dev, cfg32, art32, plan.stages.values(),
                                  plan.pack_s)[0]
    cs.emit(dict(planned, root=str(args.root)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
