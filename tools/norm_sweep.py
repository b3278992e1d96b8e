#!/usr/bin/env python3
"""Sweep the launch geometry of K7's norm on a GPU.

    python3 tools/norm_sweep.py

At the olmo-1b and mixtral-8x22b plan serves' shapes (``[d, n_slots]``,
the inputs of ``chip_smoke.py --only prep``) the norm is launched at
``plan_norm``'s geometry and at every other column group (1, 2, 4, 8) and
split over the rows (1, 2, 4, 8) that fits (``norm_geometry``).  Each
geometry goes through ``chip_smoke.kernel_case_norm``: held against the
plain norm and the kernel's own order within ``chip_smoke.SUM_TOL``,
bitwise run to run, timed as ``chip_smoke.py`` times (CUDA events, L2
flushed, median of 7) beside ``F.layer_norm`` / ``F.rms_norm``.  Compare
geometries only within one run.

One JSON object a geometry, then the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src/ on the path)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.layer_plan import (  # noqa: E402
    norm_geometry, plan_norm)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("norm_sweep: needs a CUDA device")
    dev = torch.device("cuda", 0)
    build.load()
    timer = cs.Timer(dev)
    for arch in cs.NORM_ARCHS:
        cfg = cs.get_arch(arch)
        d, b = cfg.d_model, cs.BATCH
        chosen = plan_norm(d, b)
        for cols in (1, 2, 4, 8):
            for split in (1, 2, 4, 8):
                try:
                    plan = norm_geometry(d, b, cols, split)
                except ValueError:
                    continue  # the sub-tile does not fit one block
                row = cs.kernel_case_norm(
                    cfg, dev, timer, plan=plan,
                    label=f"{arch} norm cols={cols} split={split}")
                cs.emit(dict(shape=row["shape"], planner=plan == chosen,
                             **{k: row[k] for k in (
                                 "dims", "ms", "warm_l2_ms", "library_ms",
                                 "bound_ms", "max_abs_err",
                                 "max_abs_err_kernel_order",
                                 "exact_in_kernel_order")}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
