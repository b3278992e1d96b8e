#!/usr/bin/env python3
"""Time the reference (numpy) LCC compressor on one column slice at olmo-1b's
published widths, on the CPU of the machine it runs on.

    PYTHONPATH=src python tools/time_reference_compressor.py

Decomposes one random ``2048 x 11`` slice (a q/k/v/o/gate/up slice) and one
``8192 x 13`` slice (an ``ffn.down``-shaped one) with the FP algorithm at the
CSD-matched 25.8 dB target, prints seconds per slice and the chain shape, and
extrapolates to one layer and to the 16-layer model from the slice grid.  It
says why serving on the GPU is driven from a seeded artifact fixture: the
compressor is an offline CPU program that runs for hours at this width.
"""
import json
import platform
import time

import numpy as np

from repro.core.lcc import lcc_decompose_slice, plan_col_slices

TARGET_SNR_DB = 25.8
D_MODEL, D_FF, LAYERS = 2048, 8192, 16


def time_slice(n: int, w: int, seed: int) -> dict:
    we = np.random.default_rng(seed).standard_normal((n, w)) / np.sqrt(w)
    t0 = time.perf_counter()
    chain = lcc_decompose_slice(we, "fp", TARGET_SNR_DB)
    return {"rows": n, "width": w, "seconds": time.perf_counter() - t0,
            "factors": len(chain.factors),
            "terms_per_row": max(f.s_terms for f in chain.factors)}


def main() -> None:
    # slices per site on the compressor's own grid: (N out, K in) -> count
    n_slices = {name: len(plan_col_slices(n, k)) for name, n, k in (
        ("qkvo", D_MODEL, D_MODEL), ("gate_up", D_FF, D_MODEL),
        ("down", D_MODEL, D_FF))}
    narrow = time_slice(D_MODEL, 11, seed=0)
    tall = time_slice(D_FF, 13, seed=1)
    # q, k, v, o and down have 2048-row slices; gate and up 8192-row slices
    layer_s = ((4 * n_slices["qkvo"] + n_slices["down"]) * narrow["seconds"]
               + 2 * n_slices["gate_up"] * tall["seconds"])
    print(json.dumps({"cpu": platform.processor() or platform.machine(),
                      "slices": [narrow, tall], "slices_per_site": n_slices,
                      "layer_hours": layer_s / 3600,
                      "model_hours": LAYERS * layer_s / 3600}))


if __name__ == "__main__":
    main()
