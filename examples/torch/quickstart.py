"""Quickstart: LCC-compress a matrix, count adds, run it through the fused
CUDA kernel (``lcc_chain_matmul``).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.csd import adds_csd_matrix
from repro_torch.core.lcc import lcc_decompose
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    rng = np.random.default_rng(0)
    w = rng.standard_normal((300, 16))  # a tall matrix — LCC's sweet spot

    baseline = adds_csd_matrix(w, frac_bits=8)
    print(f"CSD shift-add baseline:        {baseline} additions")

    for alg in ("fp", "fs"):
        dec = lcc_decompose(w, algorithm=alg, frac_bits=8)
        print(f"LCC-{alg.upper()}: {dec.num_adds()} additions "
              f"(ratio {baseline / dec.num_adds():.2f}x, "
              f"SNR {dec.meta['achieved_snr_db']:.1f} dB)")

    # run the FP decomposition through the fused kernel (its plain PyTorch
    # version on the CPU; on the GPU the compact factors stream from HBM and
    # every slice's chain runs in one launch)
    dec = lcc_decompose(w, algorithm="fp", frac_bits=8)
    packed = ops.pack_decomposition(dec)
    x = torch.from_numpy(rng.standard_normal((16, 8))).to(torch.float32).to(device)
    y_kernel = ops.apply_packed_decomposition(packed, x)
    y_exact = torch.from_numpy(w).to(torch.float32).to(device) @ x
    rel = float(torch.linalg.norm(y_kernel - y_exact) / torch.linalg.norm(y_exact))
    print(f"kernel apply vs exact W@x: relative error {rel:.2e} "
          f"(the LCC approximation error, by design ~CSD-quantization level)")
    return {"packed": packed, "x": x, "y_kernel": y_kernel, "rel_err": rel}


if __name__ == "__main__":
    main()
