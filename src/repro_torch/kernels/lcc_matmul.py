"""One LCC factor applied on the GPU:  y = F @ x  (K4).

Counterpart of ``repro.kernels.lcc_matmul`` (Pallas TPU).  A factor ``F``
(at most S signed powers of two a row) is stored as (idx, exp, sign)
streams; the TPU kernel decompresses one-hot tiles of ``F`` for its matrix
unit, here each output element gathers its row's S terms
(``csrc/lcc_factor_matmul.cu``).

Layout:
  idx  [N, S] int32   column index of term s of row n
  exp  [N, S] int8    exponent (power of two)
  sign [N, S] int8    {-1, 0, +1}; 0 marks an unused slot
  x    [K, B]         float32 or bfloat16 activations (features major)
  out  [N, B] f32

Whole FP chains take the fused ``lcc_chain_matmul`` (one launch for every
factor of every slice); this kernel is the per-factor route
(``ops.apply_packed_decomposition(..., fused=False)``): the fused kernel's
wall-clock baseline and a second implementation for equivalence tests.
A CUDA tensor launches the kernel or raises; a CPU tensor takes
:func:`lcc_factor_matmul_plain`.
"""
from __future__ import annotations

import torch

from . import build, dispatch
from .lcc_chain_matmul import signed_pow2

__all__ = ["lcc_factor_matmul", "lcc_factor_matmul_plain"]

_X_DTYPES = (torch.float32, torch.bfloat16)


def lcc_factor_matmul_plain(idx, exp, sign, x) -> torch.Tensor:
    """Plain PyTorch version of :func:`lcc_factor_matmul`: the S gathered
    rows of each output row times exact powers of two, summed over s.
    Terms with sign 0 add nothing (their index is clamped into range)."""
    n, s = idx.shape
    k, b = x.shape
    coef = signed_pow2(sign, exp)  # [N, S]
    g = x.to(torch.float32)[idx.reshape(-1).long().clamp(0, k - 1)]
    return (coef[..., None] * g.reshape(n, s, b)).sum(dim=1)


def lcc_factor_matmul(idx, exp, sign, x) -> torch.Tensor:
    """y[N, B] = F @ x where F is the compact LCC factor (idx, exp, sign).

    The live terms' indices must lie in ``[0, K)`` and their exponents in
    ``[-126, 127]``; the callers validate the streams when they upload them
    (``ops._check_streams``), and the kernel never reads outside ``x``."""
    if idx.dim() != 2 or x.dim() != 2:
        raise ValueError(f"expected idx [N, S] and x [K, B], got "
                         f"{tuple(idx.shape)} and {tuple(x.shape)}")
    if not dispatch.on_device(x):
        return lcc_factor_matmul_plain(idx, exp, sign, x)
    dev = x.device
    n, s = idx.shape
    k, b = x.shape
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, the kernel takes {_X_DTYPES}")
    dispatch.check_tensor("idx", idx, torch.int32, (n, s), dev)
    dispatch.check_tensor("exp", exp, torch.int8, (n, s), dev)
    dispatch.check_tensor("sign", sign, torch.int8, (n, s), dev)
    dispatch.check_tensor("x", x, x.dtype, (k, b), dev)
    if min(n, s, k, b) <= 0:
        raise ValueError(f"empty launch: N,S,K,B = {(n, s, k, b)}")
    lib = build.load()
    out = torch.empty((n, b), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.repro_lcc_factor_matmul(
            idx.data_ptr(), exp.data_ptr(), sign.data_ptr(), x.data_ptr(),
            out.data_ptr(), n, s, k, b, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    dispatch.check_launch(code, "repro_lcc_factor_matmul")
    dispatch.record_launch("lcc_factor_matmul", shape=(n, s, k, b))
    return out
