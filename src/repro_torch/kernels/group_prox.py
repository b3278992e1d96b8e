"""Fused group-lasso proximal operator (paper eq. (8)) on the GPU.

Counterpart of ``repro.kernels.group_prox`` (Pallas TPU).  Row-wise block
soft threshold over a ``[G, M]`` view:
``out_i = max(1 - t / ||a_i||_2, 0) * a_i``, zero rows -> exactly 0.  Fusing
the norm with the rescale keeps one read and one write per weight.  It runs
every ProxSGD step over every regularized leaf (``optim.prox_sgd``).

CUDA source: ``csrc/group_prox.cu`` (a warp a row up to M = 2048, a block of
512 threads a row above; float32 sums in a fixed order, so run-to-run
bitwise; in place allowed).  The TPU kernel's ``block_g`` padding is not
needed: the kernel takes any G.
"""
from __future__ import annotations

import torch

from . import build, dispatch

__all__ = ["group_prox", "group_prox_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def group_prox_plain(a: torch.Tensor, thresh) -> torch.Tensor:
    """Plain PyTorch version, the TPU kernel's arithmetic: float32 sum of
    squares and square root a row, ``scale = max(1 - t / max(norm, 1e-12),
    0)`` where the norm is positive and 0 where it is not, ``scale * a`` in
    float32, one cast back to ``a``'s dtype."""
    a32 = a.to(torch.float32)
    norm = torch.sqrt(torch.sum(a32 * a32, dim=1, keepdim=True))
    t = torch.as_tensor(thresh, dtype=torch.float32, device=a.device)
    scale = torch.where(norm > 0.0,
                        torch.clamp(1.0 - t / torch.clamp(norm, min=1e-12),
                                    min=0.0),
                        torch.zeros_like(norm))
    return (scale * a32).to(a.dtype)


def group_prox(a: torch.Tensor, thresh, *, out: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Block soft threshold over the rows of ``a [G, M]`` (float32 or
    bfloat16, float32 arithmetic) with threshold ``thresh`` (a Python float;
    a tensor is read to the host first).  ``out`` (same shape and dtype; may
    be ``a`` itself) receives the result; otherwise a new tensor does.

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    :func:`group_prox_plain`."""
    if a.dim() != 2:
        raise ValueError(f"group_prox takes a [G, M] view, got {tuple(a.shape)}")
    if not dispatch.on_device(a):
        res = group_prox_plain(a, thresh)
        if out is None:
            return res
        return out.copy_(res)
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_prox kernel takes float32 or bfloat16, got {a.dtype}")
    g, m = a.shape
    if g == 0 or m == 0:
        raise ValueError(f"empty launch: G={g}, M={m}")
    dispatch.check_tensor("a", a, a.dtype, (g, m), a.device)
    if out is None:
        out = torch.empty_like(a)
    else:
        dispatch.check_tensor("out", out, a.dtype, (g, m), a.device)
    t = float(thresh)
    lib = build.load()
    with torch.cuda.device(a.device):
        code = lib.repro_group_prox(
            a.data_ptr(), out.data_ptr(), g, m, t, _DTYPE_CODE[a.dtype],
            torch.cuda.current_stream().cuda_stream)
    dispatch.check_launch(code, "repro_group_prox")
    dispatch.record_launch("group_prox", shape=(g, m))
    return out
