"""Grouped fused LCC evaluation — G decompositions, ONE launch.

Counterpart of ``repro.kernels.lcc_group_matmul`` (Pallas TPU).  A decode
step touches several decompositions at once — the q/k/v projections of an
attention layer, the gate/up projections of a SwiGLU FFN — and one launch per
site brings back the per-launch overhead the fused chain kernel removed.
This kernel adds a leading *group* axis; the chain-evaluation body is shared
with :mod:`~repro_torch.kernels.lcc_chain_matmul`.  CUDA source:
``csrc/lcc_group_matmul.cu``.

  idx/exp/sign [G, E, P, N, S]   members re-padded to common dims by
                                 ``ops.pack_group`` (missing slices: sign 0)
  x            [sum_g K_g, B]    the members' inputs, concatenated
  slice_c0, slice_w, chain_len [G, E]   slice (g, e) reads x[c0 : c0 + w];
                                 chain_len 0 marks a slice the member lacks
  out          [G, N, B] f32
"""
from __future__ import annotations

import torch

from . import dispatch
from .lcc_chain_matmul import _launch, lcc_chain_matmul_plain

__all__ = ["lcc_group_matmul", "lcc_group_matmul_plain"]


def lcc_group_matmul_plain(idx, exp, sign, x, slice_c0, slice_w, chain_len=None):
    """Plain PyTorch version of :func:`lcc_group_matmul` (the chain's plain
    version carries any leading axes, so the group axis rides along)."""
    return lcc_chain_matmul_plain(idx, exp, sign, x, slice_c0, slice_w,
                                  chain_len)


def lcc_group_matmul(idx, exp, sign, x, slice_c0, slice_w, chain_len
                     ) -> torch.Tensor:
    """out[g] = sum_e chain_{g,e}(x[c0_{g,e} : c0_{g,e} + w_{g,e}]) — one
    launch for all G members.  CUDA tensors launch the kernel (or raise); CPU
    tensors take :func:`lcc_group_matmul_plain`."""
    if not dispatch.on_device(x):
        return lcc_group_matmul_plain(idx, exp, sign, x, slice_c0, slice_w,
                                      chain_len)
    if idx.dim() != 5:
        raise ValueError(f"idx must be [G, E, P, N, S], got {tuple(idx.shape)}")
    out = _launch("repro_lcc_group_matmul", idx, exp, sign, x, slice_c0,
                  slice_w, chain_len)
    dispatch.record_launch("lcc_group_matmul",
                           shape=(*idx.shape, x.shape[0], x.shape[1]))
    return out
