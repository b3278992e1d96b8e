"""Fused whole-chain LCC evaluation  y = sum_e (F_P ... F_1)_e x_e  on the GPU.

Counterpart of ``repro.kernels.lcc_chain_matmul`` (Pallas TPU).  An LCC
factor chain is cheaper than the dense product it replaces only if its
intermediates stay on chip; this kernel applies an entire FP decomposition —
every factor of every vertical slice (paper eq. (3)) — in ONE launch, the
running vector held in shared memory.  The CUDA source is
``csrc/lcc_chain_matmul.cu`` (body in ``csrc/lcc_chain.cuh``).

Packed layout (built by ``repro_torch.kernels.ops.pack_decomposition``):

  idx  [E, P, N, S] int32  column index of term s of row n, factor p, slice e
  exp  [E, P, N, S] int8   exponent (power of two)
  sign [E, P, N, S] int8   {-1, 0, +1}; 0 marks an unused slot / padded row
  x    [K, B] f32          the decomposition's input, NOT padded per slice
  slice_c0, slice_w [E]    slice e reads x[c0 : c0 + w]
  chain_len [E]            real factor count (0 = dead slice)
  out  [N, B] f32          summed over slices

Chains shorter than P are right-padded with identity factors in the streams
(the packer's contract, kept bitwise equal to the JAX package); the kernel
stops at ``chain_len`` instead of copying the vector through them, and the
plain version simply applies them — both give the same values.

The argument list differs from the Pallas kernel's on purpose: that one took
``x [E, D_pad, B_pad]``, every slice zero-padded to the running vector's
width to feed a ``BlockSpec``; here the first factor reads ``x[c0 + idx]``.
"""
from __future__ import annotations

import torch

from . import build, dispatch

__all__ = ["lcc_chain_matmul", "lcc_chain_matmul_plain", "plan_launch"]

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (sm_90)
_sm_count: dict[int, int] = {}


def signed_pow2(sign: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """sign * 2^exp as float32, exact (exponent bits, no transcendental)."""
    bits = (exp.to(torch.int32) + 127) << 23
    return bits.view(torch.float32) * sign.to(torch.float32)


def _levels_plain(idx, exp, sign, cur):
    """Apply P stacked factors to ``cur [..., D, B]`` -> ``[..., N, B]``;
    ``idx/exp/sign [..., P, N, S]`` share the leading axes."""
    lead = idx.shape[:-3]
    p_factors, n, s = idx.shape[-3:]
    b = cur.shape[-1]
    coef = signed_pow2(sign, exp)
    for p in range(p_factors):
        ii = idx[..., p, :, :].reshape(*lead, n * s).long()
        g = torch.gather(cur, -2, ii[..., None].expand(*lead, n * s, b))
        cur = (coef[..., p, :, :].reshape(*lead, n * s, 1) * g
               ).reshape(*lead, n, s, b).sum(dim=-2)
    return cur


def _slice_inputs_plain(x, slice_c0, slice_w, d):
    """Gather every slice's rows of ``x [K, B]`` into ``[..., D, B]``, rows
    beyond the slice's width zero."""
    r = torch.arange(d, device=x.device)
    live = r < slice_w[..., None]
    rows = (slice_c0[..., None].long() + r).clamp_(0, x.shape[0] - 1)
    return x[rows] * live[..., None].to(x.dtype)


def lcc_chain_matmul_plain(idx, exp, sign, x, slice_c0, slice_w, chain_len=None):
    """Plain PyTorch version of :func:`lcc_chain_matmul`: gathers, exact
    powers of two, sums — the kernel's arithmetic step by step.  The sum over
    slices is one ``torch.sum`` (its order is PyTorch's, not the kernel's)."""
    n = idx.shape[-2]
    d = max(n, int(slice_w.max()) if slice_w.numel() else 1)
    cur = _slice_inputs_plain(x.to(torch.float32), slice_c0, slice_w, d)
    return _levels_plain(idx, exp, sign, cur).sum(dim=-3)


def plan_launch(n: int, b: int, g: int, e: int, sm_count: int
                ) -> tuple[int, int, int, int]:
    """Launch geometry ``(bb, threads, chunks, slices_per_block)``.

    ``bb``: batch columns per block — the widest of 8/4/2/1 not beyond the
    batch for which two ``[N, bb]`` float32 buffers fit in shared memory.
    ``chunks``: blocks along the slice axis, about one wave of the card's SMs
    over all (group, b-block) pairs; each block walks ``slices_per_block``
    slices in order."""
    bb = next((c for c in (8, 4, 2, 1)
               if (c == 1 or c < 2 * b) and 2 * n * c * 4 <= SMEM_LIMIT), None)
    if bb is None:
        raise NotImplementedError(
            f"lcc chain kernel: N={n} rows need {2 * n * 4} bytes of shared "
            f"memory per batch column, above the {SMEM_LIMIT}-byte limit")
    threads = min(1024, -(-n // 32) * 32)
    b_blocks = -(-b // bb)
    want = max(1, -(-sm_count // (g * b_blocks)))
    spb = -(-e // min(e, want))
    chunks = -(-e // spb)
    return bb, threads, chunks, spb


def _launch(entry: str, idx, exp, sign, x, slice_c0, slice_w, chain_len):
    """Validate, allocate and launch; ``idx`` is ``[G, E, P, N, S]``."""
    dev = x.device
    g, e, p, n, s = idx.shape
    if x.dim() != 2:
        raise ValueError(f"x must be [K, B], got {tuple(x.shape)}")
    b = x.shape[1]
    dispatch.check_tensor("idx", idx, torch.int32, (g, e, p, n, s), dev)
    dispatch.check_tensor("exp", exp, torch.int8, (g, e, p, n, s), dev)
    dispatch.check_tensor("sign", sign, torch.int8, (g, e, p, n, s), dev)
    dispatch.check_tensor("x", x, torch.float32, x.shape, dev)
    for nm, t in (("slice_c0", slice_c0), ("slice_w", slice_w),
                  ("chain_len", chain_len)):
        dispatch.check_tensor(nm, t, torch.int32, (g, e), dev)
    if min(g, e, p, n, s, b) <= 0:
        raise ValueError(f"empty launch: G,E,P,N,S,B = {(g, e, p, n, s, b)}")
    di = dev.index if dev.index is not None else torch.cuda.current_device()
    if di not in _sm_count:
        _sm_count[di] = torch.cuda.get_device_properties(di).multi_processor_count
    bb, threads, chunks, spb = plan_launch(n, b, g, e, _sm_count[di])
    lib = build.load()
    partial = torch.empty((g, chunks, n, b), dtype=torch.float32, device=dev)
    out = torch.empty((g, n, b), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (idx, exp, sign, x, slice_c0, slice_w,
                                   chain_len, partial, out)]
    dims = [e, p, n, s, b, chunks, spb, bb, threads]
    if entry == "repro_lcc_group_matmul":
        dims = [g] + dims
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(*ptrs, *dims, stream)
    dispatch.check_launch(code, entry)
    return out


def lcc_chain_matmul(idx, exp, sign, x, slice_c0, slice_w, chain_len
                     ) -> torch.Tensor:
    """y[N, B] = sum_e chain_e(x[c0_e : c0_e + w_e]) — whole decomposition,
    one launch.  CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`lcc_chain_matmul_plain`."""
    if not dispatch.on_device(x):
        return lcc_chain_matmul_plain(idx, exp, sign, x, slice_c0, slice_w,
                                      chain_len)
    if idx.dim() != 4:
        raise ValueError(f"idx must be [E, P, N, S], got {tuple(idx.shape)}")
    out = _launch("repro_lcc_chain_matmul", idx[None], exp[None], sign[None],
                  x, slice_c0[None], slice_w[None], chain_len[None])
    dispatch.record_launch("lcc_chain_matmul",
                           shape=(*idx.shape, x.shape[0], x.shape[1]))
    return out[0]
