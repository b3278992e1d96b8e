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

__all__ = ["lcc_chain_matmul", "lcc_chain_matmul_plain", "plan_launch",
           "plan_staging", "launch_staging"]

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (sm_90)
SM_SMEM = 233472  # shared memory of one SM; each resident block reserves 1 KB
MAX_SUMS = 32  # register sums a thread keeps: rows a thread x bb (kMaxSums)
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


def _align16(v: int) -> int:
    return -(-v // 16) * 16


def slot_bytes(tile: int, s: int) -> int:
    """Bytes of one slot of the staging ring: ``tile`` rows of idx (int32),
    exp and sign (int8), each region with room for a 15-byte alignment
    offset (``slot_bytes`` in ``csrc/lcc_chain.cuh``)."""
    return _align16(tile * s * 4 + 16) + 2 * _align16(tile * s + 16)


def plan_staging(n: int, s: int, bb: int, threads: int,
                 budget: int = SMEM_LIMIT) -> tuple[int, int, int] | None:
    """``(tile, stages, shared-memory bytes)`` of the staging ring beside the
    two ``[N, bb]`` float32 buffers within ``budget`` bytes, or None where not
    even two one-row-a-thread tiles fit.  As few work items a factor as two
    slots allow (a whole factor where it fits), the rows spread evenly over
    them in whole rows a thread; three slots where they fit, else two."""
    buffers = _align16(2 * n * bb * 4)
    rpt = -(-n // threads)
    widest = next((rows for rows in range(rpt, 0, -1)
                   if buffers + 2 * slot_bytes(min(n, rows * threads), s)
                   <= budget), None)
    if widest is None:
        return None
    items = -(-rpt // widest)
    tile = min(n, -(-rpt // items) * threads)
    stages = 3 if buffers + 3 * slot_bytes(tile, s) <= budget else 2
    return tile, stages, buffers + stages * slot_bytes(tile, s)


def _threads(n: int, cap: int) -> int:
    return min(cap, -(-n // 32) * 32)


def plan_launch(n: int, b: int, g: int, e: int, sm_count: int, s: int = 2
                ) -> tuple[int, int, int, int]:
    """Launch geometry ``(bb, threads, chunks, slices_per_block)``.

    Rows are fixed to ``threads`` row threads (``ceil(N / threads)`` a
    thread; the block has two more warps, which issue the copies), and a
    thread keeps its rows' slice sums in registers, at most ``MAX_SUMS``
    floats.  ``bb``: batch columns per block — the widest of 8/4/2/1 not
    beyond the batch for which, at 512 row threads, the sums stay within
    ``MAX_SUMS`` and two ``[N, bb]`` float32 buffers and a staging ring for
    ``s`` terms a row (:func:`plan_staging`) fit in shared memory; above
    16384 rows one column a block on up to 960 row threads.  ``threads``:
    256 where the block then fits twice on an SM (two blocks hide each
    other's barriers), else 512.
    ``chunks``: blocks along the slice axis, as many as one wave of the
    card's block slots holds over all (group, b-block) pairs — a second,
    partial wave would double the time; each block walks
    ``slices_per_block`` slices in order."""
    def fits(c, t, budget=SMEM_LIMIT):
        return (-(-n // t) * c <= MAX_SUMS
                and plan_staging(n, s, c, t, budget) is not None)

    threads = _threads(n, 512)
    bb = next((c for c in (8, 4, 2, 1)
               if (c == 1 or c < 2 * b) and fits(c, threads)), None)
    if bb is None and fits(1, _threads(n, 960)):
        bb, threads = 1, _threads(n, 960)
    if bb is None:
        raise NotImplementedError(
            f"lcc chain kernel: N={n} rows need {2 * n * 4} bytes of shared "
            f"memory per batch column plus a staging ring, above the "
            f"{SMEM_LIMIT}-byte limit (or more than {MAX_SUMS} rows a thread)")
    per_sm = 1  # two blocks of 256 + 64 threads need <= 102 registers each
    if threads > 256 and fits(bb, 256, SM_SMEM // 2 - 1024):
        threads, per_sm = 256, 2
    b_blocks = -(-b // bb)
    want = max(1, sm_count * per_sm // (g * b_blocks))
    spb = -(-e // min(e, want))
    chunks = -(-e // spb)
    return bb, threads, chunks, spb


def launch_staging(n: int, s: int, bb: int, threads: int
                   ) -> tuple[int, int, int]:
    """The staging ring :func:`plan_launch`'s geometry runs with: within
    half an SM's shared memory for its 256-thread blocks (two a SM)."""
    budget = SM_SMEM // 2 - 1024 if threads == 256 else SMEM_LIMIT
    return plan_staging(n, s, bb, threads, budget)


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
    bb, threads, chunks, spb = plan_launch(n, b, g, e, _sm_count[di], s)
    tile, stages, _ = launch_staging(n, s, bb, threads)
    lib = build.load()
    partial = torch.empty((g, chunks, n, b), dtype=torch.float32, device=dev)
    out = torch.empty((g, n, b), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (idx, exp, sign, x, slice_c0, slice_w,
                                   chain_len, partial, out)]
    dims = [e, p, n, s, b, chunks, spb, bb, threads, tile, stages]
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
