// lcc_chain_matmul — one whole FP decomposition (every factor of every
// vertical slice) in one launch:  y[N, B] = sum_e (F_P ... F_1)_e x[c0_e + .].
//
// Replaces `lcc_chain_matmul` / `_kernel` of
// src/repro/kernels/lcc_chain_matmul.py (Pallas TPU, grid (b_blocks, E) that
// revisits one output tile across e).  Bound by the bytes of the term
// streams; design notes are in lcc_chain.cuh, whose body this file
// instantiates with a single group.
#include "lcc_chain.cuh"

extern "C" int repro_lcc_chain_matmul(const void* idx, const void* exp,
                                      const void* sign, const void* x,
                                      const void* slice_c0,
                                      const void* slice_w,
                                      const void* chain_len, void* partial,
                                      void* out, int E, int P, int N, int S,
                                      int B, int C, int spb, int bb,
                                      int threads, int tile, int stages,
                                      void* stream) {
  return repro_torch::launch_chain(idx, exp, sign, x, slice_c0, slice_w,
                                   chain_len, partial, out, /*G=*/1, E, P, N,
                                   S, B, C, spb, bb, threads, tile, stages, stream);
}
