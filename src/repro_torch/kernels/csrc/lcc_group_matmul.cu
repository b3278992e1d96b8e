// lcc_group_matmul — G whole decompositions (attention q/k/v, SwiGLU gate/up)
// in one launch:  out[g] = sum_e chain_{g,e}(x[c0_{g,e} + .]).
//
// Replaces `lcc_group_matmul` of src/repro/kernels/lcc_group_matmul.py
// (Pallas TPU, grid (G, b_blocks, E), body shared with lcc_chain_matmul).
// The members read one concatenated input x [sum_g K_g, B] through their own
// slice offsets, so no padded [G, E, D_pad, B_pad] stack is built.  Bound by
// the bytes of the term streams; design notes are in lcc_chain.cuh.  Slices a
// member does not have carry chain_len == 0 and cost one integer read.
#include "lcc_chain.cuh"

extern "C" int repro_lcc_group_matmul(const void* idx, const void* exp,
                                      const void* sign, const void* x,
                                      const void* slice_c0,
                                      const void* slice_w,
                                      const void* chain_len, void* partial,
                                      void* out, int G, int E, int P, int N,
                                      int S, int B, int C, int spb, int bb,
                                      int threads, int tile, int stages,
                                      void* stream) {
  return repro_torch::launch_chain(idx, exp, sign, x, slice_c0, slice_w,
                                   chain_len, partial, out, G, E, P, N, S, B,
                                   C, spb, bb, threads, tile, stages, stream);
}
