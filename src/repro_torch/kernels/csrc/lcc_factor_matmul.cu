// lcc_factor_matmul — one LCC factor applied to a batch of columns (K4):
//   y[n, b] = sum_s sign[n, s] * 2^exp[n, s] * x[idx[n, s], b].
//
// Replaces `lcc_factor_matmul` / `_kernel` of src/repro/kernels/lcc_matmul.py
// (Pallas TPU: a grid over (n, k, b) tiles; each step decompresses a one-hot
// [bn, bk] tile of F = sum_s sign * 2^exp * [idx == k] and feeds it to the
// matrix unit, the output tile revisited across the k axis).  On Hopper a
// factor row holds at most S nonzeros, so the product is a row gather: no k
// tiling, no dense tile, no matrix unit.
//
// Bound by bytes on this card: the streams (4 + 1 + 1 bytes a term, read
// once per row), x's gathered rows and y written once.  Each term is one
// multiply-add a column; at B = 8 the card could do ~20 of them for every
// byte it reads, so the operations never bound it.
//
// What the design does about it.
//  * One thread per (row, batch column), neighbouring threads on neighbouring
//    columns of the same row: the row's S (idx, exp, sign) triples are read
//    once per warp (broadcast) and the gathered x row is one contiguous run.
//  * The terms are summed in slot order s = 0, 1, ..., S-1, starting from 0,
//    and a slot with sign 0 adds nothing: the same sum the plain version
//    takes, so on inputs whose products and sums are exact the two agree bit
//    for bit.  No atomics.
//  * 2^exp is built from the exponent bits ((exp + 127) << 23; the streams'
//    exponents are checked to lie in [-126, 127] when they are uploaded), never
//    with exp2f, and the product and the add are rounded separately
//    (__fmul_rn / __fadd_rn), as the plain version rounds them.
//  * x may be float32 or bfloat16 (x_bf16 = 1); the sum is float32 either way.
//  * A live term whose idx lies outside [0, K) is skipped, never read: the
//    per-factor route validates every index when the streams are uploaded.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_x(const void* x, size_t i, int x_bf16) {
  if (x_bf16) {
    const uint16_t bits = static_cast<const uint16_t*>(x)[i];
    return __uint_as_float(static_cast<uint32_t>(bits) << 16);
  }
  return static_cast<const float*>(x)[i];
}

__global__ void lcc_factor_kernel(const int32_t* __restrict__ idx,
                                  const int8_t* __restrict__ exp,
                                  const int8_t* __restrict__ sign,
                                  const void* __restrict__ x,
                                  float* __restrict__ out, int N, int S, int K,
                                  int B, int x_bf16) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(N) * B) return;
  const int n = static_cast<int>(i / B);
  const int b = static_cast<int>(i - static_cast<size_t>(n) * B);
  const size_t row = static_cast<size_t>(n) * S;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int sg = sign[row + s];
    const int k = idx[row + s];
    if (sg == 0 || k < 0 || k >= K) continue;
    const float p2 = __int_as_float((static_cast<int>(exp[row + s]) + 127) << 23);
    const float coef = sg > 0 ? p2 : -p2;
    acc = __fadd_rn(acc, __fmul_rn(coef, load_x(x, static_cast<size_t>(k) * B + b,
                                                 x_bf16)));
  }
  out[i] = acc;
}

}  // namespace

extern "C" int repro_lcc_factor_matmul(const void* idx, const void* exp,
                                       const void* sign, const void* x,
                                       void* out, int N, int S, int K, int B,
                                       int x_bf16, void* stream) {
  if (N <= 0 || S <= 0 || K <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(N) * B;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  lcc_factor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int8_t*>(exp),
      static_cast<const int8_t*>(sign), x, static_cast<float*>(out), N, S, K, B,
      x_bf16);
  return static_cast<int>(cudaGetLastError());
}
