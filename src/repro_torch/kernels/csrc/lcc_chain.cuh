// Whole-chain LCC evaluation on Hopper (sm_90a) — device body shared by the
// single-decomposition launch (lcc_chain_matmul.cu) and the grouped launch
// (lcc_group_matmul.cu).
//
// Replaces the Pallas TPU kernel body `_kernel` of
// src/repro/kernels/lcc_chain_matmul.py (also used, with a leading group axis,
// by src/repro/kernels/lcc_group_matmul.py).
//
// What it computes.  For group g:  out[g] = sum_e chain_{g,e}(x_slice_{g,e}),
// where row n of factor p is  sum_s sign * 2^exp * prev[idx[n, s]].
//
// What bounds it on this card: bytes.  Every term is read once (int32 index +
// int8 exponent + int8 sign = 6 bytes) and costs one fused multiply-add per
// batch column, so at decode batch widths the (idx, exp, sign) streams set the
// time; arithmetic is far below the float32 rate.
//
// What the design does about it.
//  * The running vector never leaves the SM: two [N, BB] float32 buffers in
//    dynamic shared memory ping-pong between factors.  BB (batch columns per
//    block) is the widest of 8/4/2/1 for which both buffers fit in 227 KB, so
//    N = 2048 runs BB = 8 and N = 8192 runs BB = 2 (the streams of one slice
//    are then re-read by the b-blocks of that slice, from L2).
//  * The first factor reads its slice's rows straight from x[c0 + idx]; no
//    padded [E, D_pad, B_pad] copy of the input is ever built.
//  * Blocks run in no order, so nothing is accumulated across blocks in place.
//    Block (c, g, b) evaluates slices [c*spb, (c+1)*spb) one after the other
//    and accumulates them, in slice order, into its own row of
//    partial[G, C, N, B]; a second small kernel sums the C partials in fixed
//    order.  No atomics: the result does not depend on scheduling.
//  * chain_len[g, e] is the real chain length: identity padding factors are
//    never executed, a slice of length 0 (missing or all-zero) is skipped, and
//    a term with sign == 0 is skipped before its index is touched.
//  * 2^exp is built from exponent bits, so it is exact.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxDynamicSmem = 232448;  // 227 KB usable per block on sm_90

template <int BB>
__device__ __forceinline__ void load_row(const float* p, float (&v)[BB]) {
  if constexpr (BB % 4 == 0) {
#pragma unroll
    for (int k = 0; k < BB; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else if constexpr (BB == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < BB; ++k) v[k] = p[k];
  }
}

template <int BB>
__device__ __forceinline__ void store_row(float* p, const float (&v)[BB]) {
  if constexpr (BB % 4 == 0) {
#pragma unroll
    for (int k = 0; k < BB; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (BB == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < BB; ++k) p[k] = v[k];
  }
}

// sign in {-1, +1}, exp in [-126, 127]:  sign * 2^exp, exact.
__device__ __forceinline__ float signed_pow2(int sign, int exp) {
  const unsigned bits = (static_cast<unsigned>(exp + 127) << 23) |
                        (sign < 0 ? 0x80000000u : 0u);
  return __uint_as_float(bits);
}

// grid (C, G, ceil(B / BB)); dynamic shared memory 2 * N * BB floats.
template <int BB>
__global__ void __launch_bounds__(1024, 1)
lcc_chain_kernel(const int32_t* __restrict__ idx,
                 const int8_t* __restrict__ exp,
                 const int8_t* __restrict__ sign,
                 const float* __restrict__ x,          // [K, B]
                 const int32_t* __restrict__ slice_c0,  // [G, E] first x row
                 const int32_t* __restrict__ slice_w,   // [G, E] slice width
                 const int32_t* __restrict__ chain_len, // [G, E] real factors
                 float* __restrict__ partial,           // [G, C, N, B]
                 int E, int P, int N, int S, int B, int C, int spb) {
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + static_cast<size_t>(N) * BB;

  const int c = blockIdx.x;
  const int g = blockIdx.y;
  const int b0 = blockIdx.z * BB;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int e0 = c * spb;
  const int e1 = min(E, e0 + spb);
  float* const out = partial + (static_cast<size_t>(g) * C + c) * N * B + b0;

  bool wrote = false;  // uniform over the block; each thread owns its rows
  for (int e = e0; e < e1; ++e) {
    const int ge = g * E + e;
    const int len = chain_len[ge];
    if (len <= 0) continue;
    const int c0 = slice_c0[ge];
    const int w = slice_w[ge];
    for (int p = 0; p < len; ++p) {
      const size_t base = (static_cast<size_t>(ge) * P + p) * N * S;
      const float* const src = (p & 1) ? buf0 : buf1;
      float* const dst = (p & 1) ? buf1 : buf0;
      const bool last = (p == len - 1);
      for (int n = tid; n < N; n += nthreads) {
        float acc[BB];
#pragma unroll
        for (int k = 0; k < BB; ++k) acc[k] = 0.0f;
        const size_t t0 = base + static_cast<size_t>(n) * S;
        for (int s = 0; s < S; ++s) {
          const int sg = sign[t0 + s];
          if (sg == 0) continue;
          const int j = idx[t0 + s];
          const float coef = signed_pow2(sg, exp[t0 + s]);
          float v[BB];
          if (p == 0) {
            if (j < w) {
              const float* const r = x + static_cast<size_t>(c0 + j) * B + b0;
#pragma unroll
              for (int k = 0; k < BB; ++k) v[k] = (b0 + k < B) ? r[k] : 0.0f;
            } else {
#pragma unroll
              for (int k = 0; k < BB; ++k) v[k] = 0.0f;
            }
          } else {
            load_row<BB>(src + static_cast<size_t>(j) * BB, v);
          }
#pragma unroll
          for (int k = 0; k < BB; ++k) acc[k] = fmaf(coef, v[k], acc[k]);
        }
        if (last) {
          float* const o = out + static_cast<size_t>(n) * B;
#pragma unroll
          for (int k = 0; k < BB; ++k)
            if (b0 + k < B) o[k] = wrote ? o[k] + acc[k] : acc[k];
        } else {
          store_row<BB>(dst + static_cast<size_t>(n) * BB, acc);
        }
      }
      __syncthreads();
    }
    wrote = true;
  }
  if (!wrote) {
    for (int n = tid; n < N; n += nthreads) {
      float* const o = out + static_cast<size_t>(n) * B;
#pragma unroll
      for (int k = 0; k < BB; ++k)
        if (b0 + k < B) o[k] = 0.0f;
    }
  }
}

// out[g, r] = sum_c partial[g, c, r], c ascending; r runs over N * B.
static __global__ void lcc_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int G, int C,
                                  size_t nb) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(G) * nb) return;
  const size_t g = i / nb;
  const size_t r = i - g * nb;
  const float* p = partial + g * C * nb + r;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) acc += p[static_cast<size_t>(c) * nb];
  out[i] = acc;
}

template <int BB>
inline cudaError_t launch_chain_bb(const int32_t* idx, const int8_t* exp,
                                   const int8_t* sign, const float* x,
                                   const int32_t* slice_c0,
                                   const int32_t* slice_w,
                                   const int32_t* chain_len, float* partial,
                                   int G, int E, int P, int N, int S, int B,
                                   int C, int spb, int threads,
                                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(N) * BB * sizeof(float);
  if (smem > static_cast<size_t>(kMaxDynamicSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lcc_chain_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(C, G, (B + BB - 1) / BB);
  lcc_chain_kernel<BB><<<grid, threads, smem, stream>>>(
      idx, exp, sign, x, slice_c0, slice_w, chain_len, partial, E, P, N, S, B,
      C, spb);
  return cudaGetLastError();
}

// Chain kernel followed by the fixed-order reduction, both on `stream`.
// Returns the first CUDA error (0 = both launches accepted).
inline int launch_chain(const void* idx, const void* exp, const void* sign,
                        const void* x, const void* slice_c0,
                        const void* slice_w, const void* chain_len,
                        void* partial, void* out, int G, int E, int P, int N,
                        int S, int B, int C, int spb, int bb, int threads,
                        void* stream) {
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* ex = static_cast<const int8_t*>(exp);
  const auto* sg = static_cast<const int8_t*>(sign);
  const auto* xf = static_cast<const float*>(x);
  const auto* c0 = static_cast<const int32_t*>(slice_c0);
  const auto* w = static_cast<const int32_t*>(slice_w);
  const auto* len = static_cast<const int32_t*>(chain_len);
  auto* part = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  if (G <= 0 || E <= 0 || N <= 0 || B <= 0 || C <= 0 || spb <= 0 ||
      threads <= 0 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (bb) {
    case 8: err = launch_chain_bb<8>(i, ex, sg, xf, c0, w, len, part, G, E, P, N, S, B, C, spb, threads, st); break;
    case 4: err = launch_chain_bb<4>(i, ex, sg, xf, c0, w, len, part, G, E, P, N, S, B, C, spb, threads, st); break;
    case 2: err = launch_chain_bb<2>(i, ex, sg, xf, c0, w, len, part, G, E, P, N, S, B, C, spb, threads, st); break;
    case 1: err = launch_chain_bb<1>(i, ex, sg, xf, c0, w, len, part, G, E, P, N, S, B, C, spb, threads, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t nb = static_cast<size_t>(N) * B;
  const size_t total = static_cast<size_t>(G) * nb;
  const int rthreads = 256;
  const unsigned rblocks = static_cast<unsigned>((total + rthreads - 1) / rthreads);
  lcc_reduce_kernel<<<rblocks, rthreads, 0, st>>>(
      part, static_cast<float*>(out), G, C, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
