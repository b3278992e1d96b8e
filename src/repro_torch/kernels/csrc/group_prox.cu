// group_prox — the group-lasso proximal operator (paper eq. (8)), row-wise
// block soft threshold over a [G, M] view:
//   out_i = max(1 - t / ||a_i||_2, 0) * a_i,   rows with ||a_i|| = 0 -> 0.
//
// Replaces `group_prox` / `_kernel` of src/repro/kernels/group_prox.py
// (Pallas TPU: a grid over blocks of whole rows held in VMEM, G padded to a
// block multiple).  It runs once per regularized leaf per ProxSGD step.
//
// Bound by bytes: each weight is read once and written once, with three
// operations a weight (square-add, multiply).  The design keeps that one
// pass: a row is reduced and scaled by the threads that loaded it, and its
// values stay in registers in between —
//   * M <= 2048: one warp a row (8 rows a block of 256 threads), up to 64
//     values a lane;
//   * M > 2048: one block of 512 threads a row, up to 32 values a thread, so
//     rows up to 16384 (the widest site of the port) are read once.  Longer
//     rows keep the first 16384 values in registers and read the rest a
//     second time in the scale pass.
// Loads and stores are 16 bytes a thread (4 float or 8 bf16) when the row
// length and both pointers allow; otherwise element by element.  The sum of
// squares is float32: each thread sums its own values in a fixed order, a
// xor butterfly sums the warp, and a block sums its warps' partials in warp
// order — no atomics, so the result is the same bit for bit from run to run.
// Every row is read whole before any of it is written, and only by the
// threads that write it, so `out` may be `a` (in place).  No padding: any G,
// through a grid-stride loop over rows; offsets are formed in 64 bits.
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* y) {
  *y = __float2bfloat16_rn(x);
}

// One unit = U consecutive elements: 16 bytes, or a single element.
template <typename T, int U>
__device__ __forceinline__ void load_unit(const T* p, float (&f)[U]) {
  if constexpr (U == 1) {
    f[0] = to_f(p[0]);
  } else {
    alignas(16) T e[U];
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < U; ++i) f[i] = to_f(e[i]);
  }
}

template <typename T, int U>
__device__ __forceinline__ void store_unit(T* p, const float (&f)[U],
                                           float scale) {
  if constexpr (U == 1) {
    from_f(scale * f[0], p);
  } else {
    alignas(16) T e[U];
#pragma unroll
    for (int i = 0; i < U; ++i) from_f(scale * f[i], &e[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same, order-fixed sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TPR threads a row (32: a warp a row, 8 rows a block; else the whole block);
// CACHE_F values a thread stay in registers; VEC: 16-byte units.
template <typename T, int TPR, int CACHE_F, bool VEC>
__global__ void __launch_bounds__(TPR == 32 ? 256 : TPR)
    group_prox_kernel(const T* a, T* out, long long G, int M, float t) {
  constexpr int U = VEC ? static_cast<int>(16 / sizeof(T)) : 1;
  constexpr int C = CACHE_F / U;  // units a thread keeps in registers
  constexpr int RPB = TPR == 32 ? 8 : 1;  // rows a block
  constexpr int NW = TPR / 32;  // warps a row
  __shared__ float partial[NW];
  const int lane = TPR == 32 ? static_cast<int>(threadIdx.x & 31)
                             : static_cast<int>(threadIdx.x);
  const int sub = TPR == 32 ? static_cast<int>(threadIdx.x >> 5) : 0;
  const int n_units = M / U;
  for (long long row = static_cast<long long>(blockIdx.x) * RPB + sub;
       row < G; row += static_cast<long long>(gridDim.x) * RPB) {
    const T* src = a + row * M;
    T* dst = out + row * M;
    float cache[C][U];
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = lane + c * TPR;
      if (u < n_units) {
        load_unit<T, U>(src + static_cast<size_t>(u) * U, cache[c]);
#pragma unroll
        for (int i = 0; i < U; ++i) ss += cache[c][i] * cache[c][i];
      }
    }
    for (int u = lane + C * TPR; u < n_units; u += TPR) {  // beyond the cache
      float f[U];
      load_unit<T, U>(src + static_cast<size_t>(u) * U, f);
#pragma unroll
      for (int i = 0; i < U; ++i) ss += f[i] * f[i];
    }
    ss = warp_sum(ss);
    if constexpr (NW > 1) {
      if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
      __syncthreads();
      float tot = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) tot += partial[w];  // warp order, every thread
      ss = tot;
      __syncthreads();  // the next row may overwrite `partial`
    }
    const float norm = sqrtf(ss);
    const float scale =
        norm > 0.0f ? fmaxf(1.0f - t / fmaxf(norm, 1e-12f), 0.0f) : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = lane + c * TPR;
      if (u < n_units)
        store_unit<T, U>(dst + static_cast<size_t>(u) * U, cache[c], scale);
    }
    for (int u = lane + C * TPR; u < n_units; u += TPR) {  // second read
      float f[U];
      load_unit<T, U>(src + static_cast<size_t>(u) * U, f);
      store_unit<T, U>(dst + static_cast<size_t>(u) * U, f, scale);
    }
  }
}

constexpr int kWarpMaxM = 2048;  // a warp a row up to here
constexpr int kRowThreads = 512;  // a block a row above

template <typename T, bool VEC>
void launch(const T* a, T* out, long long G, int M, float t,
            cudaStream_t stream) {
  const long long max_blocks = 1LL << 24;  // grid-stride beyond this
  if (M <= kWarpMaxM) {
    long long blocks = (G + 7) / 8;
    if (blocks > max_blocks) blocks = max_blocks;
    group_prox_kernel<T, 32, 64, VEC>
        <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a, out, G, M, t);
  } else {
    long long blocks = G < max_blocks ? G : max_blocks;
    group_prox_kernel<T, kRowThreads, 32, VEC>
        <<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(a, out, G,
                                                                    M, t);
  }
}

template <typename T>
void dispatch_vec(const void* a, void* out, long long G, int M, float t,
                  cudaStream_t stream) {
  constexpr int U = static_cast<int>(16 / sizeof(T));
  const bool aligned = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned && M % U == 0)
    launch<T, true>(static_cast<const T*>(a), static_cast<T*>(out), G, M, t,
                    stream);
  else
    launch<T, false>(static_cast<const T*>(a), static_cast<T*>(out), G, M, t,
                     stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a and out are contiguous [G, M]; out
// may equal a.  Returns the CUDA error of the launch (0 = launched).
extern "C" int repro_group_prox(const void* a, void* out, long long G, int M,
                                float t, int dtype, void* stream) {
  if (G <= 0 || M <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch_vec<float>(a, out, G, M, t, s);
  else
    dispatch_vec<__nv_bfloat16>(a, out, G, M, t, s);
  return static_cast<int>(cudaGetLastError());
}
