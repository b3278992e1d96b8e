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
// What bounds it on this card.
//  * At decode widths (B = 4..8): bytes.  Every term is read once (int32
//    index + int8 exponent + int8 sign = 6 bytes) and costs one fused
//    multiply-add per batch column; arithmetic is far below the float32 rate.
//  * At wide batches (MLA's uk/uv over the latent view, B = 1024): shared
//    memory.  Every term reads one float32 of the running vector per batch
//    column from shared memory, 4 bytes a multiply-add: at 128 bytes a clock
//    per SM that is far below the float32 rate, so the gathers through shared
//    memory set the floor (about 0.3 ms for uk+uv, PERF.md).
//  * Latency in between: a term's (idx, exp, sign) must arrive before its
//    gather can start, and a factor's rows must all be written before the
//    next factor reads them (one barrier a work item).
//
// What the design does about it.
//  * The running vector never leaves the SM: two [N, BB] float32 buffers in
//    dynamic shared memory ping-pong between factors, stored as planes of
//    four columns so that row gathers and row stores spread over the banks.
//  * The term streams are staged in shared memory by cp.async: a work item is
//    a tile of `tile` rows of one factor (the whole factor where it fits),
//    and a ring of `stages` slots keeps the next items' copies in flight
//    while the block computes the current one, so the only global access on
//    the critical path is the first factor's gather of x[c0 + j].  Two warps
//    of the block issue every copy and compute no row: copies issued by the
//    row threads themselves did not overlap their gathers.  The
//    copies are 16 bytes where the addresses allow; a misaligned stream
//    (possible only when N * S is not a multiple of 16) copies its at most
//    15-byte head and tail with plain loads.
//  * Rows are fixed to threads (thread t owns rows t, t + T, t + 2T, ...).  A
//    thread works two rows a step, their terms interleaved; a term with
//    sign 0 multiplies row 0 by 0 instead of branching, so every load of a
//    step can issue at once.  Each slice's result is folded into per-thread
//    register sums right after its last factor, with no barrier, and
//    `partial` is written once a block.
//  * Geometry (plan_launch, kernels/lcc_chain_matmul.py): 512 threads a block
//    (up to 128 registers a thread), 256 where two blocks then fit an SM;
//    BB (batch columns a block) the widest whose sums and buffers fit; as
//    many slice chunks as one wave of blocks holds.  The column block is the
//    fastest grid axis: the blocks that share a stream (one chunk of one
//    group, all column blocks) run side by side and meet it in L2.
//  * Blocks run in no order, so nothing is accumulated across blocks in place.
//    Block (b, c, g) evaluates slices [c*spb, (c+1)*spb) one after the other,
//    adds them in slice order into its registers, and writes its own row of
//    partial[G, C, N, B]; a second small kernel sums the C partials in fixed
//    order.  No atomics: the result does not depend on scheduling.
//  * chain_len[g, e] is the real chain length: identity padding factors are
//    never executed and a slice of length 0 (missing or all-zero) is skipped.
//  * 2^exp is built from exponent bits, so it is exact.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxDynamicSmem = 232448;  // 227 KB usable per block on sm_90
constexpr int kMaxSums = 32;             // register sums a thread: rows x BB
constexpr int kCopyThreads = 64;         // two warps a block issue the copies

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `pending` of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::); break;
  }
}

// Bytes of one region of a ring slot: the data plus up to 15 bytes of
// alignment offset, rounded to 16.
__host__ __device__ constexpr size_t region_bytes(size_t len) {
  return (len + 16 + 15) / 16 * 16;
}

// Bytes of the two [N, BB] float32 buffers, rounded to 16 (the ring follows).
__host__ __device__ constexpr size_t buffer_bytes(int N, int BB) {
  return (2 * static_cast<size_t>(N) * BB * 4 + 15) / 16 * 16;
}

// Bytes of one ring slot: idx (int32), exp and sign (int8) of `tile` rows.
__host__ __device__ constexpr size_t slot_bytes(int tile, int S) {
  return region_bytes(static_cast<size_t>(tile) * S * 4) +
         2 * region_bytes(static_cast<size_t>(tile) * S);
}

// Copies `len` bytes from global `src` into the region at `dst` (16-byte
// aligned), at offset src % 16 so that the body moves in aligned 16-byte
// cp.async chunks; the head and tail (< 16 bytes each) take plain loads.
__device__ __forceinline__ void stage_bytes(char* dst, const char* src,
                                            size_t len, int tid, int nthreads) {
  const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15u);
  char* const d = dst + mis;
  const size_t head = mis ? (len < 16 - mis ? len : 16 - mis) : 0;
  const size_t body = (len - head) / 16;
  for (size_t k = tid; k < body; k += nthreads)
    cp_async16(d + head + 16 * k, src + head + 16 * k);
  const size_t tail = head + 16 * body;
  if (static_cast<size_t>(tid) < head) d[tid] = src[tid];
  if (tail + tid < len) d[tail + tid] = src[tail + tid];
}

// ------------------------------------------------------------- helpers

// A running-vector buffer holds N rows of BB columns as BB / 4 planes of
// [N][4] floats (BB >= 4), or one [N][BB] plane: a row's 16-byte pieces lie
// 16 bytes apart from the next row's, so neighbouring threads storing
// neighbouring rows hit distinct banks and random gathers spread over all
// 32 banks.
template <int BB>
__device__ __forceinline__ void load_row(const float* buf, int N, int j,
                                         float (&v)[BB]) {
  if constexpr (BB % 4 == 0) {
#pragma unroll
    for (int k = 0; k < BB; k += 4) {
      const float4 t = reinterpret_cast<const float4*>(buf)[(k / 4) * N + j];
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else if constexpr (BB == 2) {
    const float2 t = reinterpret_cast<const float2*>(buf)[j];
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = buf[j];
  }
}

template <int BB>
__device__ __forceinline__ void store_row(float* buf, int N, int j,
                                          const float (&v)[BB]) {
  if constexpr (BB % 4 == 0) {
#pragma unroll
    for (int k = 0; k < BB; k += 4)
      reinterpret_cast<float4*>(buf)[(k / 4) * N + j] =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (BB == 2) {
    reinterpret_cast<float2*>(buf)[j] = make_float2(v[0], v[1]);
  } else {
    buf[j] = v[0];
  }
}

// sign in {-1, +1}, exp in [-126, 127]:  sign * 2^exp, exact.
__device__ __forceinline__ float signed_pow2(int sign, int exp) {
  const unsigned bits = (static_cast<unsigned>(exp + 127) << 23) |
                        (sign < 0 ? 0x80000000u : 0u);
  return __uint_as_float(bits);
}

// One work item: tile q of factor p of slice e.  e == e1 marks the end.
struct Item {
  int e, p, q, len;
};

// Moves `it` to factor 0, tile 0 of the first live slice after it.e.
__device__ __forceinline__ void next_slice(Item& it, int e1,
                                           const int32_t* __restrict__ len_g) {
  it.p = 0;
  it.q = 0;
  while (++it.e < e1) {
    it.len = __ldg(len_g + it.e);
    if (it.len > 0) return;
  }
}

__device__ __forceinline__ void advance(Item& it, int nq, int e1,
                                        const int32_t* __restrict__ len_g) {
  if (++it.q < nq) return;
  it.q = 0;
  if (++it.p < it.len) return;
  next_slice(it, e1, len_g);
}

// Issues the copies of item `it` into ring slot `slot`.
__device__ __forceinline__ void stage_item(
    const Item& it, char* slot, const int32_t* __restrict__ idx,
    const int8_t* __restrict__ exp, const int8_t* __restrict__ sign, int g,
    int E, int P, int N, int S, int tile, int tid, int nthreads) {
  const int r0 = it.q * tile;
  const int rows = min(tile, N - r0);
  const size_t t0 =
      ((static_cast<size_t>(g) * E + it.e) * P + it.p) * N * S +
      static_cast<size_t>(r0) * S;
  const size_t nt = static_cast<size_t>(rows) * S;
  const size_t ri = region_bytes(static_cast<size_t>(tile) * S * 4);
  const size_t rb = region_bytes(static_cast<size_t>(tile) * S);
  stage_bytes(slot, reinterpret_cast<const char*>(idx + t0), nt * 4, tid,
              nthreads);
  stage_bytes(slot + ri, reinterpret_cast<const char*>(exp + t0), nt, tid,
              nthreads);
  stage_bytes(slot + ri + rb, reinterpret_cast<const char*>(sign + t0), nt,
              tid, nthreads);
}

// ------------------------------------------------------------- the body

// grid (ceil(B / BB), C, G), threads + kCopyThreads <= MAXT threads: `threads`
// own the rows, the last two warps issue the copies; dynamic shared memory
// buffer_bytes(N, BB) + stages * slot_bytes(tile, S).  MAXR >= ceil(N /
// threads) rows a thread; tile is a multiple of `threads` (or covers N).
template <int BB, int MAXR, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
lcc_chain_kernel(const int32_t* __restrict__ idx,
                 const int8_t* __restrict__ exp,
                 const int8_t* __restrict__ sign,
                 const float* __restrict__ x,          // [K, B]
                 const int32_t* __restrict__ slice_c0,  // [G, E] first x row
                 const int32_t* __restrict__ slice_w,   // [G, E] slice width
                 const int32_t* __restrict__ chain_len, // [G, E] real factors
                 float* __restrict__ partial,           // [G, C, N, B]
                 int E, int P, int N, int S, int B, int C, int spb, int tile,
                 int stages) {
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + static_cast<size_t>(N) * BB;
  char* const ring = reinterpret_cast<char*>(smem) + buffer_bytes(N, BB);
  const size_t sbytes = slot_bytes(tile, S);
  const size_t ri = region_bytes(static_cast<size_t>(tile) * S * 4);
  const size_t rb = region_bytes(static_cast<size_t>(tile) * S);

  const int b0 = blockIdx.x * BB;
  const int c = blockIdx.y;
  const int g = blockIdx.z;
  const int tid = threadIdx.x;
  const int T = blockDim.x - kCopyThreads;  // row threads; then the copiers
  const bool copier = tid >= T;
  const int e0 = c * spb;
  const int e1 = min(E, e0 + spb);
  const int nq = (N + tile - 1) / tile;
  const int32_t* const len_g = chain_len + static_cast<size_t>(g) * E;
  // the batch columns of this block are whole and 16-byte aligned in x
  const bool x_vec = (BB % 4 == 0) && (B % 4 == 0) && (b0 + BB <= B);

  float sums[MAXR][BB];
#pragma unroll
  for (int i = 0; i < MAXR; ++i)
#pragma unroll
    for (int k = 0; k < BB; ++k) sums[i][k] = 0.0f;

  // prologue: items 0 .. stages-2 in flight
  Item pf{e0 - 1, 0, 0, 0};
  next_slice(pf, e1, len_g);
  Item cur = pf;
  for (int s = 0; s < stages - 1; ++s) {
    if (pf.e < e1) {
      if (copier)
        stage_item(pf, ring + s * sbytes, idx, exp, sign, g, E, P, N, S, tile,
                   tid - T, kCopyThreads);
      advance(pf, nq, e1, len_g);
    }
    cp_async_commit();
  }

  for (int i = 0; cur.e < e1; ++i) {
    // the copy warps' copies of item i have landed; the barrier makes them
    // visible, ends every read of item i-1 (so its slot may be refilled)
    // and every write of the factor before.  The row threads issue no
    // copies, so their wait returns at once
    cp_async_wait(stages - 2);
    __syncthreads();
    if (pf.e < e1) {
      if (copier)
        stage_item(pf, ring + ((i + stages - 1) % stages) * sbytes, idx, exp,
                   sign, g, E, P, N, S, tile, tid - T, kCopyThreads);
      advance(pf, nq, e1, len_g);
    }
    cp_async_commit();

    const char* const slot = ring + (i % stages) * sbytes;
    const int r0 = cur.q * tile;
    const int rows = min(tile, N - r0);
    const size_t t0 =
        ((static_cast<size_t>(g) * E + cur.e) * P + cur.p) * N * S +
        static_cast<size_t>(r0) * S;
    // where stage_bytes put each stream in the slot
    const int32_t* const s_idx = reinterpret_cast<const int32_t*>(
        slot + (reinterpret_cast<uintptr_t>(idx + t0) & 15u));
    const int8_t* const s_exp = reinterpret_cast<const int8_t*>(
        slot + ri + (reinterpret_cast<uintptr_t>(exp + t0) & 15u));
    const int8_t* const s_sign = reinterpret_cast<const int8_t*>(
        slot + ri + rb + (reinterpret_cast<uintptr_t>(sign + t0) & 15u));
    const int p = cur.p;
    const float* const src = (p & 1) ? buf0 : buf1;
    float* const dst = (p & 1) ? buf1 : buf0;
    int c0 = 0, w = 0;
    if (p == 0) {
      const int ge = g * E + cur.e;
      c0 = __ldg(slice_c0 + ge);
      w = __ldg(slice_w + ge);
    }
    // one term: acc += sign * 2^exp * (x[c0 + j] or src[j]).  A term with
    // sign 0 adds coef 0 times the row at index 0, so every load can issue
    // before any sign is known (fma(0, v, acc) == acc for finite v)
    auto term = [&](int sg, int j, int ex, float (&acc)[BB]) {
      const float coef = sg ? signed_pow2(sg, ex) : 0.0f;
      j = sg ? j : 0;
      float v[BB];
      if (p == 0) {
        const bool in = j < w;
        const float* const xr = x + static_cast<size_t>(c0 + (in ? j : 0)) * B + b0;
        if (x_vec) {
#pragma unroll
          for (int k = 0; k < BB; k += 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(xr + k));
            v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < BB; ++k)
            v[k] = (b0 + k < B) ? __ldg(xr + k) : 0.0f;
        }
        if (!in) {
#pragma unroll
          for (int k = 0; k < BB; ++k) v[k] = 0.0f;
        }
      } else {
        load_row<BB>(src, N, j, v);
      }
#pragma unroll
      for (int k = 0; k < BB; ++k) acc[k] = fmaf(coef, v[k], acc[k]);
    };
    const bool pair = S == 2 &&
        ((reinterpret_cast<uintptr_t>(s_idx) | reinterpret_cast<uintptr_t>(s_exp) |
          reinterpret_cast<uintptr_t>(s_sign)) & 1u) == 0 &&
        (reinterpret_cast<uintptr_t>(s_idx) & 7u) == 0;
    // two rows a step, their terms interleaved
    for (int r = copier ? rows : tid; r < rows; r += 2 * T) {
      const int r2 = r + T;
      const bool two = r2 < rows;
      float a0[BB], a1[BB];
#pragma unroll
      for (int k = 0; k < BB; ++k) { a0[k] = 0.0f; a1[k] = 0.0f; }
      if (pair) {
        const int2 j0 = reinterpret_cast<const int2*>(s_idx)[r];
        const char2 e0 = reinterpret_cast<const char2*>(s_exp)[r];
        const char2 g0 = reinterpret_cast<const char2*>(s_sign)[r];
        int2 j1 = make_int2(0, 0);
        char2 e1 = make_char2(0, 0), g1 = make_char2(0, 0);
        if (two) {
          j1 = reinterpret_cast<const int2*>(s_idx)[r2];
          e1 = reinterpret_cast<const char2*>(s_exp)[r2];
          g1 = reinterpret_cast<const char2*>(s_sign)[r2];
        }
        term(g0.x, j0.x, e0.x, a0);
        term(g1.x, j1.x, e1.x, a1);
        term(g0.y, j0.y, e0.y, a0);
        term(g1.y, j1.y, e1.y, a1);
      } else {
        for (int s = 0; s < S; ++s) {
          term(s_sign[r * S + s], s_idx[r * S + s], s_exp[r * S + s], a0);
          if (two)
            term(s_sign[r2 * S + s], s_idx[r2 * S + s], s_exp[r2 * S + s], a1);
        }
      }
      store_row<BB>(dst, N, r0 + r, a0);
      if (two) store_row<BB>(dst, N, r0 + r2, a1);
    }
    if (cur.p == cur.len - 1 && cur.q == nq - 1) {
      // the slice is done: fold its rows into the sums; every row was
      // written by the thread that owns it, so no barrier is needed
#pragma unroll
      for (int ri2 = 0; ri2 < MAXR; ++ri2) {
        const int n = ri2 * T + tid;
        if (!copier && n < N) {
          float v[BB];
          load_row<BB>(dst, N, n, v);
#pragma unroll
          for (int k = 0; k < BB; ++k) sums[ri2][k] += v[k];
        }
      }
    }
    advance(cur, nq, e1, len_g);
  }
  cp_async_wait(0);

  float* const out = partial + (static_cast<size_t>(g) * C + c) * N * B + b0;
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int n = i * T + tid;
    if (!copier && n < N) {
      float* const o = out + static_cast<size_t>(n) * B;
#pragma unroll
      for (int k = 0; k < BB; ++k)
        if (b0 + k < B) o[k] = sums[i][k];
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

template <int BB, int MAXR, int MAXT>
inline cudaError_t launch_chain_bb(const int32_t* idx, const int8_t* exp,
                                   const int8_t* sign, const float* x,
                                   const int32_t* slice_c0,
                                   const int32_t* slice_w,
                                   const int32_t* chain_len, float* partial,
                                   int G, int E, int P, int N, int S, int B,
                                   int C, int spb, int threads, int tile,
                                   int stages, cudaStream_t stream) {
  const size_t smem = buffer_bytes(N, BB) +
                      static_cast<size_t>(stages) * slot_bytes(tile, S);
  if (smem > static_cast<size_t>(kMaxDynamicSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lcc_chain_kernel<BB, MAXR, MAXT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BB - 1) / BB, C, G);
  lcc_chain_kernel<BB, MAXR, MAXT>
      <<<grid, threads + kCopyThreads, smem, stream>>>(
      idx, exp, sign, x, slice_c0, slice_w, chain_len, partial, E, P, N, S, B,
      C, spb, tile, stages);
  return cudaGetLastError();
}

// The register sums of the body: MAXR rows of BB columns, the smaller of
// 16 and 32 floats that holds ceil(N / threads) rows.  Blocks have at most
// 512 row threads and the copy warps (up to 113 registers a thread), except
// one column a block at N above 16384 rows, which takes up to 960 row
// threads (64 registers a thread).
template <int BB>
inline cudaError_t launch_chain_rows(const int32_t* idx, const int8_t* exp,
                                     const int8_t* sign, const float* x,
                                     const int32_t* c0, const int32_t* w,
                                     const int32_t* len, float* part, int G,
                                     int E, int P, int N, int S, int B, int C,
                                     int spb, int threads, int tile,
                                     int stages, cudaStream_t st) {
  const int rpt = (N + threads - 1) / threads;
  if (threads > 512) {
    if constexpr (BB == 1) {
      if (rpt <= kMaxSums)
        return launch_chain_bb<1, kMaxSums, 1024>(
            idx, exp, sign, x, c0, w, len, part, G, E, P, N, S, B, C, spb,
            threads, tile, stages, st);
    }
    return cudaErrorInvalidValue;
  }
  if (rpt * BB <= kMaxSums / 2)
    return launch_chain_bb<BB, kMaxSums / 2 / BB, 512 + kCopyThreads>(
        idx, exp, sign, x, c0, w, len, part, G, E, P, N, S, B, C, spb,
        threads, tile, stages, st);
  if (rpt * BB <= kMaxSums)
    return launch_chain_bb<BB, kMaxSums / BB, 512 + kCopyThreads>(
        idx, exp, sign, x, c0, w, len, part, G, E, P, N, S, B, C, spb,
        threads, tile, stages, st);
  return cudaErrorInvalidValue;
}

// Chain kernel followed by the fixed-order reduction, both on `stream`.
// Returns the first CUDA error (0 = both launches accepted).
inline int launch_chain(const void* idx, const void* exp, const void* sign,
                        const void* x, const void* slice_c0,
                        const void* slice_w, const void* chain_len,
                        void* partial, void* out, int G, int E, int P, int N,
                        int S, int B, int C, int spb, int bb, int threads,
                        int tile, int stages, void* stream) {
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* ex = static_cast<const int8_t*>(exp);
  const auto* sg = static_cast<const int8_t*>(sign);
  const auto* xf = static_cast<const float*>(x);
  const auto* c0 = static_cast<const int32_t*>(slice_c0);
  const auto* w = static_cast<const int32_t*>(slice_w);
  const auto* len = static_cast<const int32_t*>(chain_len);
  auto* part = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  // the ring needs 2..4 slots; a tile is whole rows of every thread (or N)
  if (G <= 0 || E <= 0 || N <= 0 || S <= 0 || B <= 0 || C <= 0 || spb <= 0 ||
      threads <= 0 || threads + kCopyThreads > 1024 || threads % 32 != 0 ||
      tile <= 0 ||
      (tile < N && tile % threads != 0) || stages < 2 || stages > 4 ||
      G > 65535 || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (bb) {
    case 8: err = launch_chain_rows<8>(i, ex, sg, xf, c0, w, len, part, G, E, P, N, S, B, C, spb, threads, tile, stages, st); break;
    case 4: err = launch_chain_rows<4>(i, ex, sg, xf, c0, w, len, part, G, E, P, N, S, B, C, spb, threads, tile, stages, st); break;
    case 2: err = launch_chain_rows<2>(i, ex, sg, xf, c0, w, len, part, G, E, P, N, S, B, C, spb, threads, tile, stages, st); break;
    case 1: err = launch_chain_rows<1>(i, ex, sg, xf, c0, w, len, part, G, E, P, N, S, B, C, spb, threads, tile, stages, st); break;
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
