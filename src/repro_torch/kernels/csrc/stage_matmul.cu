// stage_matmul — one layer-plan stage on Hopper (sm_90a): every compressed
// site that reads one activation (q+k+v, gate+up, o, down) evaluated as one
// set of shift-add streams, src [D_src, B] -> out [O, B], for nl layers.
//
// Replaces the Pallas TPU kernel `stage_matmul` (body `_stage_apply` /
// `_stage_apply_seg`) of src/repro/kernels/layer_plan.py, and the stage
// evaluations inside `step_plan_matmul` there.
//
// What it computes, per layer (the PackedStage contract of kernels/ops.py):
//   prep      inbuf[t] = sum of src[s'] over the pairs (s', t)
//   levels    work[r]  = sum_s sign * 2^exp * buf[gidx[p, r, s]]; level 0 reads
//             inbuf, later levels read the previous level's rows
//   epilogue  out[o]   = resid[o] + (((sum_j work[outg[j, o]]) + fs_mat @ inbuf)
//                         + dw_mat @ src) + bias[o]      (index R = zero row)
//
// Bound by bytes on this card.  Every live term is read once (int32
// index + int8 exponent + int8 sign = 6 bytes) for one fused multiply-add per
// batch column, so at decode batch widths the streams set the time.
//
// What the design does about it.
//  * Locality.  In every stage the packer builds, a row at level >= 1 reads
//    only rows of its own instruction (one FP slice, n_pad rows).  The wrapper
//    derives, once at upload, the finest partition of [0, R) that no level >= 1
//    reads across (small pieces merged), and each block's live depth (the
//    identity levels after it are never run).  One thread block runs one piece
//    of rows through all its levels with the running rows ping-ponging between
//    two [rows, BB] float32 buffers in shared memory; only level 0 reads
//    device memory (inbuf, a few KB, L2-resident) and only the last level is
//    written out.  BB = batch columns per block; the b-blocks of one piece are
//    neighbours in the grid, so they read its streams while they are in L2.
//  * Determinism.  Weight sharing makes prep targets repeat.  The pairs are
//    sorted by target once at upload (stable: pair order inside a target is
//    kept) and thread (t, b) sums its target's pairs in that order; the output
//    gather and the dense blocks sum in a fixed order too.  No float atomics
//    anywhere: the result does not depend on scheduling.
//  * A row's S = 4 slots (the fused levels of S = 2 chains) come in one
//    16-byte index load and one 4-byte load each of exponents and signs;
//    2^exp is built from exponent bits, so it is exact; a term with sign 0
//    is skipped (its index is never followed).
//  * The epilogue gives each output element four threads, which split the
//    gather's j (up to 745 slices for `down`) and the dense blocks' dot
//    products (fs_mat, dw_mat: a GEMV loop is enough at B <= 16) and add
//    their partial sums by shuffles in a fixed order.  The residual add of
//    the decode step folds into the same epilogue.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDynamicSmem = 232448;  // 227 KB usable per block on sm_90

__device__ __forceinline__ float signed_pow2(int sign, int exp) {
  const unsigned bits = (static_cast<unsigned>(exp + 127) << 23) |
                        (sign < 0 ? 0x80000000u : 0u);
  return __uint_as_float(bits);
}

// inbuf[l, t, b] = sum_{i in [off[l, t], off[l, t + 1])} src[l, ssrc[l, i], b]
__global__ void stage_prep_kernel(const float* __restrict__ src,
                                  const int32_t* __restrict__ ssrc,
                                  const int32_t* __restrict__ off,
                                  float* __restrict__ inbuf, int nl, int D,
                                  int B, int M, int K) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t per = static_cast<size_t>(K) * B;
  if (i >= static_cast<size_t>(nl) * per) return;
  const int l = static_cast<int>(i / per);
  const size_t rem = i - l * per;
  const int t = static_cast<int>(rem / B);
  const int b = static_cast<int>(rem - static_cast<size_t>(t) * B);
  const int32_t* const o = off + static_cast<size_t>(l) * (K + 1);
  const int32_t* const s = ssrc + static_cast<size_t>(l) * M;
  const float* const x = src + static_cast<size_t>(l) * D * B + b;
  float acc = 0.0f;
  for (int j = o[t]; j < o[t + 1]; ++j) acc += x[static_cast<size_t>(s[j]) * B];
  inbuf[i] = acc;
}

// acc += coef(sign, exp) * row(j) over BB columns: level 0 reads inbuf
// (global, masked at the batch edge), later levels the previous level's rows
// in shared memory
template <int BB>
__device__ __forceinline__ void add_term(float (&acc)[BB], int sg, int ex,
                                         int j, int p, const float* in_l,
                                         const float* prev, int r0, int b0,
                                         int B) {
  if (sg == 0) return;
  const float coef = signed_pow2(sg, ex);
  float v[BB];
  if (p == 0) {
    const float* const row = in_l + static_cast<size_t>(j) * B + b0;
#pragma unroll
    for (int k = 0; k < BB; ++k) v[k] = (b0 + k < B) ? row[k] : 0.0f;
  } else {
    const float* const row = prev + static_cast<size_t>(j - r0) * BB;
    if constexpr (BB % 4 == 0) {
#pragma unroll
      for (int k = 0; k < BB; k += 4) {
        const float4 t = *reinterpret_cast<const float4*>(row + k);
        v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < BB; ++k) v[k] = row[k];
    }
  }
#pragma unroll
  for (int k = 0; k < BB; ++k) acc[k] = fmaf(coef, v[k], acc[k]);
}

// grid (ceil(B / BB), NB, nl); dynamic shared memory 2 * max_rows * BB floats.
template <int BB>
__global__ void __launch_bounds__(1024, 1)
stage_levels_kernel(const float* __restrict__ inbuf,
                    const int32_t* __restrict__ gidx,
                    const int8_t* __restrict__ gexp,
                    const int8_t* __restrict__ gsgn,
                    const int32_t* __restrict__ blk_r0,
                    const int32_t* __restrict__ blk_r1,
                    const int32_t* __restrict__ blk_depth,
                    float* __restrict__ work, int K, int P, int R, int S,
                    int B, int NB, int max_rows) {
  extern __shared__ __align__(16) float smem[];
  const int l = blockIdx.z;
  const size_t blk = static_cast<size_t>(l) * NB + blockIdx.y;
  const int r0 = blk_r0[blk];
  const int n = blk_r1[blk] - r0;
  const int depth = blk_depth[blk];
  if (n <= 0) return;  // uniform over the block
  const int b0 = blockIdx.x * BB;
  float* const buf0 = smem;
  float* const buf1 = smem + static_cast<size_t>(max_rows) * BB;
  const float* const in_l = inbuf + static_cast<size_t>(l) * K * B;
  float* const work_l = work + static_cast<size_t>(l) * R * B;
  for (int p = 0; p < depth; ++p) {
    const size_t base = (static_cast<size_t>(l) * P + p) * R * S;
    const float* const prev = (p & 1) ? buf0 : buf1;
    float* const next = (p & 1) ? buf1 : buf0;
    const bool last = (p == depth - 1);
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      float acc[BB];
#pragma unroll
      for (int k = 0; k < BB; ++k) acc[k] = 0.0f;
      const size_t t0 = base + static_cast<size_t>(r0 + r) * S;
      if (S == 4) {  // the fused levels of S = 2 chains: one load a stream
        const int4 j = *reinterpret_cast<const int4*>(gidx + t0);
        const char4 e = *reinterpret_cast<const char4*>(gexp + t0);
        const char4 sg = *reinterpret_cast<const char4*>(gsgn + t0);
        add_term<BB>(acc, sg.x, e.x, j.x, p, in_l, prev, r0, b0, B);
        add_term<BB>(acc, sg.y, e.y, j.y, p, in_l, prev, r0, b0, B);
        add_term<BB>(acc, sg.z, e.z, j.z, p, in_l, prev, r0, b0, B);
        add_term<BB>(acc, sg.w, e.w, j.w, p, in_l, prev, r0, b0, B);
      } else {
        for (int s = 0; s < S; ++s)
          add_term<BB>(acc, gsgn[t0 + s], gexp[t0 + s], gidx[t0 + s], p, in_l,
                       prev, r0, b0, B);
      }
      if (last) {
        float* const o = work_l + static_cast<size_t>(r0 + r) * B + b0;
#pragma unroll
        for (int k = 0; k < BB; ++k)
          if (b0 + k < B) o[k] = acc[k];
      } else {
        float* const o = next + static_cast<size_t>(r) * BB;
#pragma unroll
        for (int k = 0; k < BB; ++k) o[k] = acc[k];
      }
    }
    __syncthreads();
  }
}

constexpr int kLanes = 4;  // epilogue threads per output element

// sum over the kLanes neighbouring lanes of one output, in fixed order
__device__ __forceinline__ float lanes_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// out[l, o, b] = resid + ((gather + fs @ inbuf) + dw @ src) + bias; kLanes
// threads per output element split the gather's j and the dot products' k
// (interleaved) and combine their partial sums by shuffles.
__global__ void stage_epilogue_kernel(
    const float* __restrict__ work, const int32_t* __restrict__ outg,
    const float* __restrict__ inbuf, const float* __restrict__ src,
    const float* __restrict__ fs, const float* __restrict__ dw,
    const float* __restrict__ bias, const float* __restrict__ resid,
    float* __restrict__ out, int nl, int D, int B, int K, int R, int J, int O,
    int has_fp) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int q = static_cast<int>(t % kLanes);
  const size_t i = t / kLanes;
  const size_t per = static_cast<size_t>(O) * B;
  const bool live = i < static_cast<size_t>(nl) * per;  // whole warps shuffle
  const size_t ii = live ? i : 0;
  const int l = static_cast<int>(ii / per);
  const size_t rem = ii - l * per;
  const int o = static_cast<int>(rem / B);
  const int b = static_cast<int>(rem - static_cast<size_t>(o) * B);
  float g = 0.0f;
  if (has_fp && live) {
    const int32_t* const gi = outg + static_cast<size_t>(l) * J * O + o;
    const float* const w = work + static_cast<size_t>(l) * R * B + b;
#pragma unroll 4
    for (int j = q; j < J; j += kLanes) {
      const int r = gi[static_cast<size_t>(j) * O];
      if (r < R) g += w[static_cast<size_t>(r) * B];
    }
  }
  float acc = lanes_sum(g);
  if (fs != nullptr) {
    float f = 0.0f;
    if (live) {
      const float* const row = fs + (static_cast<size_t>(l) * O + o) * K;
      const float* const x = inbuf + static_cast<size_t>(l) * K * B + b;
      for (int k = q; k < K; k += kLanes)
        f = fmaf(row[k], x[static_cast<size_t>(k) * B], f);
    }
    acc += lanes_sum(f);
  }
  if (dw != nullptr) {
    float f = 0.0f;
    if (live) {
      const float* const row = dw + (static_cast<size_t>(l) * O + o) * D;
      const float* const x = src + static_cast<size_t>(l) * D * B + b;
      for (int k = q; k < D; k += kLanes)
        f = fmaf(row[k], x[static_cast<size_t>(k) * B], f);
    }
    acc += lanes_sum(f);
  }
  if (!live || q != 0) return;
  if (bias != nullptr) acc += bias[static_cast<size_t>(l) * O + o];
  if (resid != nullptr) acc = resid[i] + acc;
  out[i] = acc;
}

template <int BB>
cudaError_t launch_levels(const float* inbuf, const int32_t* gidx,
                          const int8_t* gexp, const int8_t* gsgn,
                          const int32_t* r0, const int32_t* r1,
                          const int32_t* depth, float* work, int nl, int K,
                          int P, int R, int S, int B, int NB, int threads,
                          int max_rows, cudaStream_t st) {
  const size_t smem = 2 * static_cast<size_t>(max_rows) * BB * sizeof(float);
  if (smem > static_cast<size_t>(kMaxDynamicSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage_levels_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BB - 1) / BB, NB, nl);
  stage_levels_kernel<BB><<<grid, threads, smem, st>>>(
      inbuf, gidx, gexp, gsgn, r0, r1, depth, work, K, P, R, S, B, NB,
      max_rows);
  return cudaGetLastError();
}

}  // namespace

// One stage over nl layers (pointers at the first of them): prep, levels and
// epilogue on `stream`.  K = 0: no prep; S = 0: no streams; fs/dw/bias/resid
// may be null.  Returns the first CUDA error (0 = every launch accepted).
extern "C" int repro_stage_matmul(
    const void* src, const void* prep_src, const void* prep_off, void* inbuf,
    const void* gidx, const void* gexp, const void* gsgn, const void* blk_r0,
    const void* blk_r1, const void* blk_depth, void* work, const void* outg,
    const void* fs, const void* dw, const void* bias, const void* resid,
    void* out, int nl, int D, int B, int M, int K, int P, int R, int S, int NB,
    int J, int O, int bb, int threads, int max_rows, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (nl <= 0 || B <= 0 || O <= 0 || threads <= 0 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(src);
  auto* in = static_cast<float*>(inbuf);
  const int cthreads = 256;
  if (K > 0) {
    const size_t total = static_cast<size_t>(nl) * K * B;
    stage_prep_kernel<<<static_cast<unsigned>((total + cthreads - 1) / cthreads),
                        cthreads, 0, st>>>(
        x, static_cast<const int32_t*>(prep_src),
        static_cast<const int32_t*>(prep_off), in, nl, D, B, M, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int has_fp = S > 0;
  if (has_fp) {
    if (K <= 0 || NB <= 0 || P <= 0 || R <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto* gi = static_cast<const int32_t*>(gidx);
    const auto* ge = static_cast<const int8_t*>(gexp);
    const auto* gs = static_cast<const int8_t*>(gsgn);
    const auto* a = static_cast<const int32_t*>(blk_r0);
    const auto* z = static_cast<const int32_t*>(blk_r1);
    const auto* dp = static_cast<const int32_t*>(blk_depth);
    auto* wk = static_cast<float*>(work);
    cudaError_t err;
    switch (bb) {
      case 8: err = launch_levels<8>(in, gi, ge, gs, a, z, dp, wk, nl, K, P, R, S, B, NB, threads, max_rows, st); break;
      case 4: err = launch_levels<4>(in, gi, ge, gs, a, z, dp, wk, nl, K, P, R, S, B, NB, threads, max_rows, st); break;
      case 2: err = launch_levels<2>(in, gi, ge, gs, a, z, dp, wk, nl, K, P, R, S, B, NB, threads, max_rows, st); break;
      case 1: err = launch_levels<1>(in, gi, ge, gs, a, z, dp, wk, nl, K, P, R, S, B, NB, threads, max_rows, st); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t total = static_cast<size_t>(nl) * O * B * kLanes;
  stage_epilogue_kernel<<<static_cast<unsigned>((total + cthreads - 1) / cthreads),
                          cthreads, 0, st>>>(
      static_cast<const float*>(work), static_cast<const int32_t*>(outg), in, x,
      static_cast<const float*>(fs), static_cast<const float*>(dw),
      static_cast<const float*>(bias), static_cast<const float*>(resid),
      static_cast<float*>(out), nl, D, B, K, R, J, O, has_fp);
  return static_cast<int>(cudaGetLastError());
}
