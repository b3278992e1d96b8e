// step_plan — the kernels of the whole-step layer plan on Hopper (sm_90a)
// besides the stages: the norm, RoPE + decode attention over the KV cache,
// and SwiGLU.  Per layer the decode step runs
//
//   norm -> stage(qkv) -> attention (emits k_new, v_new) -> stage(o) + x
//        -> norm -> stage(gu) -> swiglu -> stage(dn) + x
//
// with the stages in stage_matmul.cu and no other operation in between.
//
// Replaces the dense branch of the Pallas TPU kernel `step_plan_matmul` of
// src/repro/kernels/layer_plan.py (one pallas_call over all L layers; there
// the step ran only under the interpreter, never compiled).
//
// What bounds it on this card.  The norm and SwiGLU touch a few [d, B] /
// [d_ff, B] float32 vectors: launch latency.  The attention reads the KV cache
// rows of its (row, kv-head) once: bytes, 2 * S * hd * 4 bytes per pair.  The
// step as a whole is bound by the stages' streams (stage_matmul.cu).
//
// What the design does about it.
//  * Attention reads the cache in place, through the block table when the
//    cache is paged: the [L, B, S, Hkv, hd] view the reference gathers before
//    the kernel is never built.  One block per (kv-head, row): the G query
//    heads of the group are rotated into shared memory together with the new
//    K/V row, each warp scores cache slots (lanes split the head dimension,
//    fixed-order shuffle sums), one warp per query head takes the softmax, and
//    threads over (head, dim) sum the probability-weighted V rows in slot
//    order.
//  * As in the reference, scores are taken against the stale cache and the
//    current token's slot is patched with the new K/V row in score space
//    (hit = slot == pos, or pos % S for a sliding window); the mask is the
//    finite -1e30, so an idle row (pos == -1) gives finite output.
//  * Every reduction runs in a fixed order (no atomics): run-to-run identical.
//  * RoPE and the score scaling use round-to-nearest intrinsics so that the
//    compiler does not contract them into fused multiply-adds the reference
//    does not take.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDynamicSmem = 232448;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum over the block (blockDim.x a multiple of 32, at most 1024); every
// thread gets the result
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < nw; ++w) t += red[w];
  return t;
}

// one block per column b of x [d, B]; mode 0: rms norm (eps 1e-6, weight w
// or none), mode 1: non-parametric layer norm (eps 1e-5)
__global__ void step_norm_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 float* __restrict__ out, int d, int B,
                                 int mode, float eps) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  const float inv_d = 1.0f / static_cast<float>(d);
  float s = 0.0f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = x[static_cast<size_t>(i) * B + b];
    s += (mode == 0) ? __fmul_rn(v, v) : v;
  }
  s = block_sum(s, red);
  float mu = 0.0f, var;
  if (mode == 0) {
    var = s * inv_d;
  } else {
    mu = s * inv_d;
    float q = 0.0f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float c = x[static_cast<size_t>(i) * B + b] - mu;
      q += __fmul_rn(c, c);
    }
    var = block_sum(q, red) * inv_d;
  }
  const float r = 1.0f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const size_t k = static_cast<size_t>(i) * B + b;
    float v = __fmul_rn(x[k] - mu, r);
    if (w != nullptr) v = __fmul_rn(v, w[i]);
    out[k] = v;
  }
}

__device__ __forceinline__ const float* cache_row(const float* cache,
                                                  const int32_t* tbl, int b,
                                                  int s, int h, int S, int nkv,
                                                  int hd, int bs, int mb) {
  size_t row;
  if (tbl != nullptr) {  // paged: [Nb, bs, Hkv, hd] pool, row's table tbl[b]
    const int blk = tbl[static_cast<size_t>(b) * mb + s / bs];
    row = static_cast<size_t>(blk) * bs + s % bs;
  } else {  // contiguous: [B, S, Hkv, hd]
    row = static_cast<size_t>(b) * S + s;
  }
  return cache + (row * nkv + h) * hd;
}

// grid (nkv, B), blockDim a multiple of 32; dynamic shared memory
// (G * hd + 2 * hd + G * S) floats, G = nq / nkv.
__global__ void step_attention_kernel(
    const float* __restrict__ qkv, const int32_t* __restrict__ pos,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    const float* __restrict__ kc, const float* __restrict__ vc,
    const int32_t* __restrict__ kpos, const int32_t* __restrict__ tbl,
    float* __restrict__ att, float* __restrict__ kn, float* __restrict__ vn,
    int B, int S, int nq, int nkv, int hd, int bs, int mb, int window,
    float scale) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = nq / nkv, half = hd / 2;
  float* const q = sm;          // [G, hd] rotated query heads of the group
  float* const kr = q + G * hd; // [hd] rotated new K row
  float* const vr = kr + hd;    // [hd] new V row
  float* const lg = vr + hd;    // [G, S] logits, then probabilities
  const int p = pos[b];
  const int slot = (window > 0) ? (p >= 0 ? p % S : -1) : p;

  for (int t = threadIdx.x; t < (G + 2) * hd; t += blockDim.x) {
    const int which = t / hd, i = t - which * hd;
    const int head = which < G ? h * G + which
                     : (which == G ? nq + h : nq + nkv + h);
    const size_t row = static_cast<size_t>(head) * hd;
    float v = qkv[(row + i) * B + b];
    if (which <= G && cosv != nullptr) {  // half-split rotation of q and k
      const int ii = i < half ? i : i - half;
      const float c = cosv[static_cast<size_t>(b) * half + ii];
      const float sn = sinv[static_cast<size_t>(b) * half + ii];
      if (i < half) {
        const float v2 = qkv[(row + i + half) * B + b];
        v = __fsub_rn(__fmul_rn(v, c), __fmul_rn(v2, sn));
      } else {
        const float v1 = qkv[(row + i - half) * B + b];
        v = __fadd_rn(__fmul_rn(v, c), __fmul_rn(v1, sn));
      }
    }
    const size_t o = (static_cast<size_t>(b) * nkv + h) * hd + i;
    if (which < G) {
      q[which * hd + i] = v;
    } else if (which == G) {
      kr[i] = v;
      kn[o] = v;
    } else {
      vr[i] = v;
      vn[o] = v;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int s = warp; s < S; s += nw) {
    const bool hit = (s == slot);
    const float* const krow =
        hit ? kr : cache_row(kc, tbl, b, s, h, S, nkv, hd, bs, mb);
    bool valid;
    if (hit) {
      valid = p >= 0;
    } else {
      const int kp = kpos[static_cast<size_t>(b) * S + s];
      valid = kp >= 0 && kp <= p && (window <= 0 || kp > p - window);
    }
    for (int g = 0; g < G; ++g) {
      float part = 0.0f;
      for (int i = lane; i < hd; i += 32) part = fmaf(q[g * hd + i], krow[i], part);
      part = warp_sum(part);
      if (lane == 0)
        lg[g * S + s] = __fadd_rn(__fmul_rn(part, scale), valid ? 0.0f : -1e30f);
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += nw) {
    float* const row = lg + g * S;
    float m = __uint_as_float(0xff800000u);  // -inf
    for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) row[s] = row[s] / sum;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < G * hd; t += blockDim.x) {
    const int g = t / hd, i = t - g * hd;
    const float* const pr = lg + g * S;
    float acc = 0.0f, p_hit = 0.0f;
    for (int s = 0; s < S; ++s) {
      if (s == slot) {
        p_hit = pr[s];
        continue;
      }
      acc = fmaf(pr[s], cache_row(vc, tbl, b, s, h, S, nkv, hd, bs, mb)[i], acc);
    }
    acc = __fadd_rn(acc, __fmul_rn(p_hit, vr[i]));
    att[(static_cast<size_t>(h * G + g) * hd + i) * B + b] = acc;
  }
}

// out[k, b] = silu(gu[k, b]) * gu[d_ff + k, b]
__global__ void step_swiglu_kernel(const float* __restrict__ gu,
                                   float* __restrict__ out, int dff, int B) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t n = static_cast<size_t>(dff) * B;
  if (i >= n) return;
  const float g = gu[i];
  const float silu = __fdiv_rn(g, 1.0f + expf(-g));
  out[i] = __fmul_rn(silu, gu[n + i]);
}

}  // namespace

extern "C" int repro_step_norm(const void* x, const void* w, void* out, int d,
                               int B, int mode, float eps, void* stream) {
  if (d <= 0 || B <= 0 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  step_norm_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), d, B, mode, eps);
  return static_cast<int>(cudaGetLastError());
}

// kc/vc/kpos point at the layer's cache (contiguous [B, S, Hkv, hd] or, with
// tbl, the pool [Nb, bs, Hkv, hd]) and kn/vn at the layer's [B, Hkv, hd] rows;
// cos/sin may be null (no RoPE); window <= 0: no sliding window.
extern "C" int repro_step_attention(const void* qkv, const void* pos,
                                    const void* cosv, const void* sinv,
                                    const void* kc, const void* vc,
                                    const void* kpos, const void* tbl,
                                    void* att, void* kn, void* vn, int B,
                                    int S, int nq, int nkv, int hd, int bs,
                                    int mb, int window, float scale,
                                    void* stream) {
  if (B <= 0 || S <= 0 || nkv <= 0 || nq % nkv != 0 || hd <= 0 || hd % 2 != 0 ||
      (tbl != nullptr && (bs <= 0 || mb * bs < S)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = nq / nkv;
  const size_t smem = (static_cast<size_t>(G) * hd + 2 * static_cast<size_t>(hd) +
                       static_cast<size_t>(G) * S) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      step_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nkv, B);
  step_attention_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const int32_t*>(pos),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<const float*>(kc), static_cast<const float*>(vc),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(tbl),
      static_cast<float*>(att), static_cast<float*>(kn), static_cast<float*>(vn),
      B, S, nq, nkv, hd, bs, mb, window, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_step_swiglu(const void* gu, void* out, int dff, int B,
                                 void* stream) {
  if (dff <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(dff) * B;
  const int threads = 256;
  step_swiglu_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                       threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gu), static_cast<float*>(out), dff, B);
  return static_cast<int>(cudaGetLastError());
}
