// moe_route — the routed FFN's own kernels inside the whole-step layer plan on
// Hopper (sm_90a).  Per MoE layer the decode step runs
//
//   norm -> route -> dispatch -> stage(eg) -> swiglu -> stage(ed) -> combine + x
//
// with the stages in stage_matmul.cu, SwiGLU in step_plan.cu and nothing else
// in between.
//
// Replaces the MoE branch of the Pallas TPU kernel `step_plan_matmul` of
// src/repro/kernels/layer_plan.py (body `moe_block`): router logits, softmax,
// top-k, renormalisation, the capacity rank of every (token, choice), the
// e-major dispatch into the expert super-stages' input and the gated combine.
//
// Bound by bytes on this card, and by launch latency before that.  The route
// reads h2 [d, B] and the layer's router [d, E] once (6144 x 8 floats each at
// mixtral's width: 0.4 MB) for 2 * B * E * d flops; dispatch writes the
// [E * d, C] expert input and combine reads the [E * d, C] expert output once.
// Each is microseconds beside the expert stages' streams.
//
// What the design does about it, and why it is right rather than fast.
//  * route: one block a layer.  The logits come in passes of 16 (token,
//    expert) pairs: each thread sums its own rows of d for every pair of the
//    pass (a row of h2 and of the router is B and E contiguous floats), then
//    a fixed shuffle tree and the warps in order add the partial sums.  Then
//    a thread a token takes the softmax, the top-k by repeated selection
//    with ties to the lower expert index (jax.lax.top_k's order) and the
//    renormalisation; then ONE thread
//    runs the exclusive scan over the B * k assignments in token-major,
//    choice-minor order, exactly the reference's flattened cumsum, so every
//    rank, drop and slot is the reference's.  Idle slots are routed too, as
//    in the reference: they take capacity.
//  * dispatch is a gather, not a scatter-add: kept slots are unique, so each
//    (expert, capacity column) has one source token or none (zero).  No
//    float atomics anywhere: run-to-run identical.
//  * combine sums a token's kept choices in choice order with round-to-
//    nearest multiplies and adds (no contraction into fused multiply-adds
//    the reference does not take) and reads no slot for a dropped choice.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTopK = 8;
constexpr int kMaxDynamicSmem = 232448;
constexpr int kRouteThreads = 512;
constexpr int kPairChunk = 16;  // (token, expert) logits summed per pass

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block of kRouteThreads threads.  Dynamic shared memory: probs [B, E]
// f32, gates [B, k] f32, chosen [B, k] int, counts [E] int.
__global__ void __launch_bounds__(kRouteThreads)
moe_route_kernel(const float* __restrict__ h2, const float* __restrict__ router,
                 int32_t* __restrict__ sel, float* __restrict__ wgt,
                 int32_t* __restrict__ slot, int32_t* __restrict__ src_tok,
                 int32_t* __restrict__ dropped, int d, int B, int E, int k,
                 int cap, int norm_topk) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[(kRouteThreads / 32) * kPairChunk];
  float* const prob = smem;
  float* const gate = prob + static_cast<size_t>(B) * E;
  int* const chosen = reinterpret_cast<int*>(gate + static_cast<size_t>(B) * k);
  int* const cnt = chosen + static_cast<size_t>(B) * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // logits[b, e] = sum_i h2[i, b] * router[i, e], kPairChunk pairs a pass
  for (int q0 = 0; q0 < B * E; q0 += kPairChunk) {
    int pb[kPairChunk], pe[kPairChunk];
    float acc[kPairChunk];
#pragma unroll
    for (int j = 0; j < kPairChunk; ++j) {
      const int q = min(q0 + j, B * E - 1);  // past the end: a repeat, unused
      pb[j] = q / E;
      pe[j] = q - pb[j] * E;
      acc[j] = 0.0f;
    }
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float* const hr = h2 + static_cast<size_t>(i) * B;
      const float* const rr = router + static_cast<size_t>(i) * E;
#pragma unroll
      for (int j = 0; j < kPairChunk; ++j) acc[j] = fmaf(hr[pb[j]], rr[pe[j]], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kPairChunk; ++j) {
      const float v = warp_sum(acc[j]);
      if (lane == 0) red[warp * kPairChunk + j] = v;
    }
    __syncthreads();
    if (threadIdx.x < kPairChunk && q0 + threadIdx.x < B * E) {
      float t = 0.0f;
      for (int w = 0; w < nw; ++w) t += red[w * kPairChunk + threadIdx.x];
      prob[q0 + threadIdx.x] = t;
    }
    __syncthreads();  // red is written again by the next pass
  }
  for (int c = threadIdx.x; c < E * cap; c += blockDim.x) src_tok[c] = -1;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float* const p = prob + static_cast<size_t>(b) * E;
    float m = p[0];
    for (int e = 1; e < E; ++e) m = fmaxf(m, p[e]);
    float s = 0.0f;
    for (int e = 0; e < E; ++e) {
      const float v = expf(p[e] - m);
      p[e] = v;
      s += v;
    }
    for (int e = 0; e < E; ++e) p[e] = __fdiv_rn(p[e], s);
    int* const ch = chosen + static_cast<size_t>(b) * k;
    float* const g = gate + static_cast<size_t>(b) * k;
    float tot = 0.0f;
    for (int j = 0; j < k; ++j) {
      int best = -1;
      float bv = 0.0f;
      for (int e = 0; e < E; ++e) {
        bool taken = false;
        for (int i = 0; i < j; ++i) taken = taken || ch[i] == e;
        // strictly greater: an equal probability keeps the lower index
        if (!taken && (best < 0 || p[e] > bv)) {
          best = e;
          bv = p[e];
        }
      }
      ch[j] = best;
      g[j] = bv;
      tot += bv;
    }
    if (norm_topk) {
      const float den = fmaxf(tot, 1e-9f);
      for (int j = 0; j < k; ++j) g[j] = __fdiv_rn(g[j], den);
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  // rank = exclusive count of earlier assignments to the same expert, over
  // the assignments in token-major, choice-minor order
  for (int e = 0; e < E; ++e) cnt[e] = 0;
  int n_drop = 0;
  for (int a = 0; a < B * k; ++a) {
    const int e = chosen[a];
    const int r = cnt[e]++;
    sel[a] = e;
    if (r < cap) {
      slot[a] = e * cap + r;
      wgt[a] = gate[a];
      src_tok[e * cap + r] = a / k;
    } else {  // dropped: the slot is one past the buffer, the weight zero
      slot[a] = E * cap;
      wgt[a] = 0.0f;
      ++n_drop;
    }
  }
  if (dropped != nullptr) *dropped += n_drop;
}

// src[(e * d + i) * C + c] = h2[i, src_tok[e * C + c]], or 0 for an empty slot
__global__ void moe_dispatch_kernel(const float* __restrict__ h2,
                                    const int32_t* __restrict__ src_tok,
                                    float* __restrict__ src, int d, int B,
                                    int E, int cap) {
  const size_t n = static_cast<size_t>(E) * d * cap;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t row = t / cap;
  const int c = static_cast<int>(t - row * cap);
  const int e = static_cast<int>(row / d);
  const int i = static_cast<int>(row - static_cast<size_t>(e) * d);
  const int tok = src_tok[e * cap + c];
  src[t] = tok >= 0 ? h2[static_cast<size_t>(i) * B + tok] : 0.0f;
}

// out[i, b] = x[i, b] + sum_j wgt[b, j] * ob[(e_j * d + i) * C + c_j] over the
// kept choices j in order, (e_j, c_j) = divmod(slot[b, j], C)
__global__ void moe_combine_kernel(const float* __restrict__ x,
                                   const float* __restrict__ ob,
                                   const int32_t* __restrict__ slot,
                                   const float* __restrict__ wgt,
                                   float* __restrict__ out, int d, int B,
                                   int E, int k, int cap) {
  const size_t n = static_cast<size_t>(d) * B;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = static_cast<int>(t / B);
  const int b = static_cast<int>(t - static_cast<size_t>(i) * B);
  float y = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int s = slot[b * k + j];
    if (s < 0 || s >= E * cap) continue;  // dropped: no slot is read
    const int e = s / cap, c = s - e * cap;
    y = __fadd_rn(y, __fmul_rn(wgt[b * k + j],
                               ob[(static_cast<size_t>(e) * d + i) * cap + c]));
  }
  out[t] = __fadd_rn(x[t], y);
}

}  // namespace

// h2 [d, B], router [d, E] (the layer's), outputs sel/wgt/slot [B, k] and
// src_tok [E * cap]; dropped (may be null) is incremented by the number of
// dropped assignments.
extern "C" int repro_moe_route(const void* h2, const void* router, void* sel,
                               void* wgt, void* slot, void* src_tok,
                               void* dropped, int d, int B, int E, int k,
                               int cap, int norm_topk, void* stream) {
  if (d <= 0 || B <= 0 || E <= 0 || k <= 0 || k > E || k > kMaxTopK ||
      cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(B) * E + 2 * static_cast<size_t>(B) * k +
                       static_cast<size_t>(E)) * 4;
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      moe_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_route_kernel<<<1, kRouteThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h2), static_cast<const float*>(router),
      static_cast<int32_t*>(sel), static_cast<float*>(wgt),
      static_cast<int32_t*>(slot), static_cast<int32_t*>(src_tok),
      static_cast<int32_t*>(dropped), d, B, E, k, cap, norm_topk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_moe_dispatch(const void* h2, const void* src_tok,
                                  void* src, int d, int B, int E, int cap,
                                  void* stream) {
  if (d <= 0 || B <= 0 || E <= 0 || cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(E) * d * cap;
  const int threads = 256;
  moe_dispatch_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                        threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h2), static_cast<const int32_t*>(src_tok),
      static_cast<float*>(src), d, B, E, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_moe_combine(const void* x, const void* ob,
                                 const void* slot, const void* wgt, void* out,
                                 int d, int B, int E, int k, int cap,
                                 void* stream) {
  if (d <= 0 || B <= 0 || E <= 0 || k <= 0 || cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(d) * B;
  const int threads = 256;
  moe_combine_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                       threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ob),
      static_cast<const int32_t*>(slot), static_cast<const float*>(wgt),
      static_cast<float*>(out), d, B, E, k, cap);
  return static_cast<int>(cudaGetLastError());
}
