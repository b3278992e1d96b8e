// moe_route — the routed FFN's own kernels inside the whole-step layer plan on
// Hopper (sm_90a).  Per MoE layer the decode step runs
//
//   norm -> route -> stage(eg, gathered, gated) -> stage(ed, combining)
//
// with the stages in stage_matmul.cu and nothing else in between: the
// dispatch is the eg stage's gathered input (its prep reads h2 through the
// route's src_tok, so the [E * d, C] expert input is never written), SwiGLU
// the eg stage's gated epilogue, and the gated combine (x plus each token's
// weighted sum of its experts' outputs) the ed stage's combining epilogue.
//
// Replaces the MoE branch of the Pallas TPU kernel `step_plan_matmul` of
// src/repro/kernels/layer_plan.py (body `moe_block`): router logits, softmax,
// top-k, renormalisation and the capacity rank of every (token, choice),
// with each slot's source token for the stage that gathers the experts'
// input.
//
// Bound by bytes on this card, and by launch latency before that.  The route
// reads h2 [d, B] and the layer's router [d, E] once (6144 x 8 floats each at
// mixtral's width: 0.4 MB) for 2 * B * E * d flops: microseconds beside the
// expert stages' streams.
//
// What the design does about it.
//  * route: the logits take one pass over d, spread over blocks of 512
//    rows each (12 at mixtral's width) so that the 0.4 MB arrive in about
//    one memory round trip; one block alone reads them at one SM's rate.
//    Each thread sums its own rows (a row of h2 and of the router is B and
//    E contiguous floats, read with 16-byte loads where they are aligned)
//    into register sums for a tile of up to 8 tokens x 8 experts (all B * E
//    = 64 pairs at mixtral's width; a larger B or E takes a block a tile),
//    then a fixed shuffle tree and the warps in order add the partial sums
//    into the block's row of the scratch.  A second kernel, launched by the
//    same entry point, adds the blocks' rows in block order (no atomics:
//    every logit is summed in one fixed order), then a thread a token takes
//    the softmax, the top-k by repeated selection with ties to the lower
//    expert index (jax.lax.top_k's order) and the renormalisation; then ONE
//    thread runs the exclusive scan over the B * k assignments in
//    token-major, choice-minor order, exactly the reference's flattened
//    cumsum, so every rank, drop and slot is the reference's.  Idle slots
//    are routed too, as in the reference: they take capacity.  Kept slots
//    are unique, so each (expert, capacity column) has one source token or
//    none (src_tok -1): the stage reads the dispatch as a gather, not a
//    scatter-add.  No float atomics anywhere: run-to-run identical.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTopK = 8;
constexpr int kMaxDynamicSmem = 232448;
constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kRouteRows = 512;  // rows of d a logits block sums
constexpr int kTile = 8;  // tokens, and experts, of one register tile

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v[j] = row[c0 + j] for c0 + j < n, else 0; 16-byte loads when vec (n % 4
// == 0, row 16-byte aligned, c0 % 8 == 0)
__device__ __forceinline__ void load_tile(const float* __restrict__ row, int n,
                                          int c0, bool vec, float (&v)[kTile]) {
  if (vec) {
#pragma unroll
    for (int h = 0; h < kTile; h += 4) {
      const float4 q = c0 + h < n ? __ldg(reinterpret_cast<const float4*>(row + c0 + h))
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[h] = q.x;
      v[h + 1] = q.y;
      v[h + 2] = q.z;
      v[h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j) v[j] = c0 + j < n ? __ldg(row + c0 + j) : 0.0f;
  }
}

// grid (ceil(d / kRouteRows), ceil(B / 8), ceil(E / 8)), kRouteThreads
// threads: ws[blk, b, e] = the sum over the block's rows i of h2[i, b] *
// router[i, e], for the block's tile of tokens and experts.  vec_h / vec_r:
// the rows of h2 / the router may be read 16 bytes at a time.
__global__ void __launch_bounds__(kRouteThreads)
moe_logits_kernel(const float* __restrict__ h2, const float* __restrict__ router,
                  float* __restrict__ ws, int d, int B, int E, int vec_h,
                  int vec_r) {
  __shared__ float red[kRouteWarps][kTile * kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kTile, e0 = blockIdx.z * kTile;
  const int i1 = min(d, (blockIdx.x + 1) * kRouteRows);
  float acc[kTile][kTile];
#pragma unroll
  for (int x = 0; x < kTile; ++x)
#pragma unroll
    for (int y = 0; y < kTile; ++y) acc[x][y] = 0.0f;
#pragma unroll 2
  for (int i = blockIdx.x * kRouteRows + threadIdx.x; i < i1; i += kRouteThreads) {
    float hv[kTile], rv[kTile];
    load_tile(h2 + static_cast<size_t>(i) * B, B, b0, vec_h, hv);
    load_tile(router + static_cast<size_t>(i) * E, E, e0, vec_r, rv);
#pragma unroll
    for (int x = 0; x < kTile; ++x)
#pragma unroll
      for (int y = 0; y < kTile; ++y) acc[x][y] = fmaf(hv[x], rv[y], acc[x][y]);
  }
#pragma unroll
  for (int x = 0; x < kTile; ++x)
#pragma unroll
    for (int y = 0; y < kTile; ++y) {
      const float v = warp_sum(acc[x][y]);
      if (lane == 0) red[warp][x * kTile + y] = v;
    }
  __syncthreads();
  if (threadIdx.x < kTile * kTile) {
    const int b = b0 + threadIdx.x / kTile, e = e0 + threadIdx.x % kTile;
    float t = 0.0f;
    for (int w = 0; w < kRouteWarps; ++w) t += red[w][threadIdx.x];
    if (b < B && e < E)
      ws[(static_cast<size_t>(blockIdx.x) * B + b) * E + e] = t;
  }
}

// One block of kRouteThreads threads after moe_logits_kernel: the logits
// (the blocks' sums in block order), softmax, top-k, renormalisation and
// the capacity scan.  Dynamic shared memory: probs [B, E] f32, gates [B, k]
// f32, chosen [B, k] int, counts [E] int.
__global__ void __launch_bounds__(kRouteThreads)
moe_router_kernel(const float* __restrict__ ws, int n_blk,
                  int32_t* __restrict__ sel, float* __restrict__ wgt,
                  int32_t* __restrict__ slot, int32_t* __restrict__ src_tok,
                  int32_t* __restrict__ dropped, int B, int E, int k, int cap,
                  int norm_topk) {
  extern __shared__ __align__(16) float smem[];
  float* const prob = smem;
  float* const gate = prob + static_cast<size_t>(B) * E;
  int* const chosen = reinterpret_cast<int*>(gate + static_cast<size_t>(B) * k);
  int* const cnt = chosen + static_cast<size_t>(B) * k;
  const int n = B * E;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    float t = 0.0f;
#pragma unroll 8  // the loads in flight together; the adds stay in order
    for (int blk = 0; blk < n_blk; ++blk) t += ws[static_cast<size_t>(blk) * n + q];
    prob[q] = t;
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

}  // namespace

// h2 [d, B], router [d, E] (the layer's), outputs sel/wgt/slot [B, k] and
// src_tok [E * cap]; dropped (may be null) is incremented by the number of
// dropped assignments; ws holds ceil(d / 512) * B * E floats of scratch.
// Launches the logits kernel and the routing kernel.
extern "C" int repro_moe_route(const void* h2, const void* router, void* sel,
                               void* wgt, void* slot, void* src_tok,
                               void* dropped, void* ws, int d, int B, int E,
                               int k, int cap, int norm_topk, void* stream) {
  if (d <= 0 || B <= 0 || E <= 0 || k <= 0 || k > E || k > kMaxTopK ||
      cap <= 0 || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(B) * E + 2 * static_cast<size_t>(B) * k +
                       static_cast<size_t>(E)) * 4;
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      moe_router_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blk = (d + kRouteRows - 1) / kRouteRows;
  const int vec_h = B % 4 == 0 && reinterpret_cast<uintptr_t>(h2) % 16 == 0;
  const int vec_r = E % 4 == 0 && reinterpret_cast<uintptr_t>(router) % 16 == 0;
  const dim3 grid(n_blk, (B + kTile - 1) / kTile, (E + kTile - 1) / kTile);
  moe_logits_kernel<<<grid, kRouteThreads, 0, st>>>(
      static_cast<const float*>(h2), static_cast<const float*>(router),
      static_cast<float*>(ws), d, B, E, vec_h, vec_r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_router_kernel<<<1, kRouteThreads, smem, st>>>(
      static_cast<const float*>(ws), n_blk, static_cast<int32_t*>(sel),
      static_cast<float*>(wgt), static_cast<int32_t*>(slot),
      static_cast<int32_t*>(src_tok), static_cast<int32_t*>(dropped), B, E, k,
      cap, norm_topk);
  return static_cast<int>(cudaGetLastError());
}
