// step_plan — the kernels of the whole-step layer plan on Hopper (sm_90a)
// besides the stages: the norm and RoPE + decode attention over the KV
// cache.  Per layer the decode step runs
//
//   norm -> stage(qkv) -> attention (emits k_new, v_new) -> stage(o) + x
//        -> norm -> stage(gu, gated: SwiGLU) -> stage(dn) + x
//
// with the stages in stage_matmul.cu (SwiGLU is the gate/up stage's gated
// epilogue) and no other operation in between.
//
// Replaces the dense branch of the Pallas TPU kernel `step_plan_matmul` of
// src/repro/kernels/layer_plan.py (one pallas_call over all L layers; the
// attention is its lines 375-406; there the step ran only under the
// interpreter, never compiled).
//
// What bounds it on this card.  The norm touches a few [d, B] float32
// vectors: launch latency.  The attention is bound by
// bytes: the K and V rows of the slots it must read, 2 * hd * 4 bytes a
// (row, kv-head, slot), and all of kpos; its operations (4 * G * hd a slot)
// are far below the float32 rate.  The step as a whole is bound by the
// stages' streams (stage_matmul.cu).
//
// What the attention's design does about it (flash-decoding):
//  * Split over the cache.  The grid is (splits, kv-heads, rows); a block
//    takes one chunk of consecutive cache slots for the G query heads of its
//    group, so a short cache still fills the card and a long one gives
//    several waves.  The host planner (layer_plan.plan_attention) fixes the
//    chunk (a multiple of the page size) and the split count per shape;
//    shared memory is bounded by the chunk, not by S.
//  * Only the live slots are read.  A block first reads its chunk's kpos and
//    keeps, in slot order, the slots an active row can see (and the current
//    token's slot).  A masked slot of an active row adds exactly 0 to the
//    max, the sum and the PV sum (exp(-1e30 - m) == 0 for a finite m), so its
//    K/V rows are never copied.  A row with no slot that must be live (an
//    idle row, pos == -1) keeps the reference's result: it takes every slot
//    of its chunk, all masked, and ends as the mean of all V rows.  A chunk
//    with nothing live merges as empty (l = 0).
//  * K and V rows staged in shared memory by cp.async.  One head's row is hd
//    contiguous floats (512 bytes at hd = 128) in the cache or the page pool
//    ([Nb, bs, Hkv, hd], read through the block table); the live rows go in
//    16-byte copies into a ring of three slots of 16 rows (one page of the
//    serves' cache): the chunk's K tiles, then its V tiles, two tiles in
//    flight ahead of the one in use.  Each live row's cache offset is found
//    once (kpos and the block table are read together, with q) and kept in
//    shared memory, so a copy costs a few instructions.  Scores come from
//    shared memory with q in registers (a warp a row, lanes over hd, the G
//    dot products reduced together by halving shuffles in a fixed order; one
//    instantiation a group size, hd a power of two up to 128); the PV sum
//    runs over the staged tile with threads over (g, i), each row's weights
//    read as float4s.
//  * Merge in a fixed order.  Each split writes (m, l, o[hd]) for each of
//    its query heads; a second kernel, launched by the same entry point,
//    merges them in split order.  No atomics: run-to-run identical.
//  * float32 on the CUDA cores.  A block holds G <= 8 query rows, far below
//    the 64 rows of a wgmma tile, and TF32 would not hold the step's 1e-4.
//  * As in the reference, scores are taken against the stale cache and the
//    current token's slot is patched with the new K/V row in score space
//    (hit = slot == pos, or pos % S for a sliding window); the mask is the
//    finite -1e30.
//  * RoPE and the score scaling use round-to-nearest intrinsics so that the
//    compiler does not contract them into fused multiply-adds the reference
//    does not take.
#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kAttnTile = 16;   // live rows a ring slot holds
constexpr int kAttnRing = 3;    // ring slots: two tiles in flight
constexpr int kMaxGroup = 8;    // query heads a kv-head

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most kAttnRing - 2 of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAttnRing - 2));
}

// ---------------------------------------------------------------- the norm
//
// x [d, B] features-major.  A thread-block cluster a group of W columns (W a
// power of two <= 32), its R blocks (R <= 8) over consecutive ranges of
// rows; cols, R and the threads from layer_plan.plan_norm.  Each block
// stages its [rows, W] sub-tile in shared memory once (cp.async, 16-byte
// copies along the contiguous B axis where B and W are multiples of 4, else
// 4-byte ones) and takes every pass from there.  Thread t sums column
// t % W over the block's rows t / W, t / W + T / W, ... in ascending order;
// the partial sums of one column are reduced by a butterfly over the lanes
// that hold it, then over the warps in warp order through shared memory,
// then over the cluster's blocks in rank order through distributed shared
// memory (every block takes the same sum; a block writes its sums into
// every block's shared memory before one cluster barrier, then reads only
// its own).  No atomics: run-to-run
// identical.  mode 0: rms norm (eps 1e-6, weight w or none); mode 1:
// non-parametric layer norm (eps 1e-5), centred as the reference computes
// it (the mean first, then the squares of v - mean).  The result is written
// from the sub-tile with 16-byte stores where the copies were.

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the sum over the cluster of one column's partial sums (see above): red
// holds [warps][W] floats; parts [R][W], where every block of the cluster
// writes its block sums into every block's copy, so that after the one
// cluster barrier each block reads its own copy in rank order and no block
// reads another's shared memory (first: the first sum of the kernel, which
// waits on the arrival every thread made at its start, so that every block
// of the cluster has started before its shared memory is written)
__device__ __forceinline__ float norm_column_sum(float v, float* red,
                                                 float* parts, int W, int c,
                                                 cg::cluster_group& cluster,
                                                 bool first) {
  for (int o = 16; o >= W; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int R = static_cast<int>(cluster.num_blocks());
  if (lane < W) red[(threadIdx.x >> 5) * W + lane] = v;
  __syncthreads();
  if (first) cluster_wait();
  if (threadIdx.x < W) {
    float t = 0.0f;
#pragma unroll 8
    for (int w = 0; w < nw; ++w) t += red[w * W + threadIdx.x];
    const int slot = static_cast<int>(cluster.block_rank()) * W + threadIdx.x;
    for (int q = 0; q < R; ++q) cluster.map_shared_rank(parts, q)[slot] = t;
  }
  cluster.sync();  // every block's sums are in every block's parts
  float t = 0.0f;
  for (int q = 0; q < R; ++q) t += parts[q * W + c];
  return t;
}

template <bool VEC>
__global__ void step_norm_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 float* __restrict__ out, int d, int B, int lw,
                                 int rows, int mode, float eps) {
  extern __shared__ float4 norm_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // waited on before the first write to another block
  const int W = 1 << lw;
  const int r0 = static_cast<int>(cluster.block_rank()) * rows;
  const int nr = max(0, min(rows, d - r0));  // this block's rows
  float* const tile = reinterpret_cast<float*>(norm_smem);  // [rows][W]
  const int R = static_cast<int>(cluster.num_blocks());
  float* const red = tile + static_cast<size_t>(rows) * W;  // [warps][W]
  float* const parts = red + (blockDim.x >> 5) * W;         // [2][R][W]
  float* const stat = parts + 2 * R * W;                    // mean, 1/sd
  const int tid = threadIdx.x, T = blockDim.x;
  const int c0 = blockIdx.x * W;
  const int live = min(W, B - c0);  // columns of this group inside B
  const int n = nr * W;
  const float* const xb = x + static_cast<size_t>(r0) * B + c0;
  float* const ob = out + static_cast<size_t>(r0) * B + c0;
  if (VEC) {
    for (int q = tid; 4 * q < n; q += T) {
      const int e = 4 * q, i = e >> lw, c = e & (W - 1);
      if (c < live)
        cp_async16(tile + e, xb + static_cast<size_t>(i) * B + c);
      else
        *reinterpret_cast<float4*>(tile + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < n; e += T) {
      const int i = e >> lw, c = e & (W - 1);
      if (c < live)
        cp_async4(tile + e, xb + static_cast<size_t>(i) * B + c);
      else
        tile[e] = 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int c = tid & (W - 1), s0 = tid >> lw, S = T >> lw;
  const float fd = static_cast<float>(d);
  float acc = 0.0f;
#pragma unroll 4
  for (int i = s0; i < nr; i += S) {
    const float v = tile[i * W + c];
    acc += (mode == 0) ? __fmul_rn(v, v) : v;
  }
  const float tot = norm_column_sum(acc, red, parts, W, c, cluster, true);
  float mu = 0.0f, var;
  if (mode == 0) {
    var = __fdiv_rn(tot, fd);
  } else {
    mu = __fdiv_rn(tot, fd);
    float q = 0.0f;
#pragma unroll 4
    for (int i = s0; i < nr; i += S) {
      const float t = tile[i * W + c] - mu;
      q += __fmul_rn(t, t);
    }
    var = __fdiv_rn(
        norm_column_sum(q, red, parts + R * W, W, c, cluster, false), fd);
  }
  if (tid < W) {
    stat[tid] = mu;
    stat[W + tid] = __fdiv_rn(1.0f, __fsqrt_rn(var + eps));
  }
  __syncthreads();

  if (VEC) {
    for (int q = tid; 4 * q < n; q += T) {
      const int e = 4 * q, i = e >> lw, cc = e & (W - 1);
      if (cc >= live) continue;
      float4 v = *reinterpret_cast<const float4*>(tile + e);
      v.x = __fmul_rn(v.x - stat[cc], stat[W + cc]);
      v.y = __fmul_rn(v.y - stat[cc + 1], stat[W + cc + 1]);
      v.z = __fmul_rn(v.z - stat[cc + 2], stat[W + cc + 2]);
      v.w = __fmul_rn(v.w - stat[cc + 3], stat[W + cc + 3]);
      if (w != nullptr) {
        const float wi = w[r0 + i];
        v.x = __fmul_rn(v.x, wi);
        v.y = __fmul_rn(v.y, wi);
        v.z = __fmul_rn(v.z, wi);
        v.w = __fmul_rn(v.w, wi);
      }
      *reinterpret_cast<float4*>(ob + static_cast<size_t>(i) * B + cc) = v;
    }
  } else {
    for (int e = tid; e < n; e += T) {
      const int i = e >> lw, cc = e & (W - 1);
      if (cc >= live) continue;
      float v = __fmul_rn(tile[e] - stat[cc], stat[W + cc]);
      if (w != nullptr) v = __fmul_rn(v, w[r0 + i]);
      ob[static_cast<size_t>(i) * B + cc] = v;
    }
  }
}

// Sums each of the N values (N a power of two <= 32) over the warp in a
// fixed order: halving exchanges, then a butterfly over the remaining lane
// bits.  Afterwards v[0] of lane l holds the sum of value l >> (5 - log2 N).
template <int N>
__device__ __forceinline__ void warp_sum_scatter(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  int o = 16;
#pragma unroll
  for (int h = N / 2; h >= 1; h /= 2, o /= 2) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const float send = upper ? v[k] : v[k + h];
      const float keep = upper ? v[k + h] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  for (; o > 0; o /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Shared memory of split_attention_kernel, in floats: the ring, q [G, hd],
// the new K and V rows, the chunk's logits [chunk, 8], the live rows'
// cache offsets [chunk] (int64), m and l [2, 8], the live rows' mask flags
// [chunk] (int).  Mirrored by layer_plan.attention_smem.
__host__ __device__ constexpr size_t attention_smem_floats(int G, int hd,
                                                           int chunk) {
  return static_cast<size_t>(kAttnRing) * kAttnTile * hd +
         static_cast<size_t>(G + 2) * hd +
         static_cast<size_t>(kMaxGroup + 3) * chunk + 2 * kMaxGroup;
}

// grid (splits, nkv, B), kAttnThreads threads.  G <= GM query heads a
// kv-head, hd a power of two, 4 <= hd <= 128; lhd = log2(hd).  Writes the
// new K/V rows (split 0) and either the normalised output (one split) or
// the split's (o [G, hd], m [G], l [G]) into ws [B, nkv, splits, G * (hd +
// 2)].
template <int GM>
__global__ void __launch_bounds__(kAttnThreads)
split_attention_kernel(const float* __restrict__ qkv,
                       const int32_t* __restrict__ pos,
                       const float* __restrict__ cosv,
                       const float* __restrict__ sinv,
                       const float* __restrict__ kc,
                       const float* __restrict__ vc,
                       const int32_t* __restrict__ kpos,
                       const int32_t* __restrict__ tbl,
                       float* __restrict__ att, float* __restrict__ kn,
                       float* __restrict__ vn, float* __restrict__ ws, int B,
                       int S, int nq, int nkv, int hd, int lhd, int bs, int mb,
                       int window, int chunk, float scale) {
  constexpr int N = pow2_at_least(GM);  // values a score reduction carries
  extern __shared__ __align__(16) float sm[];
  __shared__ int warp_cnt[kAttnWarps];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = nq / nkv, half = hd / 2;
  float* const ring = sm;                                  // [3, 16, hd]
  float* const q = ring + kAttnRing * kAttnTile * hd;      // [G, hd]
  float* const kr = q + G * hd;                            // [hd]
  float* const vr = kr + hd;                               // [hd]
  float* const sc = vr + hd;                               // [chunk, 8]
  long long* const rowoff =                                // [chunk]
      reinterpret_cast<long long*>(sc + kMaxGroup * chunk);
  float* const stat = reinterpret_cast<float*>(rowoff + chunk);  // m, l [2, 8]
  int* const masked = reinterpret_cast<int*>(stat + 2 * kMaxGroup);  // [chunk]

  const int p = pos[b];
  const int slot = (window > 0) ? (p >= 0 ? p % S : -1) : p;
  // no slot of this row is sure to be live: read every slot, masked or not
  const bool full = p < 0 || (window <= 0 && p >= S);
  const int c0 = split * chunk, c1 = min(S, c0 + chunk);
  const bool writer = split == 0;
  const bool need_new = writer || (slot >= c0 && slot < c1);
  float* const wsb =
      ws + ((static_cast<size_t>(b) * nkv + h) * splits + split) *
               (static_cast<size_t>(G) * (hd + 2));

  // this thread's slot of the chunk's first pass: kpos and its page, loaded
  // before the query so that both are in flight together
  int kp0 = -1, pg0 = 0;
  if (c0 + tid < c1) {
    kp0 = kpos[static_cast<size_t>(b) * S + c0 + tid];
    if (tbl != nullptr) pg0 = tbl[static_cast<size_t>(b) * mb + (c0 + tid) / bs];
  }

  // 1. the rotated query heads of the group, and the new K/V rows where this
  //    split writes them (split 0) or reads them (the hit slot is its own)
  const int n_rows = G + (need_new ? 2 : 0);
  for (int t = tid; t < n_rows * hd; t += kAttnThreads) {
    const int which = t >> lhd, i = t & (hd - 1);
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
      if (writer) kn[o] = v;
    } else {
      vr[i] = v;
      if (writer) vn[o] = v;
    }
  }

  // 2. the live slots in slot order: rowoff[j] the j-th one's rows' offset
  //    in the cache (K and V share the layout), -1 for the current slot,
  //    whose rows are the new ones; masked[j] for a masked slot (idle rows)
  int n_live = 0;
  for (int s0 = c0; s0 < c1; s0 += kAttnThreads) {
    const int s = s0 + tid;
    int kp = kp0, pg = pg0;
    if (s0 != c0 && s < c1) {
      kp = kpos[static_cast<size_t>(b) * S + s];
      if (tbl != nullptr) pg = tbl[static_cast<size_t>(b) * mb + s / bs];
    }
    bool take = false, valid = false;
    if (s < c1) {
      if (s == slot) {
        valid = take = true;  // p >= 0 here: a hit exists only for p >= 0
      } else {
        valid = kp >= 0 && kp <= p && (window <= 0 || kp > p - window);
        take = valid || full;
      }
    }
    const unsigned ball = __ballot_sync(0xffffffffu, take);
    if (lane == 0) warp_cnt[warp] = __popc(ball);
    __syncthreads();
    int off = n_live, tot = 0;
    for (int w = 0; w < kAttnWarps; ++w) {
      if (w < warp) off += warp_cnt[w];
      tot += warp_cnt[w];
    }
    if (take) {
      const int j = off + __popc(ball & ((1u << lane) - 1u));
      masked[j] = !valid;
      long long row = -1;
      if (s != slot) {
        const long long r = tbl != nullptr
            ? static_cast<long long>(pg) * bs + s % bs
            : static_cast<long long>(b) * S + s;
        row = (r * nkv + h) * hd;
      }
      rowoff[j] = row;
    }
    n_live += tot;
    __syncthreads();  // warp_cnt is written again; q, the list are complete
  }
  if (n_live == 0) {  // merges as empty: o = 0, m = -inf, l = 0
    if (splits > 1) {
      for (int t = tid; t < G * hd; t += kAttnThreads) wsb[t] = 0.0f;
      if (tid < G) {
        wsb[G * hd + tid] = __uint_as_float(0xff800000u);
        wsb[G * hd + G + tid] = 0.0f;
      }
    }
    return;
  }

  // q in registers: lane's four elements 4 * lane .. + 3 of every head
  const bool lane_in = 4 * lane < hd;
  float4 qreg[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g)
    qreg[g] = (g < G && lane_in) ? *reinterpret_cast<const float4*>(q + g * hd + 4 * lane)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // PV: thread's dim i0 and heads gq + k * gstep (gstep == 1 at hd = 128)
  const int gstep = kAttnThreads >> lhd;
  const int i0 = tid & (hd - 1), gq = tid >> lhd;
  float acc[GM];
#pragma unroll
  for (int k = 0; k < GM; ++k) acc[k] = 0.0f;

  // 3. stream the live K tiles then the live V tiles through the ring
  const int n_tiles = (n_live + kAttnTile - 1) / kAttnTile;
  const int n_items = 2 * n_tiles;
  const int lq = lhd - 2;  // log2 of the 16-byte pieces a row
  const int piece = tid & ((1 << lq) - 1), r_first = tid >> lq;
  const int r_step = kAttnThreads >> lq;
  auto issue = [&](int item) {
    if (item < n_items) {
      const bool is_v = item >= n_tiles;
      const int t = is_v ? item - n_tiles : item;
      const float* const cache = (is_v ? vc : kc) + 4 * piece;
      float* const dst = ring + (item % kAttnRing) * kAttnTile * hd + 4 * piece;
      for (int r = r_first; r < kAttnTile; r += r_step) {
        const int j = t * kAttnTile + r;
        if (j >= n_live) break;
        const long long off = rowoff[j];
        if (off >= 0) cp_async16(dst + r * hd, cache + off);
      }
    }
    cp_async_commit();  // one group an item, empty or not
  };
#pragma unroll
  for (int it = 0; it < kAttnRing - 1; ++it) issue(it);
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait_ring();
    __syncthreads();  // item `it` has landed; the slot of it - 1 is free
    issue(it + kAttnRing - 1);
    const float* const tile = ring + (it % kAttnRing) * kAttnTile * hd;
    if (it < n_tiles) {  // scores of tile `it`: a warp a row
      const int rows = min(kAttnTile, n_live - it * kAttnTile);
      for (int r = warp; r < rows; r += kAttnWarps) {
        const int j = it * kAttnTile + r;
        const float* const krow = rowoff[j] < 0 ? kr : tile + r * hd;
        float part[N];
#pragma unroll
        for (int g = 0; g < N; ++g) part[g] = 0.0f;
        if (lane_in) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + 4 * lane);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            part[g] = fmaf(qreg[g].x, kv.x, part[g]);
            part[g] = fmaf(qreg[g].y, kv.y, part[g]);
            part[g] = fmaf(qreg[g].z, kv.z, part[g]);
            part[g] = fmaf(qreg[g].w, kv.w, part[g]);
          }
        }
        warp_sum_scatter<N>(part);
        constexpr int kLow = 32 / N;  // lanes that share one head's sum
        const int g = lane / kLow;
        if ((lane & (kLow - 1)) == 0 && g < G)
          sc[j * kMaxGroup + g] = __fadd_rn(__fmul_rn(part[0], scale),
                                            masked[j] ? -1e30f : 0.0f);
      }
      if (it == n_tiles - 1) {  // softmax statistics of the chunk: a warp a head
        __syncthreads();
        for (int g = warp; g < G; g += kAttnWarps) {
          float m = __uint_as_float(0xff800000u);
          for (int j = lane; j < n_live; j += 32) m = fmaxf(m, sc[j * kMaxGroup + g]);
          m = warp_max(m);
          float sum = 0.0f;
          for (int j = lane; j < n_live; j += 32) {
            const float ex = expf(sc[j * kMaxGroup + g] - m);
            sc[j * kMaxGroup + g] = ex;
            sum += ex;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            stat[g] = m;
            stat[kMaxGroup + g] = sum;
          }
        }
      }
    } else {  // o += e * V over tile it - n_tiles, threads over (g, i)
      const int t = it - n_tiles;
      const int rows = min(kAttnTile, n_live - t * kAttnTile);
      for (int r = 0; r < rows; ++r) {
        const int j = t * kAttnTile + r;
        const float v = (rowoff[j] < 0 ? vr : tile + r * hd)[i0];
        if (gstep == 1) {  // every head: the row's weights as float4s
          float e[(GM + 3) / 4 * 4];
#pragma unroll
          for (int c = 0; c < (GM + 3) / 4; ++c) {
            const float4 e4 = reinterpret_cast<const float4*>(sc + j * kMaxGroup)[c];
            e[4 * c] = e4.x;
            e[4 * c + 1] = e4.y;
            e[4 * c + 2] = e4.z;
            e[4 * c + 3] = e4.w;
          }
#pragma unroll
          for (int k = 0; k < GM; ++k) acc[k] = fmaf(e[k], v, acc[k]);
        } else {
#pragma unroll
          for (int k = 0; k < GM; ++k) {
            const int g = gq + k * gstep;
            if (g < G) acc[k] = fmaf(sc[j * kMaxGroup + g], v, acc[k]);
          }
        }
      }
    }
  }

  // 4. the split's result
#pragma unroll
  for (int k = 0; k < GM; ++k) {
    const int g = gq + k * gstep;
    if (g >= G) continue;
    if (splits == 1)
      att[(static_cast<size_t>(h * G + g) * hd + i0) * B + b] =
          __fdiv_rn(acc[k], stat[kMaxGroup + g]);
    else
      wsb[g * hd + i0] = acc[k];
  }
  if (splits > 1 && tid < G) {
    wsb[G * hd + tid] = stat[tid];
    wsb[G * hd + G + tid] = stat[kMaxGroup + tid];
  }
}

// grid (G, nkv, B), kAttnThreads threads: merges the splits of one (row,
// query head) in split order.  Dynamic shared memory: each split's weight
// exp(m_s - M) [splits] and the sum of weights [1].
__global__ void __launch_bounds__(kAttnThreads)
split_attention_merge_kernel(const float* __restrict__ ws,
                             float* __restrict__ att, int B, int nkv, int G,
                             int hd, int splits) {
  extern __shared__ float fac[];
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t stride = static_cast<size_t>(G) * (hd + 2);
  const float* const w = ws + (static_cast<size_t>(b) * nkv + h) * splits * stride;
  const float* const stats = w + static_cast<size_t>(G) * hd;  // + s * stride
  if (tid < 32) {  // one warp: the largest m of a non-empty split, weights, l
    float m = __uint_as_float(0xff800000u);
    for (int s = lane; s < splits; s += 32)
      if (stats[s * stride + G + g] > 0.0f) m = fmaxf(m, stats[s * stride + g]);
    m = warp_max(m);
    float l = 0.0f;
    for (int s = lane; s < splits; s += 32) {
      const float ls = stats[s * stride + G + g];
      const float f = ls > 0.0f ? expf(stats[s * stride + g] - m) : 0.0f;
      fac[s] = f;
      l = fmaf(ls, f, l);
    }
    l = warp_sum(l);
    if (lane == 0) fac[splits] = l;
  }
  __syncthreads();
  const float l = fac[splits];
  for (int i = tid; i < hd; i += kAttnThreads) {
    const float* const col = w + static_cast<size_t>(g) * hd + i;
    float o = 0.0f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) o = fmaf(col[s * stride], fac[s], o);
    att[(static_cast<size_t>(h * G + g) * hd + i) * B + b] = __fdiv_rn(o, l);
  }
}

}  // namespace

// x, out [d, B] float32; w [d] or null; cols (a power of two <= 32),
// split (blocks a cluster over the rows, 1 to 8) and threads (a multiple of
// 32 and of cols, at most 1024) from layer_plan.plan_norm; 16-byte copies
// where B and cols are multiples of 4 and x and out are 16-byte aligned.
extern "C" int repro_step_norm(const void* x, const void* w, void* out, int d,
                               int B, int cols, int split, int threads,
                               int mode, float eps, void* stream) {
  int lw = 0;
  while ((1 << lw) < cols) ++lw;
  if (d <= 0 || B <= 0 || (mode != 0 && mode != 1) || cols > 32 ||
      (1 << lw) != cols || split < 1 || split > 8 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || threads % cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (d + split - 1) / split;
  const size_t smem =
      (static_cast<size_t>(rows) * cols + static_cast<size_t>(threads / 32) * cols +
       2 * static_cast<size_t>(split) * cols + 2 * cols) *
      sizeof(float);
  if (smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = B % 4 == 0 && cols % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B + cols - 1) / cols),
                     static_cast<unsigned>(split), 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(split);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto launch = [&](auto kernel) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                             static_cast<const float*>(w),
                             static_cast<float*>(out), d, B, lw, rows, mode,
                             eps);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  };
  return static_cast<int>(vec ? launch(step_norm_kernel<true>)
                              : launch(step_norm_kernel<false>));
}

// kc/vc/kpos point at the layer's cache (contiguous [B, S, Hkv, hd] or, with
// tbl, the pool [Nb, bs, Hkv, hd]) and kn/vn at the layer's [B, Hkv, hd] rows;
// cos/sin may be null (no RoPE); window <= 0: no sliding window.  splits and
// chunk come from layer_plan.plan_attention; ws holds [B, Hkv, splits, G *
// (hd + 2)] floats when splits > 1 (else unused).  Launches the split kernel
// and, for several splits, the merge kernel.
extern "C" int repro_split_attention(const void* qkv, const void* pos,
                                     const void* cosv, const void* sinv,
                                     const void* kc, const void* vc,
                                     const void* kpos, const void* tbl,
                                     void* att, void* kn, void* vn, void* ws,
                                     int B, int S, int nq, int nkv, int hd,
                                     int bs, int mb, int window, int splits,
                                     int chunk, float scale, void* stream) {
  if (B <= 0 || S <= 0 || nkv <= 0 || nq % nkv != 0 || nq / nkv > kMaxGroup ||
      hd < 4 || hd > 128 || (hd & (hd - 1)) != 0 || splits <= 0 ||
      chunk <= 0 || static_cast<long long>(splits) * chunk < S ||
      static_cast<long long>(splits - 1) * chunk >= S ||
      (splits > 1 && ws == nullptr) ||
      (tbl != nullptr && (bs <= 0 || mb * bs < S)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = nq / nkv;
  int lhd = 0;
  while ((1 << lhd) < hd) ++lhd;
  const size_t smem = attention_smem_floats(G, hd, chunk) * sizeof(float);
  const size_t merge_smem = (static_cast<size_t>(splits) + 1) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxDynamicSmem) ||
      merge_smem > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(splits, nkv, B);
  auto launch = [&](auto kernel) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kAttnThreads, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<const int32_t*>(pos),
        static_cast<const float*>(cosv), static_cast<const float*>(sinv),
        static_cast<const float*>(kc), static_cast<const float*>(vc),
        static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(tbl),
        static_cast<float*>(att), static_cast<float*>(kn),
        static_cast<float*>(vn), static_cast<float*>(ws), B, S, nq, nkv, hd,
        lhd, bs, mb, window, chunk, scale);
    return cudaGetLastError();
  };
  // one instantiation a group size: registers sized to it
  cudaError_t err;
  switch (G) {
    case 1: err = launch(split_attention_kernel<1>); break;
    case 2: err = launch(split_attention_kernel<2>); break;
    case 3: err = launch(split_attention_kernel<3>); break;
    case 4: err = launch(split_attention_kernel<4>); break;
    case 5: err = launch(split_attention_kernel<5>); break;
    case 6: err = launch(split_attention_kernel<6>); break;
    case 7: err = launch(split_attention_kernel<7>); break;
    default: err = launch(split_attention_kernel<8>); break;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  split_attention_merge_kernel<<<dim3(G, nkv, B), kAttnThreads, merge_smem, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(att), B, nkv, G, hd,
      splits);
  return static_cast<int>(cudaGetLastError());
}
