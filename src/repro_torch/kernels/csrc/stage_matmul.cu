// stage_matmul — one layer-plan stage on Hopper (sm_90a): every compressed
// site that reads one activation (q+k+v, gate+up, o, down) evaluated as one
// set of shift-add streams, src [D_src, B] -> out [O, B], for nl layers.
//
// Replaces the Pallas TPU kernel `stage_matmul` (body `_stage_apply` /
// `_stage_apply_seg`) of src/repro/kernels/layer_plan.py, and the stage
// evaluations inside `step_plan_matmul` and `moe_plan_matmul` there, with
// the MoE dispatch before the experts' gate/up stage (lines 350-354), the
// SwiGLU after the gate/up stages (lines 356, 414, 454) and the MoE combine
// after the down stage (lines 358-365) that those bodies run.
//
// What it computes, per layer (the PackedStage contract of kernels/ops.py):
//   prep      inbuf[t] = sum of src[s'] over the pairs (s', t)
//   levels    row r of level p = sum_s sign * 2^exp * buf[gidx[p, r, s]];
//             level 0 reads inbuf, later levels the previous level's rows
//   output    out[o] = resid[o] + ((((sum over the slices of o's site of the
//             slice's last-level row o - out_off) + fs_mat @ inbuf)
//             + dw_mat @ src) + bias[o])
// where src is the dense input [D, B] or, in the gathered-input mode, the
// MoE dispatch's values read from h2 (below).  The output map — sites
// (disjoint output ranges), each a list of FP slices whose rows [row0, row0
// + odim) feed its outputs in order — is derived from the stage's `outg`
// table once at upload (layer_plan.stage_slices) and checked against it
// there; `outg` is not read here.
//
// Bound by bytes on this card.  Every live term is read once (int32 index +
// int8 exponent + int8 sign = 6 bytes) for one fused multiply-add per batch
// column, so at decode batch widths the streams set the time.
//
// What the design does about it.
//  * The unit of work is a chunk of consecutive slices of one site.  Block
//    (b, u) runs each slice of chunk u through its live levels (`depth`,
//    identity levels after it never run) with the running rows in two
//    [N, BB] float32 buffers in shared memory (the body of lcc_chain.cuh:
//    planes of four columns, so row gathers and stores spread over the
//    banks), then adds the slice's rows [0, odim) into per-thread register
//    sums, in slice order.  The last level never goes to device memory;
//    each block writes its site's rows of `partial` once.
//  * The term streams are staged in shared memory by cp.async: a work item
//    is a tile of `tile` rows of one level of one slice, and a ring of
//    `stages` slots keeps the next items' copies in flight while the block
//    computes the current one.  Two warps issue every copy and compute no
//    row.  A row's S = 4 slots (the fused levels of S = 2 chains) come from
//    the slot in one 16-byte index load and one 4-byte load each of
//    exponents and signs.
//  * Rows are fixed to threads (thread t owns rows t, t + T, ...), two rows
//    a step with their terms interleaved; a term with sign 0 multiplies row
//    0 by 0 instead of branching, so every load of a step can issue at once.
//    The thread that computes a row of the last level folds it, so the fold
//    needs no barrier.  A folded row whose `outg` entry reads the zero row
//    (a bit of the slice's mask) adds nothing.
//  * Determinism.  Blocks run in no order, so nothing is accumulated across
//    blocks in place: the epilogue sums a site's chunks in chunk order.
//    Weight sharing makes prep targets repeat; the pairs are sorted by target
//    once at upload (stable) and thread (t, b) sums its target's pairs in
//    that order.  No float atomics anywhere: the result does not depend on
//    scheduling.
//  * Geometry (layer_plan.plan_stage, the K1/K2 planner's rules): 512 row
//    threads (256 where two blocks fit an SM) and the two copy warps, BB the
//    widest batch width whose sums (rows a thread x BB <= 32) and buffers
//    plus ring fit, planned for each site at its longest slice (mixtral's
//    1024-row k and v at BB = 8 beside its 6144-row q at BB = 2); sites of
//    one geometry share a launch of one wave of chunks, dealt over them by
//    their work (layer_plan.plan_units).  The column block is the fastest grid axis:
//    the blocks that share a chunk's streams run side by side and meet them
//    in L2.
//  * The epilogue gives each output element four threads, which split the
//    dense blocks' dot products (fs_mat, dw_mat: a GEMV loop is enough at
//    B <= 16) and add their partial sums by shuffles in a fixed order; the
//    residual add of the decode step folds into it.
//  * The elementwise kernels around a stage in the decode step have no
//    launch of their own: each was pure launch latency (6-8 us for a few
//    hundred KB), and the stage already reads or forms every value they
//    touch.  In its gated mode the epilogue writes SwiGLU's output (silu of
//    the gate row times the up row) in place of the [2 n, B] gate/up rows;
//    in its combining mode x plus each token's weighted sum of its k
//    experts' outputs in place of the [E * d, cap] expert outputs, forming
//    only the k * d * T values the tokens read.  In its gathered-input mode
//    (independent of the output modes) the stage reads the MoE dispatch's
//    [E * d, cap] expert input where it stands, in h2 [d, T] through the
//    route's source token of each slot: src[e * d + i, c] is h2[i, src_tok[e
//    * cap + c]], or 0 for an empty slot (src_tok -1), so the dispatch is
//    never written.  The prep keeps its thread map (b fastest: neighbouring
//    threads read neighbouring src_tok entries, 128 B at mixtral's width,
//    through the read-only cache; h2, 196 KB, every block meets in L2).  Each
//    mode gives the separate kernels' bits: the same floats are summed in
//    the same order.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lcc_chain.cuh"

namespace repro_torch {
namespace {

// The gathered-input mode's operands (h2 null: the dense mode, src [nl, D,
// B]).  One layer, D = E * d, B = cap: src[e * d + i, c] reads as
// src_at(g, e * d + i, c).
struct Gather {
  const float* h2;          // [d, T]
  const int32_t* src_tok;   // [E * cap], -1 for an empty slot
  int d, T;
};

// The expert input at row k, column b: what the MoE dispatch wrote there.
__device__ __forceinline__ float src_at(const Gather& g, int k, int b,
                                        int cap) {
  const int e = k / g.d;
  const int i = k - e * g.d;
  const int tok = __ldg(g.src_tok + static_cast<size_t>(e) * cap + b);
  return tok >= 0 ? __ldg(g.h2 + static_cast<size_t>(i) * g.T + tok) : 0.0f;
}

// inbuf[l, t, b] = sum_{i in [off[l, t], off[l, t + 1])} src[l, ssrc[l, i], b]
// in pair order from 0; kGathered reads src through g (nl = 1).
template <bool kGathered>
__global__ void stage_prep_kernel(const float* __restrict__ src, Gather g,
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
  float acc = 0.0f;
  if constexpr (kGathered) {
    for (int j = o[t]; j < o[t + 1]; ++j) acc += src_at(g, s[j], b, B);
  } else {
    const float* const x = src + static_cast<size_t>(l) * D * B + b;
    for (int j = o[t]; j < o[t + 1]; ++j)
      acc += x[static_cast<size_t>(s[j]) * B];
  }
  inbuf[i] = acc;
}

// One work item: tile q of level p of slice e (global slice index); the
// slice's row0, rows n, levels depth, tiles nq and mask word hole.
struct StageItem {
  int e, p, q, row0, n, depth, nq, hole;
};

__device__ __forceinline__ void load_slice(StageItem& it,
                                           const int4* __restrict__ slices,
                                           int tile) {
  const int4 s = __ldg(slices + it.e);
  it.row0 = s.x;
  it.n = s.y;
  it.depth = s.z;
  it.hole = s.w;
  it.nq = (s.y + tile - 1) / tile;
}

__device__ __forceinline__ void next_item(StageItem& it, int e1,
                                          const int4* __restrict__ slices,
                                          int tile) {
  if (++it.q < it.nq) return;
  it.q = 0;
  if (++it.p < it.depth) return;
  it.p = 0;
  if (++it.e < e1) load_slice(it, slices, tile);
}

// Issues the copies of item `it` (layer l) into ring slot `slot`.
__device__ __forceinline__ void stage_tile(
    const StageItem& it, char* slot, const int32_t* __restrict__ idx,
    const int8_t* __restrict__ exp, const int8_t* __restrict__ sign, int l,
    int P, int R, int S, int tile, int tid, int nthreads) {
  const int r0 = it.q * tile;
  const int rows = min(tile, it.n - r0);
  const size_t t0 =
      ((static_cast<size_t>(l) * P + it.p) * R + it.row0 + r0) *
      static_cast<size_t>(S);
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

// grid (ceil(B / BB), NU), threads + kCopyThreads <= MAXT threads:
// `threads` own the rows, the last two warps issue the copies; dynamic
// shared memory buffer_bytes(N, BB) + stages * slot_bytes(tile, S).  MAXR >=
// ceil(N / threads) rows a thread; tile is a multiple of `threads` (or
// covers N).
// units[u] = (layer from the first, first slice, end slice, first row of
// partial, the site's width odim).
template <int BB, int MAXR, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
stage_chain_kernel(const int32_t* __restrict__ idx,
                   const int8_t* __restrict__ exp,
                   const int8_t* __restrict__ sign,
                   const float* __restrict__ inbuf,      // [nl, K, B]
                   const int4* __restrict__ slices,      // [E] row0 n depth hole
                   const uint32_t* __restrict__ holes,   // zero-row masks
                   const int32_t* __restrict__ units,    // [NU, 5]
                   float* __restrict__ partial,          // [rows, B]
                   int K, int P, int R, int S, int B, int N, int tile,
                   int stages) {
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + static_cast<size_t>(N) * BB;
  char* const ring = reinterpret_cast<char*>(smem) + buffer_bytes(N, BB);
  const size_t sbytes = slot_bytes(tile, S);
  const size_t ri = region_bytes(static_cast<size_t>(tile) * S * 4);
  const size_t rb = region_bytes(static_cast<size_t>(tile) * S);

  const int b0 = blockIdx.x * BB;
  const int32_t* const unit = units + static_cast<size_t>(blockIdx.y) * 5;
  const int l = unit[0];
  const int e0 = unit[1];
  const int e1 = unit[2];
  const int prow = unit[3];
  const int odim = unit[4];
  const int tid = threadIdx.x;
  const int T = blockDim.x - kCopyThreads;  // row threads; then copiers
  const bool copier = tid >= T;
  const float* const in_l = inbuf + static_cast<size_t>(l) * K * B;
  // the batch columns of this block are whole and 16-byte aligned in inbuf
  const bool x_vec = (BB % 4 == 0) && (B % 4 == 0) && (b0 + BB <= B);

  float sums[MAXR][BB];
#pragma unroll
  for (int i = 0; i < MAXR; ++i)
#pragma unroll
    for (int k = 0; k < BB; ++k) sums[i][k] = 0.0f;

  // prologue: items 0 .. stages-2 in flight
  StageItem pf{e0, 0, 0, 0, 0, 0, 0, -1};
  if (e0 < e1) load_slice(pf, slices, tile);
  StageItem cur = pf;
  for (int s = 0; s < stages - 1; ++s) {
    if (pf.e < e1) {
      if (copier)
        stage_tile(pf, ring + s * sbytes, idx, exp, sign, l, P, R, S, tile,
                   tid - T, kCopyThreads);
      next_item(pf, e1, slices, tile);
    }
    cp_async_commit();
  }

  for (int i = 0; cur.e < e1; ++i) {
    // the copy warps' copies of item i have landed; the barrier makes them
    // visible, ends every read of item i-1 (so its slot may be refilled)
    // and every write of the level before.  The row threads issue no
    // copies, so their wait returns at once
    cp_async_wait(stages - 2);
    __syncthreads();
    if (pf.e < e1) {
      if (copier)
        stage_tile(pf, ring + ((i + stages - 1) % stages) * sbytes, idx, exp,
                   sign, l, P, R, S, tile, tid - T, kCopyThreads);
      next_item(pf, e1, slices, tile);
    }
    cp_async_commit();

    const char* const slot = ring + (i % stages) * sbytes;
    const int r0 = cur.q * tile;
    const int rows = min(tile, cur.n - r0);
    const size_t t0 =
        ((static_cast<size_t>(l) * P + cur.p) * R + cur.row0 + r0) *
        static_cast<size_t>(S);
    // where stage_bytes put each stream in the slot
    const int32_t* const s_idx = reinterpret_cast<const int32_t*>(
        slot + (reinterpret_cast<uintptr_t>(idx + t0) & 15u));
    const int8_t* const s_exp = reinterpret_cast<const int8_t*>(
        slot + ri + (reinterpret_cast<uintptr_t>(exp + t0) & 15u));
    const int8_t* const s_sign = reinterpret_cast<const int8_t*>(
        slot + ri + rb + (reinterpret_cast<uintptr_t>(sign + t0) & 15u));
    const int p = cur.p;
    const int base = cur.row0;  // later levels read absolute rows
    const float* const src = (p & 1) ? buf0 : buf1;
    float* const dst = (p & 1) ? buf1 : buf0;
    // one term: acc += sign * 2^exp * (inbuf[j] or src[j - base]).  A term
    // with sign 0 adds coef 0 times the slice's first row, so every load
    // can issue before any sign is known (fma(0, v, acc) == acc for finite v)
    auto term = [&](int sg, int j, int ex, float (&acc)[BB]) {
      const float coef = sg ? signed_pow2(sg, ex) : 0.0f;
      float v[BB];
      if (p == 0) {
        const float* const xr = in_l + static_cast<size_t>(sg ? j : 0) * B + b0;
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
      } else {
        load_row<BB>(src, N, sg ? j - base : 0, v);
      }
#pragma unroll
      for (int k = 0; k < BB; ++k) acc[k] = fmaf(coef, v[k], acc[k]);
    };
    const bool quad = S == 4 &&
        ((reinterpret_cast<uintptr_t>(s_exp) | reinterpret_cast<uintptr_t>(s_sign)) &
         3u) == 0 &&
        (reinterpret_cast<uintptr_t>(s_idx) & 15u) == 0;
    // two rows a step, their terms interleaved
    for (int r = copier ? rows : tid; r < rows; r += 2 * T) {
      const int r2 = r + T;
      const bool two = r2 < rows;
      float a0[BB], a1[BB];
#pragma unroll
      for (int k = 0; k < BB; ++k) { a0[k] = 0.0f; a1[k] = 0.0f; }
      if (quad) {
        const int4 j0 = reinterpret_cast<const int4*>(s_idx)[r];
        const char4 x0 = reinterpret_cast<const char4*>(s_exp)[r];
        const char4 g0 = reinterpret_cast<const char4*>(s_sign)[r];
        int4 j1 = make_int4(0, 0, 0, 0);
        char4 x1 = make_char4(0, 0, 0, 0), g1 = make_char4(0, 0, 0, 0);
        if (two) {
          j1 = reinterpret_cast<const int4*>(s_idx)[r2];
          x1 = reinterpret_cast<const char4*>(s_exp)[r2];
          g1 = reinterpret_cast<const char4*>(s_sign)[r2];
        }
        term(g0.x, j0.x, x0.x, a0);
        term(g1.x, j1.x, x1.x, a1);
        term(g0.y, j0.y, x0.y, a0);
        term(g1.y, j1.y, x1.y, a1);
        term(g0.z, j0.z, x0.z, a0);
        term(g1.z, j1.z, x1.z, a1);
        term(g0.w, j0.w, x0.w, a0);
        term(g1.w, j1.w, x1.w, a1);
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
    if (cur.p == cur.depth - 1 && cur.q == cur.nq - 1) {
      // the slice is done: fold its rows [0, odim) into the sums; every
      // row was written by the thread that owns it, so no barrier is needed
      const int hole = cur.hole;
#pragma unroll
      for (int ri2 = 0; ri2 < MAXR; ++ri2) {
        const int n = ri2 * T + tid;
        if (!copier && n < odim &&
            (hole < 0 || !((__ldg(holes + hole + (n >> 5)) >> (n & 31)) & 1u))) {
          float v[BB];
          load_row<BB>(dst, N, n, v);
#pragma unroll
          for (int k = 0; k < BB; ++k) sums[ri2][k] += v[k];
        }
      }
    }
    next_item(cur, e1, slices, tile);
  }
  cp_async_wait(0);

  float* const out = partial + static_cast<size_t>(prow) * B + b0;
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int n = i * T + tid;
    if (!copier && n < odim) {
      float* const o = out + static_cast<size_t>(n) * B;
#pragma unroll
      for (int k = 0; k < BB; ++k)
        if (b0 + k < B) o[k] = sums[i][k];
    }
  }
}

constexpr int kLanes = 4;  // epilogue threads per output element

// sum over the kLanes neighbouring lanes of one output, in fixed order
__device__ __forceinline__ float lanes_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The epilogue's operands.  mode: kPlain, kGated or kCombine (below);
// combine's x [d, T], slot/wgt [T, k] and E, k, cap, T (B = cap); g.h2
// non-null: dw reads its input through g.
struct EpiArgs {
  const float* partial;
  const int4* esites;
  const int32_t* ebegin;
  const float* inbuf;
  const float* src;
  Gather g;
  const float* fs;
  const float* dw;
  const float* bias;
  const float* resid;
  const float* x;
  const int32_t* slot;
  const float* wgt;
  float* out;
  int nl, D, B, K, O, mode, E, k, cap, T;
};

constexpr int kPlain = 0;    // out [O, B] (+ resid)
constexpr int kGated = 1;    // out [O / 2, B] = silu(v[:O/2]) * v[O/2:]
constexpr int kCombine = 2;  // out [d, T] = x + the gated sum of v, d = O / E

// v(l, o, b) = (((chunk sums) + fs @ inbuf) + dw @ src) + bias, in lane 0
// of the output's kLanes lanes (the other lanes return partial values).
// Lane 0 finds the output's site (binary search over the layer's sites,
// esites[s] = out_off, odim, first partial row, chunks) and sums the site's
// chunks in chunk order; the lanes split the dot products' k (interleaved)
// and combine their partial sums by shuffles, so every lane of the warp
// calls this, with live false where it has no output.
__device__ __forceinline__ float stage_value(const EpiArgs& a, bool live,
                                             int q, int l, int o, int b) {
  float acc = 0.0f;
  if (live && q == 0 && a.partial != nullptr) {
    const int first = a.ebegin[l];
    int lo = first, hi = a.ebegin[l + 1];
    while (lo < hi) {  // the last site with out_off <= o
      const int mid = (lo + hi) >> 1;
      if (a.esites[mid].x <= o) lo = mid + 1; else hi = mid;
    }
    if (lo > first) {
      const int4 s = a.esites[lo - 1];
      if (o < s.x + s.y) {
        const float* p =
            a.partial + (static_cast<size_t>(s.z) + (o - s.x)) * a.B + b;
        const size_t step = static_cast<size_t>(s.y) * a.B;
        for (int c = 0; c < s.w; ++c) acc += p[c * step];
      }
    }
  }
  if (a.fs != nullptr) {
    float f = 0.0f;
    if (live) {
      const float* const row = a.fs + (static_cast<size_t>(l) * a.O + o) * a.K;
      const float* const x = a.inbuf + static_cast<size_t>(l) * a.K * a.B + b;
      for (int k = q; k < a.K; k += kLanes)
        f = fmaf(row[k], x[static_cast<size_t>(k) * a.B], f);
    }
    acc += lanes_sum(f);
  }
  if (a.dw != nullptr) {
    float f = 0.0f;
    if (live) {
      const float* const row = a.dw + (static_cast<size_t>(l) * a.O + o) * a.D;
      if (a.g.h2 != nullptr) {
        for (int k = q; k < a.D; k += kLanes)
          f = fmaf(row[k], src_at(a.g, k, b, a.B), f);
      } else {
        const float* const x = a.src + static_cast<size_t>(l) * a.D * a.B + b;
        for (int k = q; k < a.D; k += kLanes)
          f = fmaf(row[k], x[static_cast<size_t>(k) * a.B], f);
      }
    }
    acc += lanes_sum(f);
  }
  if (live && a.bias != nullptr) acc += a.bias[static_cast<size_t>(l) * a.O + o];
  return acc;
}

// kLanes threads an output element i of the mode's output [nl, rows, cols]:
//  * kPlain: out[l, o, b] = resid[o, b] + v(l, o, b) (resid may be null);
//  * kGated (K7's SwiGLU): out[l, j, b] = silu(g) * u with g = v(l, j, b),
//    u = v(l, O / 2 + j, b), the expression of the step's former SwiGLU
//    kernel letter for letter;
//  * kCombine (K8's combine, nl = 1): out[r, t] = x[r, t] + y, y summing
//    wgt[t, j] * v(0, e_j * d + r, c_j) over the kept choices j in order,
//    (e_j, c_j) = divmod(slot[t, j], cap), with round-to-nearest multiplies
//    and adds.  The outputs of one warp can keep different numbers of
//    choices, and v shuffles across the warp, so every lane runs all k
//    choices (a dropped one only takes part in the shuffles and reads no
//    slot) and a kept choice's term is taken by a select: multiplying a
//    dropped one by 0 would turn an infinite v into NaN.
__global__ void stage_epilogue_kernel(EpiArgs a) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int q = static_cast<int>(t % kLanes);
  const size_t i = t / kLanes;
  const int rows = a.mode == kGated ? a.O / 2
                   : a.mode == kCombine ? a.O / a.E : a.O;
  const int cols = a.mode == kCombine ? a.T : a.B;
  const size_t per = static_cast<size_t>(rows) * cols;
  const bool live = i < static_cast<size_t>(a.nl) * per;  // whole warps shuffle
  const size_t ii = live ? i : 0;
  const int l = static_cast<int>(ii / per);
  const size_t rem = ii - l * per;
  const int o = static_cast<int>(rem / cols);
  const int b = static_cast<int>(rem - static_cast<size_t>(o) * cols);
  if (a.mode == kGated) {
    const float g = stage_value(a, live, q, l, o, b);
    const float u = stage_value(a, live, q, l, rows + o, b);
    if (!live || q != 0) return;
    const float silu = __fdiv_rn(g, 1.0f + expf(-g));
    a.out[i] = __fmul_rn(silu, u);
    return;
  }
  if (a.mode == kCombine) {
    float y = 0.0f;
    for (int j = 0; j < a.k; ++j) {
      const int s = live ? a.slot[b * a.k + j] : -1;
      const bool kept = s >= 0 && s < a.E * a.cap;
      const int e = kept ? s / a.cap : 0;
      const int c = kept ? s - e * a.cap : 0;
      const float v = stage_value(a, kept, q, 0, e * rows + o, c);
      if (kept) y = __fadd_rn(y, __fmul_rn(a.wgt[b * a.k + j], v));
    }
    if (!live || q != 0) return;
    a.out[i] = __fadd_rn(a.x[i], y);
    return;
  }
  float acc = stage_value(a, live, q, l, o, b);
  if (!live || q != 0) return;
  if (a.resid != nullptr) acc = a.resid[i] + acc;
  a.out[i] = acc;
}

struct ChainArgs {
  const int32_t* idx;
  const int8_t* exp;
  const int8_t* sign;
  const float* inbuf;
  const int4* slices;
  const uint32_t* holes;
  const int32_t* units;
  float* partial;
  int K, P, R, S, B, NU, N, threads, tile, stages;
};

template <int BB, int MAXR, int MAXT>
cudaError_t launch_stage_bb(const ChainArgs& a, cudaStream_t st) {
  const size_t smem = buffer_bytes(a.N, BB) +
                      static_cast<size_t>(a.stages) * slot_bytes(a.tile, a.S);
  if (smem > static_cast<size_t>(kMaxDynamicSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage_chain_kernel<BB, MAXR, MAXT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + BB - 1) / BB, a.NU);
  stage_chain_kernel<BB, MAXR, MAXT>
      <<<grid, a.threads + kCopyThreads, smem, st>>>(
      a.idx, a.exp, a.sign, a.inbuf, a.slices, a.holes, a.units, a.partial,
      a.K, a.P, a.R, a.S, a.B, a.N, a.tile, a.stages);
  return cudaGetLastError();
}

// The register sums: MAXR rows of BB columns, the smaller of 16 and 32
// floats that holds ceil(N / threads) rows (as launch_chain_rows): blocks
// of at most 512 row threads, except one column a block above 16384 rows,
// which takes up to 960.
template <int BB>
cudaError_t launch_stage_rows(const ChainArgs& a, cudaStream_t st) {
  const int rpt = (a.N + a.threads - 1) / a.threads;
  if (a.threads > 512) {
    if constexpr (BB == 1) {
      if (rpt <= kMaxSums) return launch_stage_bb<1, kMaxSums, 1024>(a, st);
    }
    return cudaErrorInvalidValue;
  }
  if (rpt * BB <= kMaxSums / 2)
    return launch_stage_bb<BB, kMaxSums / 2 / BB, 512 + kCopyThreads>(a, st);
  if (rpt * BB <= kMaxSums)
    return launch_stage_bb<BB, kMaxSums / BB, 512 + kCopyThreads>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// One stage over nl layers (pointers at the first of them): prep, the chain
// kernel once a geometry group, epilogue, all on `stream`.  groups: host
// int32 [ngroups][7] = first unit, units, bb, threads, tile, stages, rows N
// (the group's longest slice).  K = 0: no prep; ngroups = 0: no streams;
// fs/dw/bias/resid may be null.  The input is src [nl, D, B], or (gathered,
// src null: nl = 1, B = cap, D = E * d) h2 [d, T] read through src_tok [E *
// cap].  mode 0 writes out [nl, O, B] (+ resid); mode 1 (gated) out [nl, O
// / 2, B], O even, no resid; mode 2 (combining, nl = 1, B = cap, O = E *
// d') out [d', T] from x [d', T], slot and wgt [T, k], no resid.  Returns
// the first CUDA error (0 = every launch accepted).
extern "C" int repro_stage_matmul(
    const void* src, const void* prep_src, const void* prep_off, void* inbuf,
    const void* gidx, const void* gexp, const void* gsgn, const void* slices,
    const void* holes, const void* units, const void* esites,
    const void* ebegin, void* partial, const void* fs, const void* dw,
    const void* bias, const void* resid, void* out, const void* cx,
    const void* cslot, const void* cwgt, const void* h2, const void* src_tok,
    int nl, int D, int B, int M, int K, int P, int R, int S, int O, int mode,
    int E, int k, int cap, int T, int d, const void* groups, int ngroups,
    void* stream) {
  using namespace repro_torch;
  auto st = static_cast<cudaStream_t>(stream);
  if (nl <= 0 || B <= 0 || O <= 0 || ngroups < 0 || mode < kPlain ||
      mode > kCombine)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kGated && (O % 2 != 0 || resid != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kCombine &&
      (nl != 1 || resid != nullptr || E <= 0 || k <= 0 || cap != B ||
       T <= 0 || O % E != 0 || cx == nullptr || cslot == nullptr ||
       cwgt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool gathered = h2 != nullptr;
  if (gathered ? (nl != 1 || resid != nullptr || src != nullptr ||
                  src_tok == nullptr || E <= 0 || d <= 0 ||
                  static_cast<long long>(E) * d != D || cap != B || T <= 0)
               : (src == nullptr || src_tok != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(src);
  const Gather g{static_cast<const float*>(h2),
                 static_cast<const int32_t*>(src_tok), d, T};
  auto* in = static_cast<float*>(inbuf);
  const int cthreads = 256;
  if (K > 0) {
    const size_t total = static_cast<size_t>(nl) * K * B;
    const unsigned blocks =
        static_cast<unsigned>((total + cthreads - 1) / cthreads);
    const auto* ps = static_cast<const int32_t*>(prep_src);
    const auto* po = static_cast<const int32_t*>(prep_off);
    if (gathered)
      stage_prep_kernel<true><<<blocks, cthreads, 0, st>>>(
          x, g, ps, po, in, nl, D, B, M, K);
    else
      stage_prep_kernel<false><<<blocks, cthreads, 0, st>>>(
          x, g, ps, po, in, nl, D, B, M, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* grp = static_cast<const int32_t*>(groups);
  for (int g = 0; g < ngroups; ++g) {
    const int32_t* const q = grp + 7 * g;
    const int first = q[0], NU = q[1], bb = q[2], threads = q[3],
              tile = q[4], stages = q[5], N = q[6];
    // the ring needs 2..4 slots; a tile is whole rows of every thread (or N)
    if (K <= 0 || P <= 0 || R <= 0 || S <= 0 || N <= 0 || NU <= 0 ||
        NU > 65535 || first < 0 || threads <= 0 ||
        threads + kCopyThreads > 1024 || threads % 32 != 0 || tile <= 0 ||
        (tile < N && tile % threads != 0) || stages < 2 || stages > 4)
      return static_cast<int>(cudaErrorInvalidValue);
    const ChainArgs a{static_cast<const int32_t*>(gidx),
                      static_cast<const int8_t*>(gexp),
                      static_cast<const int8_t*>(gsgn), in,
                      static_cast<const int4*>(slices),
                      static_cast<const uint32_t*>(holes),
                      static_cast<const int32_t*>(units) + 5 * static_cast<size_t>(first),
                      static_cast<float*>(partial), K, P, R, S, B, NU, N,
                      threads, tile, stages};
    cudaError_t err;
    switch (bb) {
      case 8: err = launch_stage_rows<8>(a, st); break;
      case 4: err = launch_stage_rows<4>(a, st); break;
      case 2: err = launch_stage_rows<2>(a, st); break;
      case 1: err = launch_stage_rows<1>(a, st); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const EpiArgs e{ngroups > 0 ? static_cast<const float*>(partial) : nullptr,
                  static_cast<const int4*>(esites),
                  static_cast<const int32_t*>(ebegin), in, x, g,
                  static_cast<const float*>(fs), static_cast<const float*>(dw),
                  static_cast<const float*>(bias),
                  static_cast<const float*>(resid),
                  static_cast<const float*>(cx),
                  static_cast<const int32_t*>(cslot),
                  static_cast<const float*>(cwgt), static_cast<float*>(out),
                  nl, D, B, K, O, mode, E, k, cap, T};
  const size_t outputs = mode == kGated     ? static_cast<size_t>(nl) * (O / 2) * B
                         : mode == kCombine ? static_cast<size_t>(O / E) * T
                                            : static_cast<size_t>(nl) * O * B;
  const size_t total = outputs * kLanes;
  stage_epilogue_kernel<<<static_cast<unsigned>((total + cthreads - 1) / cthreads),
                          cthreads, 0, st>>>(e);
  return static_cast<int>(cudaGetLastError());
}
