// region_prep — the input preparation of one fused region of the per-region
// route in one launch: every member's kept-column gather and weight-sharing
// pre-aggregation (paper eq. (10)),
//   agg[c, b] = sum_{j : labels[j] == c} x[kept[j], b],
// written as the one concatenated [sum_g rows_g, B] float32 input of the
// K1/K2 launch that follows.
//
// Replaces `cluster_segment_sum` / `_kernel` of
// src/repro/kernels/shared_matmul.py (Pallas TPU: one-hot(labels) tile times x
// on the matrix unit, K contracted across a sequential grid axis), and on
// this route also the per-member gathers and the concatenation around it.
//
// What bounds it on this card.  Bound by bytes on paper, and they are few
// (the rows a region reads once, its output written once: about 1.3 us at
// deepseek's 64-expert `moe.up`); what costs is launches and a dependent
// walk.  The design:
//  * One launch a region.  The host composes each member's table once at
//    site build (shared_matmul.member_table): output row r sums the member's
//    input rows src[segptr[r] .. segptr[r+1]) — a weight-shared member's
//    cluster (src = kept[order], the labels sorted stably), a pruned
//    member's one kept column — and concatenates the members' tables.
//    rowinfo[r] = 2 * member + copy names the member (its input is
//    x + member * member_stride: 0 for one shared activation, the expert
//    stride for views of one stacked buffer) and whether the row is a copy.
//  * A thread an output row and up to 8 columns (grid.y over column
//    chunks), blocks over the concatenated rows, so one launch fills the
//    card at every region size.  The thread walks its segment in ascending
//    order and adds in registers: no float atomics, the result does not
//    depend on scheduling, and it equals the per-member plain path bit for
//    bit (index_add_ into zeros from +0.0; a copy starts from -0.0, which
//    leaves every value, signed zeros included, as it is).
//  * Loads follow the input's strides (row_stride, col_stride): for the
//    transposed activation views the callers pass, neighbouring rows are
//    neighbouring addresses, so a warp's loads of one column coalesce where
//    the kept rows are near each other.  bfloat16 inputs are widened as they
//    are read.
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;  // columns a thread

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    region_prep_kernel(const int32_t* __restrict__ src,
                       const int32_t* __restrict__ segptr,
                       const int32_t* __restrict__ rowinfo,
                       const T* __restrict__ x, float* __restrict__ out,
                       int R, int B, long long member_stride,
                       long long row_stride, long long col_stride) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int b0 = blockIdx.y * kCols;
  const int info = rowinfo[r];
  const T* const xm =
      x + (info >> 1) * member_stride + static_cast<long long>(b0) * col_stride;
  const float init = (info & 1) ? -0.0f : 0.0f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = init;
  const int j1 = segptr[r + 1];
  for (int j = segptr[r]; j < j1; ++j) {
    const T* const row = xm + static_cast<long long>(src[j]) * row_stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (b0 + c < B) acc[c] += widen(row[c * col_stride]);
  }
  float* const o = out + static_cast<size_t>(r) * B + b0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (b0 + c < B) o[c] = acc[c];
}

}  // namespace

// out [R, B] float32 row-major; x float32 (bf16 == 0) or bfloat16, read at
// element offsets member * member_stride + row * row_stride + b * col_stride.
extern "C" int repro_region_prep(const void* src, const void* segptr,
                                 const void* rowinfo, const void* x, void* out,
                                 int R, int B, long long member_stride,
                                 long long row_stride, long long col_stride,
                                 int bf16, void* stream) {
  if (R <= 0 || B <= 0 || (bf16 != 0 && bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned col_blocks = static_cast<unsigned>((B + kCols - 1) / kCols);
  if (col_blocks > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((R + kThreads - 1) / kThreads),
                  col_blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(src);
  const auto* p = static_cast<const int32_t*>(segptr);
  const auto* ri = static_cast<const int32_t*>(rowinfo);
  if (bf16)
    region_prep_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        s, p, ri, static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out),
        R, B, member_stride, row_stride, col_stride);
  else
    region_prep_kernel<float><<<grid, kThreads, 0, st>>>(
        s, p, ri, static_cast<const float*>(x), static_cast<float*>(out), R, B,
        member_stride, row_stride, col_stride);
  return static_cast<int>(cudaGetLastError());
}
