// cluster_segment_sum — weight-sharing input pre-aggregation (paper eq. (10)):
//   agg[c, b] = sum_{j : labels[j] == c} x[j, b].
//
// Replaces `cluster_segment_sum` / `_kernel` of
// src/repro/kernels/shared_matmul.py (Pallas TPU: one-hot(labels) tile times x
// on the matrix unit, K contracted across a sequential grid axis).
//
// Bound by bytes: x is read once and agg written once, one add per element.
// The labels are sorted once when the site is built (CSR: `order` lists the
// input rows cluster by cluster, `offsets[c] .. offsets[c+1]` is cluster c's
// range), so no one-hot tile and no float atomics are needed: thread (c, b)
// walks its segment in ascending row order and the sum does not depend on
// scheduling.  Neighbouring threads read neighbouring b of the same row.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void cluster_segment_sum_kernel(const int32_t* __restrict__ order,
                                           const int32_t* __restrict__ offsets,
                                           const float* __restrict__ x,
                                           float* __restrict__ out, int C,
                                           int B) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(C) * B) return;
  const int c = static_cast<int>(i / B);
  const int b = static_cast<int>(i - static_cast<size_t>(c) * B);
  float acc = 0.0f;
  for (int j = offsets[c]; j < offsets[c + 1]; ++j)
    acc += x[static_cast<size_t>(order[j]) * B + b];
  out[i] = acc;
}

}  // namespace

extern "C" int repro_cluster_segment_sum(const void* order,
                                         const void* offsets, const void* x,
                                         void* out, int C, int B,
                                         void* stream) {
  if (C <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(C) * B;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cluster_segment_sum_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(offsets),
      static_cast<const float*>(x), static_cast<float*>(out), C, B);
  return static_cast<int>(cudaGetLastError());
}
