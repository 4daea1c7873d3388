// Segment sum over rows: out[s] = sum of data[e] over the rows e with ids[e] == s.
//
// Replaces bignn_tpu/ops/pallas/segment.py:_segment_sum_kernel
// (segment_sum_pallas), used by the sum readout; its permuted form replaces
// the segment_sum_pallas call in the backward of
// bignn_tpu/ops/gather.py:gather_rows_sorted_grad (_gather_sorted_bwd).
//
// The TPU kernel finds each 128-segment block's row range with a
// searchsorted over the ids, so it is only right for sorted ids. The
// block-local readout layout is not sorted: packing gaps between molecules
// carry the padding id num_segments (ROADMAP F1). This kernel is right for
// any ids, and fast when the valid ids are sorted with holes between them:
//   1. bounds: each segment's first and last row (segment_bounds.cuh);
//   2. sum: one warp per segment walks [first, last] in row order and adds
//      the rows whose id equals the segment, in f32. No float atomics, so a
//      result is the same from run to run.
// The permuted form reads row perm[e] of data in place of row e, so the
// gather backward sums g[perm] over ids_sorted without a copy of g[perm].
//
// What bounds it on the H100: device-memory bytes. Every valid row is read
// once (E * F * 4 bytes), plus the ids twice; the arithmetic is one add per
// element. A warp reads a row as 32 consecutive floats, so loads are
// coalesced. Rows inside a segment's range that belong to another segment
// (holes) cost a load of the id only.

#include <cuda_runtime.h>

#include <cstdint>

#include "segment_bounds.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kColsPerLane = 4;  // a warp covers 128 columns per sweep

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sum_segments(const float* __restrict__ data, const int* __restrict__ perm,
                 const int* __restrict__ ids, const int* __restrict__ first,
                 const int* __restrict__ last, int num_segments, int feat,
                 float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_segments) return;
  const int e0 = first[s];
  const int e1 = last[s];  // e1 < e0 for an empty segment
  float* o = out + static_cast<int64_t>(s) * feat;
  for (int f0 = 0; f0 < feat; f0 += 32 * kColsPerLane) {
    float acc[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
    for (int e = e0; e <= e1; ++e) {
      if (__ldg(ids + e) != s) continue;  // a hole or another segment's row
      const int r = perm == nullptr ? e : __ldg(perm + e);
      const float* row = data + static_cast<int64_t>(r) * feat;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int c = f0 + lane + 32 * k;
        if (c < feat) acc[k] += __ldg(row + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = f0 + lane + 32 * k;
      if (c < feat) o[c] = acc[k];
    }
  }
}

int segment_sum(const float* data, const int* perm, const int* ids,
                int num_rows, int feat, int num_segments, int* first,
                int* last, float* out, cudaStream_t st) {
  if (num_segments > 0) {
    bignn::segment_bounds(ids, num_rows, num_segments, first, last, st);
    if (feat > 0) {
      sum_segments<<<bignn::cdiv(num_segments, kWarpsPerBlock),
                     kWarpsPerBlock * 32, 0, st>>>(
          data, perm, ids, first, last, num_segments, feat, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data [num_rows, feat] f32, ids [num_rows] int32, out [num_segments, feat]
// f32; first/last are [num_segments] int32 scratch. Returns cudaGetLastError().
int bignn_segment_sum_f32(const void* data, const void* ids, int num_rows,
                          int feat, int num_segments, void* first, void* last,
                          void* out, void* stream) {
  return segment_sum(static_cast<const float*>(data), nullptr,
                     static_cast<const int*>(ids), num_rows, feat,
                     num_segments, static_cast<int*>(first),
                     static_cast<int*>(last), static_cast<float*>(out),
                     static_cast<cudaStream_t>(stream));
}

// The same sum over rows data[perm[e]]: perm [num_rows] int32 indexes data
// (any number of rows), ids [num_rows] int32 are the ids of the permuted
// rows.
int bignn_segment_sum_perm_f32(const void* data, const void* perm,
                               const void* ids, int num_rows, int feat,
                               int num_segments, void* first, void* last,
                               void* out, void* stream) {
  return segment_sum(static_cast<const float*>(data),
                     static_cast<const int*>(perm),
                     static_cast<const int*>(ids), num_rows, feat,
                     num_segments, static_cast<int*>(first),
                     static_cast<int*>(last), static_cast<float*>(out),
                     static_cast<cudaStream_t>(stream));
}

const char* bignn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
