// Segment max over rows in float32: out[s] = max of data[e] over the rows e
// with ids[e] == s, and 0 where that is empty or not finite (the rule of the
// JAX package's segment_max, bignn_tpu/ops/segment.py:69-72). A NaN in a
// segment gives NaN, so 0.
//
// Replaces bignn_tpu/ops/pallas/segment.py:_segment_max_kernel
// (segment_max_pallas), used by the max readout. The TPU kernel finds each
// 128-segment block's row range with a searchsorted over the ids, so it is
// right only for sorted ids, and the readout's block-local ids put padding
// runs between molecules (ROADMAP F1, F2). This kernel is right for any ids:
//   1. bounds: each segment's first and last row (segment_bounds.cuh);
//   2. max: one warp per segment walks [first, last] in row order, skips the
//      rows of other segments (holes), and keeps a running max in registers,
//      lanes across F (columns lane + 32 k, 128 a sweep). One store a value.
// Its VJP has no kernel of its own: ops/segment.py composes it as the JAX
// package does (an is-max mask, tie counts by the segment-sum kernel, a
// gather).
//
// What bounds it on the H100: device-memory bytes, each valid row read once
// (E * F * 4) plus the ids; one comparison per element. As for the segment
// sum, the walk is one dependent id load and row load after another.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "segment_bounds.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kColsPerLane = 4;  // a warp covers 128 columns per sweep

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    max_segments(const float* __restrict__ data, const int* __restrict__ ids,
                 const int* __restrict__ first, const int* __restrict__ last,
                 int num_segments, int feat, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_segments) return;
  const int e0 = first[s];
  const int e1 = last[s];  // e1 < e0 for an empty segment
  float* o = out + static_cast<int64_t>(s) * feat;
  for (int f0 = 0; f0 < feat; f0 += 32 * kColsPerLane) {
    float m[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) m[k] = -INFINITY;
    for (int e = e0; e <= e1; ++e) {
      if (__ldg(ids + e) != s) continue;  // a hole or another segment's row
      const float* row = data + static_cast<int64_t>(e) * feat;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int c = f0 + lane + 32 * k;
        if (c < feat) {
          const float v = __ldg(row + c);
          // a NaN wins and stays: NaN compares false both ways
          if (v > m[k] || v != v) m[k] = v;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = f0 + lane + 32 * k;
      if (c < feat) o[c] = isfinite(m[k]) ? m[k] : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// data [num_rows, feat] f32, ids [num_rows] int32 (any order; ids outside
// [0, num_segments) dropped), out [num_segments, feat] f32; first/last are
// [num_segments] int32 scratch. Returns cudaGetLastError().
int bignn_segment_max_f32(const void* data, const void* ids, int num_rows,
                          int feat, int num_segments, void* first, void* last,
                          void* out, void* stream) {
  if (num_rows < 0 || feat < 0 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_segments > 0) {
    const int* id = static_cast<const int*>(ids);
    int* f = static_cast<int*>(first);
    int* l = static_cast<int*>(last);
    bignn::segment_bounds(id, num_rows, num_segments, f, l, st);
    if (feat > 0) {
      max_segments<<<bignn::cdiv(num_segments, kWarpsPerBlock),
                     kWarpsPerBlock * 32, 0, st>>>(
          static_cast<const float*>(data), id, f, l, num_segments, feat,
          static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
