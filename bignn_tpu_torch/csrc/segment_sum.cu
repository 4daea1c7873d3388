// Segment sum over rows: out[s] = sum of data[e] over the rows e with ids[e] == s.
//
// Replaces bignn_tpu/ops/pallas/segment.py:_segment_sum_kernel
// (segment_sum_pallas), used by the sum readout.
//
// The TPU kernel finds each 128-segment block's row range with a
// searchsorted over the ids, so it is only right for sorted ids. The
// block-local readout layout is not sorted: packing gaps between molecules
// carry the padding id num_segments (ROADMAP F1). This kernel is right for
// any ids, and fast when the valid ids are sorted with holes between them:
//   1. bounds: each segment's first and last row, by integer atomicMin /
//      atomicMax (exact, so order-free);
//   2. sum: one warp per segment walks [first, last] in row order and adds
//      the rows whose id equals the segment, in f32. No float atomics, so a
//      result is the same from run to run.
//
// What bounds it on the H100: device-memory bytes. Every valid row is read
// once (E * F * 4 bytes), plus the ids twice; the arithmetic is one add per
// element. A warp reads a row as 32 consecutive floats, so loads are
// coalesced. Rows inside a segment's range that belong to another segment
// (holes) cost a load of the id only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kColsPerLane = 4;  // a warp covers 128 columns per sweep

__global__ void init_bounds(int* first, int* last, int num_segments,
                            int num_rows) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < num_segments) {
    first[s] = num_rows;
    last[s] = -1;
  }
}

__global__ void find_bounds(const int* __restrict__ ids, int num_rows,
                            int num_segments, int* first, int* last) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_rows) return;
  const int s = ids[e];
  if (s < 0 || s >= num_segments) return;  // padding ids are dropped
  atomicMin(first + s, e);
  atomicMax(last + s, e);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sum_segments(const float* __restrict__ data, const int* __restrict__ ids,
                 const int* __restrict__ first, const int* __restrict__ last,
                 int num_segments, int feat, float* __restrict__ out) {
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
      const float* row = data + static_cast<int64_t>(e) * feat;
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

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// data [num_rows, feat] f32, ids [num_rows] int32, out [num_segments, feat]
// f32; first/last are [num_segments] int32 scratch. Returns cudaGetLastError().
int bignn_segment_sum_f32(const void* data, const void* ids, int num_rows,
                          int feat, int num_segments, void* first, void* last,
                          void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(first);
  int* l = static_cast<int*>(last);
  if (num_segments > 0) {
    init_bounds<<<cdiv(num_segments, 256), 256, 0, st>>>(f, l, num_segments,
                                                         num_rows);
    if (num_rows > 0) {
      find_bounds<<<cdiv(num_rows, 256), 256, 0, st>>>(
          static_cast<const int*>(ids), num_rows, num_segments, f, l);
    }
    if (feat > 0) {
      sum_segments<<<cdiv(num_segments, kWarpsPerBlock), kWarpsPerBlock * 32,
                     0, st>>>(static_cast<const float*>(data),
                              static_cast<const int*>(ids), f, l,
                              num_segments, feat, static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bignn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
