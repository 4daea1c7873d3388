// Segment max over rows, for float32 or bf16 data: out[s] = max of data[e]
// over the rows e with ids[e] == s, and 0 where that is empty or not finite
// (the rule of the JAX package's segment_max, bignn_tpu/ops/segment.py:
// 69-72). A NaN in a segment gives NaN, so 0. Values are compared in float32
// and the winner is stored in the data's type: the max of bf16 values is one
// of them, so the bf16 result is exact, equal to the plain version bit for
// bit (the TPU kernel also compares in float32 and casts back, :405, :413).
//
// Replaces bignn_tpu/ops/pallas/segment.py:_segment_max_kernel
// (segment_max_pallas), used by the max readout. The TPU kernel finds each
// 128-segment block's row range with a searchsorted over the ids, so it is
// right only for sorted ids, and the readout's block-local ids put padding
// runs between molecules (ROADMAP F1, F2). This kernel is right for any ids:
//   1. bounds: each segment's first and last row (segment_bounds.cuh);
//   2. max: one warp per segment walks [first, last] in row order, skips the
//      rows of other segments (holes), and keeps a running max in registers,
//      lanes across F (columns lane + 32 k, 128 a sweep; bf16 rows of an
//      even width as pairs, 2 lane + 64 j, where data and out start on 4
//      bytes). One store a value.
// Its VJP has no kernel of its own: ops/segment.py composes it as the JAX
// package does (an is-max mask, tie counts by the segment-sum kernel, a
// gather).
//
// What bounds it on the H100: device-memory bytes, each valid row read once
// (E * F * sizeof(T)) plus the ids; one comparison per element. As for the
// segment sum, the walk is one dependent id load and row load after another.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kColsPerLane = 4;  // a warp covers 128 columns per sweep

// V = 1: lane reads columns f0 + lane + 32 k; V = 2 (bf16, even width):
// lane reads pairs at f0 + 2 lane + 64 j.
template <class T, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    max_segments(const T* __restrict__ data, const int* __restrict__ ids,
                 const int* __restrict__ first, const int* __restrict__ last,
                 int num_segments, int feat, T* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_segments) return;
  const int e0 = first[s];
  const int e1 = last[s];  // e1 < e0 for an empty segment
  T* o = out + static_cast<int64_t>(s) * feat;
  for (int f0 = 0; f0 < feat; f0 += 32 * kColsPerLane) {
    float m[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) m[k] = -INFINITY;
    for (int e = e0; e <= e1; ++e) {
      if (__ldg(ids + e) != s) continue;  // a hole or another segment's row
      const T* row = data + static_cast<int64_t>(e) * feat;
#pragma unroll
      for (int k = 0; k < kColsPerLane; k += V) {
        const int c = f0 + V * lane + 32 * k;
        if (c < feat) {
          float v[V];
          bignn::load_vec<V>(row + c, v);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            // a NaN wins and stays: NaN compares false both ways
            if (v[j] > m[k + j] || v[j] != v[j]) m[k + j] = v[j];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; k += V) {
      const int c = f0 + V * lane + 32 * k;
      if (c < feat) {
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = isfinite(m[k + j]) ? m[k + j] : 0.f;
        bignn::store_vec<V>(o + c, v);
      }
    }
  }
}

template <class T>
int segment_max(const void* data, const void* ids, int num_rows, int feat,
                int num_segments, void* first, void* last, void* out,
                void* stream) {
  if (num_rows < 0 || feat < 0 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_segments > 0) {
    const int* id = static_cast<const int*>(ids);
    int* f = static_cast<int*>(first);
    int* l = static_cast<int*>(last);
    bignn::segment_bounds(id, num_rows, num_segments, f, l, st);
    if (feat > 0) {
      const dim3 grid(bignn::cdiv(num_segments, kWarpsPerBlock));
      const dim3 block(kWarpsPerBlock * 32);
      const T* d = static_cast<const T*>(data);
      T* o = static_cast<T*>(out);
      // pairs need every row of data and out on 4 bytes: the width and
      // both base pointers
      const uintptr_t addr =
          reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(out);
      if (bignn::pairs_ok<T>(feat) && addr % 4 == 0) {
        max_segments<T, 2><<<grid, block, 0, st>>>(d, id, f, l, num_segments,
                                                   feat, o);
      } else {
        max_segments<T, 1><<<grid, block, 0, st>>>(d, id, f, l, num_segments,
                                                   feat, o);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data [num_rows, feat] f32 or bf16, ids [num_rows] int32 (any order; ids
// outside [0, num_segments) dropped), out [num_segments, feat] in the data's
// type; first/last are [num_segments] int32 scratch. Returns
// cudaGetLastError().
int bignn_segment_max_f32(const void* data, const void* ids, int num_rows,
                          int feat, int num_segments, void* first, void* last,
                          void* out, void* stream) {
  return segment_max<float>(data, ids, num_rows, feat, num_segments, first,
                            last, out, stream);
}

int bignn_segment_max_bf16(const void* data, const void* ids, int num_rows,
                           int feat, int num_segments, void* first,
                           void* last, void* out, void* stream) {
  return segment_max<__nv_bfloat16>(data, ids, num_rows, feat, num_segments,
                                    first, last, out, stream);
}

}  // extern "C"
