// Segment sum over rows: out[s] = sum of data[e] over the rows e with ids[e] == s,
// for float32 or bf16 data (sums in float32, one rounding at the store).
//
// Replaces bignn_tpu/ops/pallas/segment.py:_segment_sum_kernel
// (segment_sum_pallas), used by the sum readout; its permuted form replaces
// the segment_sum_pallas call in the backward of
// bignn_tpu/ops/gather.py:gather_rows_sorted_grad (_gather_sorted_bwd).
// The TPU kernel also accumulates in float32 and casts the output to the
// data's type (segment.py:123, :135); so does this one.
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
// once (E * F * sizeof(T) bytes), plus the ids twice; the arithmetic is one
// add per element. A warp reads a row as consecutive values (bf16 two at a
// time, so a warp sweep covers the same 128 columns in half the bytes).
// Rows inside a segment's range that belong to another segment (holes) cost
// a load of the id only. The walk is latency-bound as much as byte-bound:
// each row is a dependent id load and a row load; bf16 halves the bytes of
// the same walk, not its latency.

#include <cuda_runtime.h>

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
    sum_segments(const T* __restrict__ data, const int* __restrict__ perm,
                 const int* __restrict__ ids, const int* __restrict__ first,
                 const int* __restrict__ last, int num_segments, int feat,
                 T* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_segments) return;
  const int e0 = first[s];
  const int e1 = last[s];  // e1 < e0 for an empty segment
  T* o = out + static_cast<int64_t>(s) * feat;
  for (int f0 = 0; f0 < feat; f0 += 32 * kColsPerLane) {
    float acc[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
    for (int e = e0; e <= e1; ++e) {
      if (__ldg(ids + e) != s) continue;  // a hole or another segment's row
      const int r = perm == nullptr ? e : __ldg(perm + e);
      const T* row = data + static_cast<int64_t>(r) * feat;
#pragma unroll
      for (int k = 0; k < kColsPerLane; k += V) {
        const int c = f0 + V * lane + 32 * k;
        if constexpr (V == 2) {
          if (c < feat) {
            const float2 v = bignn::load2(row + c);
            acc[k] += v.x;
            acc[k + 1] += v.y;
          }
        } else if (c < feat) {
          acc[k] += bignn::load1(row + c);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; k += V) {
      const int c = f0 + V * lane + 32 * k;
      if constexpr (V == 2) {
        if (c < feat) bignn::store2(o + c, acc[k], acc[k + 1]);
      } else if (c < feat) {
        o[c] = bignn::from_f32<T>(acc[k]);
      }
    }
  }
}

template <class T>
int segment_sum(const void* data, const void* perm, const void* ids,
                int num_rows, int feat, int num_segments, void* first,
                void* last, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* f = static_cast<int*>(first);
  int* l = static_cast<int*>(last);
  if (num_segments > 0) {
    bignn::segment_bounds(id, num_rows, num_segments, f, l, st);
    if (feat > 0) {
      const dim3 grid(bignn::cdiv(num_segments, kWarpsPerBlock));
      const dim3 block(kWarpsPerBlock * 32);
      const T* d = static_cast<const T*>(data);
      const int* p = static_cast<const int*>(perm);
      T* o = static_cast<T*>(out);
      if (bignn::pairs_ok<T>(feat)) {
        sum_segments<T, 2><<<grid, block, 0, st>>>(d, p, id, f, l,
                                                   num_segments, feat, o);
      } else {
        sum_segments<T, 1><<<grid, block, 0, st>>>(d, p, id, f, l,
                                                   num_segments, feat, o);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data [num_rows, feat], ids [num_rows] int32, out [num_segments, feat] in
// the data's type; first/last are [num_segments] int32 scratch. Returns
// cudaGetLastError().
int bignn_segment_sum_f32(const void* data, const void* ids, int num_rows,
                          int feat, int num_segments, void* first, void* last,
                          void* out, void* stream) {
  return segment_sum<float>(data, nullptr, ids, num_rows, feat, num_segments,
                            first, last, out, stream);
}

int bignn_segment_sum_bf16(const void* data, const void* ids, int num_rows,
                           int feat, int num_segments, void* first,
                           void* last, void* out, void* stream) {
  return segment_sum<__nv_bfloat16>(data, nullptr, ids, num_rows, feat,
                                    num_segments, first, last, out, stream);
}

// The same sum over rows data[perm[e]]: perm [num_rows] int32 indexes data
// (any number of rows), ids [num_rows] int32 are the ids of the permuted
// rows.
int bignn_segment_sum_perm_f32(const void* data, const void* perm,
                               const void* ids, int num_rows, int feat,
                               int num_segments, void* first, void* last,
                               void* out, void* stream) {
  return segment_sum<float>(data, perm, ids, num_rows, feat, num_segments,
                            first, last, out, stream);
}

int bignn_segment_sum_perm_bf16(const void* data, const void* perm,
                                const void* ids, int num_rows, int feat,
                                int num_segments, void* first, void* last,
                                void* out, void* stream) {
  return segment_sum<__nv_bfloat16>(data, perm, ids, num_rows, feat,
                                    num_segments, first, last, out, stream);
}

const char* bignn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
