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
//   2. sum: the walk of segment_walk.cuh with SumOp: the warps of a
//      segment walk [first, last] and add, in f32, the rows whose id equals
//      the segment; other rows (holes, other segments' rows) are skipped by
//      their id.
// The permuted form reads row perm[e] of data in place of row e, so the
// gather backward sums g[perm] over ids_sorted without a copy of g[perm].
//
// What bounds it on the H100: device-memory bytes. It does one add per
// element read, so tensor cores have nothing to do here. The readout reads
// E * (F * sizeof(T) + 4) bytes; the gather backward E * (F * sizeof(T) + 8)
// (its cotangent rows through perm, the ids and perm), which is
// E * (4 H + 8) for the f32 [E, H] scores; both write S * F * sizeof(T).
// The rows are short (the gather's are H = 4 floats, 16 bytes) or a
// segment has few of them (config2's molecules ~33), so a walk that reads
// one row after another is bound by the latency of its dependent loads
// (the id, then perm[e], then the row), not by bytes. The walk
// (segment_walk.cuh) puts many rows in flight: row slots of 16-byte words,
// up to 8 rows a lane in flight, up to 8 warps a segment when segments are
// few. A segment that spans few rows (config4's sampled outer graph: ~4
// edges a drug) takes 1 or 4 rows a lane. Every sum runs in a fixed order
// (each lane in row order, a butterfly across a warp's row slots, then the
// warps in order), with no float atomics, so a result repeats bit for bit.
//
// Measured by scripts/compare_kernel_trees.py (device time of calls queued
// back to back; NVIDIA H100 80GB HBM3, 700 W), against the warp-a-segment
// walk with lanes over columns that this design replaced and index_add_:
// config2's 4 readout buckets (F 128) 0.038 ms (0.094; index_add_ 0.070;
// bound 0.0087: each bucket takes three launches, two for the bounds and
// one for the sum, and their gaps hold it); the gather backward at E 2.6M,
// H 4, permuted 0.048 ms (0.375; 0.087; bound 0.019: a random 16-byte row
// fills half of its 32-byte sector), sorted dst 0.033 ms (0.364; 0.104);
// bf16 [448,512, 128] 0.048 ms (0.071; 0.718).

#include <cuda_runtime.h>

#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"
#include "segment_walk.cuh"

namespace {

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
      const T* d = static_cast<const T*>(data);
      const int* p = static_cast<const int*>(perm);
      T* o = static_cast<T*>(out);
      const int nv = bignn::word_values<T>(
          feat, reinterpret_cast<uintptr_t>(data) |
                    reinterpret_cast<uintptr_t>(out));
      bignn::with_word<T>(nv, [&](auto word) {
        bignn::launch_reduce<bignn::SumOp, T, decltype(word)::value>(
            d, p, id, f, l, num_rows, feat, num_segments, o, st);
      });
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data [num_rows, feat], ids [num_rows] int32, out [num_segments, feat] in
// the data's type; first/last are [num_segments] int32 scratch, left
// holding each segment's bounds (segment_bounds.cuh). Returns
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
