// Segment bounds, shared by the segment kernels (segment_sum.cu,
// segment_max.cu, segment_softmax.cu, spmm.cu, spmm_multihead.cu).
//
// For each segment s in [0, num_segments): the first and the last row e with
// ids[e] == s, found by integer atomicMin / atomicMax (exact, so the result
// does not depend on the order of the atomics). An empty segment gets
// first = num_rows and last = -1; ids outside [0, num_segments) are dropped.
// A row takes its atomics only where a run of equal ids begins or ends: a
// segment's first row begins a run and its last row ends one, so the bounds
// are those of an atomic on every row, for any ids. With sorted ids every
// lane of a warp would hit the same two addresses, and atomics on every row
// would serialise there.
//
// A consumer walks [first[s], last[s]] in row order and skips the rows whose
// id is not s. So it is right for any ids, and reads only the rows of s when
// the ids are sorted (the outer graph's dst and its source-sorted order are,
// by construction). Rows between two runs of s that belong elsewhere (holes)
// cost a load of their id.
//
// Cost: the ids are read once (the two at a warp's edges twice), two
// integer atomics per run of a valid id.

#pragma once

#include <cuda_runtime.h>

namespace bignn {
namespace {

__global__ void init_bounds(int* first, int* last, int num_segments,
                            int num_rows) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < num_segments) {
    first[s] = num_rows;
    last[s] = -1;
  }
}

// The bounds work of row e. Every lane of a whole warp calls it (the
// shuffles), with e = blockIdx.x * blockDim.x + threadIdx.x. Returns whether
// row e exists and its id is dropped.
__device__ __forceinline__ bool bounds_of_row(const int* __restrict__ ids,
                                              int e, int num_rows,
                                              int num_segments, int* first,
                                              int* last) {
  const int lane = threadIdx.x % 32;
  const int s = e < num_rows ? ids[e] : -1;
  int prev = __shfl_up_sync(0xffffffffu, s, 1);
  int next = __shfl_down_sync(0xffffffffu, s, 1);
  if (e >= num_rows) return false;
  if (s < 0 || s >= num_segments) return true;  // padding: dropped
  if (lane == 0 && e > 0) prev = ids[e - 1];
  if (lane == 31 && e + 1 < num_rows) next = ids[e + 1];
  if (e == 0 || prev != s) atomicMin(first + s, e);
  if (e == num_rows - 1 || next != s) atomicMax(last + s, e);
  return false;
}

// blockDim.x is a multiple of 32, so every warp is whole for the shuffles.
__global__ void find_bounds(const int* __restrict__ ids, int num_rows,
                            int num_segments, int* first, int* last) {
  bounds_of_row(ids, blockIdx.x * blockDim.x + threadIdx.x, num_rows,
                num_segments, first, last);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// first/last are [num_segments] int32 scratch on the device.
inline void segment_bounds(const int* ids, int num_rows, int num_segments,
                           int* first, int* last, cudaStream_t st) {
  if (num_segments <= 0) return;
  init_bounds<<<cdiv(num_segments, 256), 256, 0, st>>>(first, last,
                                                       num_segments, num_rows);
  if (num_rows > 0) {
    find_bounds<<<cdiv(num_rows, 256), 256, 0, st>>>(ids, num_rows,
                                                     num_segments, first, last);
  }
}

// Sum of v over the 32 lanes of a warp, in a fixed butterfly order: every
// lane gets the same bits, and a run repeats them.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace
}  // namespace bignn
