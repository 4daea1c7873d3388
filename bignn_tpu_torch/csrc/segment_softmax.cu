// Softmax of [E, H] scores within each segment (GAT attention over each
// destination's incoming edges), forward and backward:
//   alpha[e, h] = exp(x[e, h] - m[s, h]) / max(sum_{e' in s} exp(x[e', h]
//                 - m[s, h]), 1e-16),   s = ids[e], m the segment max (0
//                 where it is not finite);
//   d_x[e, h]   = alpha[e, h] g[e, h] - alpha[e, h] sum_{e' in s} alpha[e', h]
//                 g[e', h].
// Rows whose id lies outside [0, num_segments) (padding) get exactly 0 in
// both directions.
//
// Replaces bignn_tpu/ops/pallas/segment.py:segment_softmax_pallas: its
// forward _segment_softmax_fwd_impl (an XLA segment max, then the exp sum on
// the Pallas segment-sum kernel) and its analytic VJP _segment_softmax_bwd
// (one more Pallas segment sum). Here each direction is one kernel that
// writes no [S, H] intermediate: one warp per segment, after the bounds pass
// of segment_bounds.cuh.
//   forward:  three sweeps over the segment's rows: the max per head, the
//             sum of exp, then alpha. A lane takes every 32nd row and all
//             its heads (H <= 8) in registers; the warp combines lanes with
//             butterfly shuffles.
//   backward: two sweeps: sum of alpha * g per head, then d_x.
// A fixed order of the sums and no float atomics: a result repeats bit for
// bit. A separate pass zeroes the rows with dropped ids.
//
// What bounds it on the H100: device-memory bytes, E * H * 4 once from
// DRAM per input (the later sweeps of a segment's rows hit L1/L2: a
// destination of the 100K-drug graph has ~161 rows of 16 bytes), plus the
// ids. At E = 16.1M and H = 4 that is ~0.26 GB per [E, H] tensor. The
// exps are cheap beside it.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "segment_bounds.cuh"

namespace {

constexpr int kMaxHeads = 8;
constexpr int kWarpsPerBlock = 4;
constexpr float kDenomFloor = 1e-16f;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    softmax_fwd(const float* __restrict__ x, const int* __restrict__ ids,
                const int* __restrict__ first, const int* __restrict__ last,
                int num_segments, int heads, float* __restrict__ alpha) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_segments) return;
  const int e0 = first[s];
  const int e1 = last[s];
  float m[kMaxHeads], l[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const float* row = x + static_cast<int64_t>(e) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < heads) m[h] = fmaxf(m[h], __ldg(row + h));
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    m[h] = bignn::warp_max(m[h]);
    if (!isfinite(m[h])) m[h] = 0.f;  // as JAX: where(isfinite(max), max, 0)
  }
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const float* row = x + static_cast<int64_t>(e) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < heads) l[h] += expf(__ldg(row + h) - m[h]);
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h)
    l[h] = fmaxf(bignn::warp_sum(l[h]), kDenomFloor);
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < heads) alpha[r + h] = expf(__ldg(x + r + h) - m[h]) / l[h];
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    softmax_bwd(const float* __restrict__ alpha, const float* __restrict__ g,
                const int* __restrict__ ids, const int* __restrict__ first,
                const int* __restrict__ last, int num_segments, int heads,
                float* __restrict__ d_x) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_segments) return;
  const int e0 = first[s];
  const int e1 = last[s];
  float t[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) t[h] = 0.f;
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < heads) t[h] += __ldg(alpha + r + h) * __ldg(g + r + h);
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) t[h] = bignn::warp_sum(t[h]);
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) {
        const float a = __ldg(alpha + r + h);
        d_x[r + h] = a * __ldg(g + r + h) - a * t[h];
      }
    }
  }
}

// out[e, :] = 0 for the rows whose id is outside [0, num_segments).
__global__ void zero_dropped(const int* __restrict__ ids, int num_rows,
                             int num_segments, int heads,
                             float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(num_rows) * heads) return;
  const int s = __ldg(ids + i / heads);
  if (s < 0 || s >= num_segments) out[i] = 0.f;
}

int launch_zero_dropped(const int* ids, int num_rows, int num_segments,
                        int heads, float* out, cudaStream_t st) {
  const int64_t n = static_cast<int64_t>(num_rows) * heads;
  if (n > 0) {
    zero_dropped<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
        ids, num_rows, num_segments, heads, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// scores/alpha [num_rows, heads] f32, ids [num_rows] int32, 1 <= heads <= 8;
// first/last are [num_segments] int32 scratch. Returns cudaGetLastError().
int bignn_segment_softmax_fwd_f32(const void* scores, const void* ids,
                                  int num_rows, int heads, int num_segments,
                                  void* first, void* last, void* alpha,
                                  void* stream) {
  if (heads < 1 || heads > kMaxHeads || num_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  float* out = static_cast<float*>(alpha);
  if (num_segments > 0) {
    int* f = static_cast<int*>(first);
    int* l = static_cast<int*>(last);
    bignn::segment_bounds(id, num_rows, num_segments, f, l, st);
    softmax_fwd<<<bignn::cdiv(num_segments, kWarpsPerBlock),
                  kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(scores), id, f, l, num_segments, heads,
        out);
  }
  return launch_zero_dropped(id, num_rows, num_segments, heads, out, st);
}

// alpha/g/d_scores [num_rows, heads] f32, the rest as above.
int bignn_segment_softmax_bwd_f32(const void* alpha, const void* g,
                                  const void* ids, int num_rows, int heads,
                                  int num_segments, void* first, void* last,
                                  void* d_scores, void* stream) {
  if (heads < 1 || heads > kMaxHeads || num_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  float* out = static_cast<float*>(d_scores);
  if (num_segments > 0) {
    int* f = static_cast<int*>(first);
    int* l = static_cast<int*>(last);
    bignn::segment_bounds(id, num_rows, num_segments, f, l, st);
    softmax_bwd<<<bignn::cdiv(num_segments, kWarpsPerBlock),
                  kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(alpha), static_cast<const float*>(g), id, f,
        l, num_segments, heads, out);
  }
  return launch_zero_dropped(id, num_rows, num_segments, heads, out, st);
}

}  // extern "C"
