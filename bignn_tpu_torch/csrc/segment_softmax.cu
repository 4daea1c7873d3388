// Softmax of [E, H] scores within each segment (GAT attention over each
// destination's incoming edges), forward and backward, for float32 or bf16
// scores (max, exp and sums in float32; one rounding at each store):
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
// writes no [S, H] intermediate: one warp per segment, after a bounds pass
// (bounds_and_zero: segment_bounds.cuh's work on each row, and zeros on the
// rows with dropped ids, so that the ids are not read a third time).
//   forward:  a lane holds the rows e0 + lane + 32 r (r < R) of its
//             segment [e0, e1] in registers, so a segment of up to 32 R
//             positions is read once: every id and row of a lane is loaded
//             before any is used, then the max per head, the sum of exp and
//             alpha run from registers. R is 8 (256 positions), or 1 where
//             the segments hold at most 16 rows on average (config4's
//             sampled batch: ~4), so that more warps fit an SM; the host
//             picks it from num_rows / num_segments. A longer segment takes
//             three sweeps
//             over its rows (the max, the sum of exp, then alpha) with the
//             same lane-to-row order. Lanes combine by butterfly shuffles in
//             a fixed order, the same in both paths, so alpha is the same
//             bits either way.
//   backward: two sweeps: sum of alpha * g per head, then d_x.
// A row of H values is read and written in words of NV values (16, 8, 4 or
// 2 bytes): the widest that divides H and on which every tensor's base
// pointer lies (x and alpha; alpha, g and d_x), chosen on the host. A fixed
// order of the sums and no float atomics: a result repeats bit for bit.
//
// What bounds it on the H100: device-memory bytes, each [E, H] tensor once
// plus the ids (at E = 16.1M, H 4, f32: x and alpha 0.26 GB each, the ids
// 0.06 GB; 0.173 ms at 3.35 TB/s). The exps are cheap beside it. The ids
// are read twice, by the bounds pass and by the walk. Measured by
// scripts/compare_kernel_trees.py (device time of calls queued back to
// back; NVIDIA H100 80GB HBM3, 700 W), H 4, bounds pass included: the
// forward at 100K drugs (E 16.1M) f32 0.272 ms, bf16 0.266 (the walk it
// replaced, three sweeps of one row a lane and a separate zeroing pass,
// 0.635 and 0.585); at 16,384 drugs (E 2.6M) f32 0.053 (0.120); on
// config4's sampled batch, one row a lane, f32 0.0114 (0.0225). The
// backward at 16,384 drugs f32 0.087 (0.105). Zeroing the dropped rows in
// the bounds pass costs that pass 0.005 ms at 100K (bounds_and_zero 0.059
// against find_bounds 0.055); the separate pass over E x H values it
// replaced took 0.194. scripts/probe_variants.py chose 8 rows a lane, 4
// warps a block, at least 3 blocks an SM (f32 at 100K 0.272 ms, against
// 0.278 with 8 warps, 0.327 with 8 warps at 1 block, 0.295 at 4 blocks,
// 0.344-0.379 for 4 rows a lane; the backward 0.0868 with 4 warps, 0.0869
// with 8), and one row a lane where segments are short (config4's batch
// 0.0115 ms, against 0.025-0.030 for 8 rows).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kRows = 8;  // rows a forward lane holds: 256 positions a warp
constexpr int kFwdMinBlocks = 3;  // forward blocks an SM holds at least
// segments of at most this many positions on average take one row a lane
// (32 positions a warp in registers), so that more warps fit an SM
constexpr int kShortMean = 16;
constexpr float kDenomFloor = 1e-16f;

// HM: the heads rounded up to a power of two (1 <= heads <= HM <= 8); NV:
// the values of a row's word; R: the rows a lane holds in registers.
template <class T, int HM, int NV, int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  R == kRows ? kFwdMinBlocks : 1)
    softmax_fwd(const T* __restrict__ x, const int* __restrict__ ids,
                const int* __restrict__ first, const int* __restrict__ last,
                int num_segments, int heads, T* __restrict__ alpha) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_segments) return;
  const int e0 = first[s];
  const int e1 = last[s];
  float m[HM], l[HM];
#pragma unroll
  for (int h = 0; h < HM; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
  if (e1 - e0 < 32 * R) {
    // the segment in registers: x read once
    int id[R];
    float z[R][HM];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = e0 + lane + 32 * r;
      id[r] = e <= e1 ? __ldg(ids + e) : -1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = e0 + lane + 32 * r;
#pragma unroll
      for (int h = 0; h < HM; ++h) z[r][h] = 0.f;
      if (e <= e1)
        bignn::load_row<HM, NV>(x + static_cast<int64_t>(e) * heads, heads,
                                z[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < HM; ++h)
        if (id[r] == s && h < heads) m[h] = fmaxf(m[h], z[r][h]);
    }
#pragma unroll
    for (int h = 0; h < HM; ++h) {
      m[h] = bignn::warp_max(m[h]);
      if (!isfinite(m[h])) m[h] = 0.f;  // as JAX: where(isfinite(max), max, 0)
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < HM; ++h) {
        if (id[r] == s && h < heads) {
          z[r][h] = expf(z[r][h] - m[h]);
          l[h] += z[r][h];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HM; ++h)
      l[h] = fmaxf(bignn::warp_sum(l[h]), kDenomFloor);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (id[r] != s) continue;
#pragma unroll
      for (int h = 0; h < HM; ++h) z[r][h] /= l[h];
      bignn::store_row<HM, NV>(
          alpha + static_cast<int64_t>(e0 + lane + 32 * r) * heads, heads,
          z[r]);
    }
    return;
  }
  // a long segment: three sweeps, each row lane + 32 k of the segment
  float v[HM];
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    bignn::load_row<HM, NV>(x + static_cast<int64_t>(e) * heads, heads, v);
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < heads) m[h] = fmaxf(m[h], v[h]);
  }
#pragma unroll
  for (int h = 0; h < HM; ++h) {
    m[h] = bignn::warp_max(m[h]);
    if (!isfinite(m[h])) m[h] = 0.f;
  }
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    bignn::load_row<HM, NV>(x + static_cast<int64_t>(e) * heads, heads, v);
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < heads) l[h] += expf(v[h] - m[h]);
  }
#pragma unroll
  for (int h = 0; h < HM; ++h)
    l[h] = fmaxf(bignn::warp_sum(l[h]), kDenomFloor);
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
    bignn::load_row<HM, NV>(x + r, heads, v);
#pragma unroll
    for (int h = 0; h < HM; ++h) v[h] = expf(v[h] - m[h]) / l[h];
    bignn::store_row<HM, NV>(alpha + r, heads, v);
  }
}

template <class T, int HM, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    softmax_bwd(const T* __restrict__ alpha, const T* __restrict__ g,
                const int* __restrict__ ids, const int* __restrict__ first,
                const int* __restrict__ last, int num_segments, int heads,
                T* __restrict__ d_x) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_segments) return;
  const int e0 = first[s];
  const int e1 = last[s];
  float t[HM], a[HM], gv[HM];
#pragma unroll
  for (int h = 0; h < HM; ++h) t[h] = 0.f;
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
    bignn::load_row<HM, NV>(alpha + r, heads, a);
    bignn::load_row<HM, NV>(g + r, heads, gv);
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < heads) t[h] += a[h] * gv[h];
  }
#pragma unroll
  for (int h = 0; h < HM; ++h) t[h] = bignn::warp_sum(t[h]);
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
    bignn::load_row<HM, NV>(alpha + r, heads, a);
    bignn::load_row<HM, NV>(g + r, heads, gv);
#pragma unroll
    for (int h = 0; h < HM; ++h) a[h] = a[h] * gv[h] - a[h] * t[h];
    bignn::store_row<HM, NV>(d_x + r, heads, a);
  }
}

// The bounds of segment_bounds.cuh, and out[e, :] = 0 on the rows e whose id
// lies outside [0, num_segments): one pass over the ids for both.
template <class T>
__global__ void bounds_and_zero(const int* __restrict__ ids, int num_rows,
                                int num_segments, int heads, int* first,
                                int* last, T* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (bignn::bounds_of_row(ids, e, num_rows, num_segments, first, last)) {
    for (int h = 0; h < heads; ++h)
      out[static_cast<int64_t>(e) * heads + h] = bignn::from_f32<T>(0.f);
  }
}

template <class T>
void launch_bounds_and_zero(const int* ids, int num_rows, int num_segments,
                            int heads, int* first, int* last, T* out,
                            cudaStream_t st) {
  if (num_segments > 0) {
    bignn::init_bounds<<<bignn::cdiv(num_segments, 256), 256, 0, st>>>(
        first, last, num_segments, num_rows);
  }
  if (num_rows > 0) {
    bounds_and_zero<T><<<bignn::cdiv(num_rows, 256), 256, 0, st>>>(
        ids, num_rows, num_segments, heads, first, last, out);
  }
}

template <class T>
using FwdKernel = void (*)(const T*, const int*, const int*, const int*, int,
                           int, T*);
template <class T>
using BwdKernel = void (*)(const T*, const T*, const int*, const int*,
                           const int*, int, int, T*);

// The kernels for a word of nv values (nv divides the heads, so nv <= HM)
// and R rows a lane.
template <class T, int HM, int R>
FwdKernel<T> fwd_for(int nv) {
  if constexpr (HM >= 2) {
    if (nv == 2) return softmax_fwd<T, HM, 2, R>;
  }
  if constexpr (HM >= 4) {
    if (nv == 4) return softmax_fwd<T, HM, 4, R>;
  }
  if constexpr (HM >= 8 && sizeof(T) == 2) {
    if (nv == 8) return softmax_fwd<T, HM, 8, R>;
  }
  return softmax_fwd<T, HM, 1, R>;
}

template <class T, int HM>
BwdKernel<T> bwd_for(int nv) {
  if constexpr (HM >= 2) {
    if (nv == 2) return softmax_bwd<T, HM, 2>;
  }
  if constexpr (HM >= 4) {
    if (nv == 4) return softmax_bwd<T, HM, 4>;
  }
  if constexpr (HM >= 8 && sizeof(T) == 2) {
    if (nv == 8) return softmax_bwd<T, HM, 8>;
  }
  return softmax_bwd<T, HM, 1>;
}

// HM: the heads rounded up to 1, 2, 4 or 8.
template <class T, int R>
FwdKernel<T> fwd_kernel_r(int heads, int nv) {
  if (heads <= 1) return fwd_for<T, 1, R>(nv);
  if (heads <= 2) return fwd_for<T, 2, R>(nv);
  if (heads <= 4) return fwd_for<T, 4, R>(nv);
  return fwd_for<T, 8, R>(nv);
}

// R: kRows, or 1 where segments are short on average (the host knows the
// mean, num_rows / num_segments, without reading the bounds); a segment
// longer than 32 R positions takes the sweeps either way.
template <class T>
FwdKernel<T> fwd_kernel(int heads, int nv, bool short_segments) {
  return short_segments ? fwd_kernel_r<T, 1>(heads, nv)
                        : fwd_kernel_r<T, kRows>(heads, nv);
}

template <class T>
BwdKernel<T> bwd_kernel(int heads, int nv) {
  if (heads <= 1) return bwd_for<T, 1>(nv);
  if (heads <= 2) return bwd_for<T, 2>(nv);
  if (heads <= 4) return bwd_for<T, 4>(nv);
  return bwd_for<T, 8>(nv);
}

constexpr int kMaxHeads = 8;

template <class T>
int softmax_fwd_launch(const void* scores, const void* ids, int num_rows,
                       int heads, int num_segments, void* first, void* last,
                       void* alpha, void* stream) {
  if (heads < 1 || heads > kMaxHeads || num_rows < 0 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* f = static_cast<int*>(first);
  int* l = static_cast<int*>(last);
  launch_bounds_and_zero<T>(id, num_rows, num_segments, heads, f, l,
                            static_cast<T*>(alpha), st);
  if (num_segments > 0) {
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(scores) | reinterpret_cast<uintptr_t>(alpha);
    const bool short_segments =
        num_rows <= static_cast<int64_t>(kShortMean) * num_segments;
    const FwdKernel<T> k = fwd_kernel<T>(
        heads, bignn::word_values<T>(heads, addr), short_segments);
    k<<<bignn::cdiv(num_segments, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
        st>>>(static_cast<const T*>(scores), id, f, l, num_segments, heads,
              static_cast<T*>(alpha));
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int softmax_bwd_launch(const void* alpha, const void* g, const void* ids,
                       int num_rows, int heads, int num_segments, void* first,
                       void* last, void* d_scores, void* stream) {
  if (heads < 1 || heads > kMaxHeads || num_rows < 0 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* f = static_cast<int*>(first);
  int* l = static_cast<int*>(last);
  launch_bounds_and_zero<T>(id, num_rows, num_segments, heads, f, l,
                            static_cast<T*>(d_scores), st);
  if (num_segments > 0) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(alpha) |
                           reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(d_scores);
    const BwdKernel<T> k =
        bwd_kernel<T>(heads, bignn::word_values<T>(heads, addr));
    k<<<bignn::cdiv(num_segments, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
        st>>>(static_cast<const T*>(alpha), static_cast<const T*>(g), id, f,
              l, num_segments, heads, static_cast<T*>(d_scores));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// scores/alpha [num_rows, heads] (f32 or bf16, one type), ids [num_rows]
// int32, 1 <= heads <= 8; first/last are [num_segments] int32 scratch.
// Returns cudaGetLastError().
int bignn_segment_softmax_fwd_f32(const void* scores, const void* ids,
                                  int num_rows, int heads, int num_segments,
                                  void* first, void* last, void* alpha,
                                  void* stream) {
  return softmax_fwd_launch<float>(scores, ids, num_rows, heads,
                                   num_segments, first, last, alpha, stream);
}

int bignn_segment_softmax_fwd_bf16(const void* scores, const void* ids,
                                   int num_rows, int heads, int num_segments,
                                   void* first, void* last, void* alpha,
                                   void* stream) {
  return softmax_fwd_launch<__nv_bfloat16>(scores, ids, num_rows, heads,
                                           num_segments, first, last, alpha,
                                           stream);
}

// alpha/g/d_scores [num_rows, heads] in one type, the rest as above.
int bignn_segment_softmax_bwd_f32(const void* alpha, const void* g,
                                  const void* ids, int num_rows, int heads,
                                  int num_segments, void* first, void* last,
                                  void* d_scores, void* stream) {
  return softmax_bwd_launch<float>(alpha, g, ids, num_rows, heads,
                                   num_segments, first, last, d_scores,
                                   stream);
}

int bignn_segment_softmax_bwd_bf16(const void* alpha, const void* g,
                                   const void* ids, int num_rows, int heads,
                                   int num_segments, void* first, void* last,
                                   void* d_scores, void* stream) {
  return softmax_bwd_launch<__nv_bfloat16>(alpha, g, ids, num_rows, heads,
                                           num_segments, first, last,
                                           d_scores, stream);
}

}  // extern "C"
