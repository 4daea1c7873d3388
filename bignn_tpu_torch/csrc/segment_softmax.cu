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
//   backward: the forward's layout: a lane holds the rows e0 + lane + 32 r
//             (r < R) of its segment, every id, alpha and g word loaded
//             before any is used; alpha g summed per head in r order, then
//             warp_sum, and d_x written from registers: alpha, g and the ids
//             read once. R as the forward's; a longer segment takes two
//             sweeps (the sum, then d_x) in the same order, so the two paths
//             give the same bits, and so does the two-sweep walk this one
//             replaced. The autograd backward passes the forward's bounds
//             on the same ids and launches once (the _saved entry points);
//             the op's own call (ops.segment_softmax_bwd) finds them first
//             with segment_bounds.cuh's pass, then launches the same
//             kernel. Its blocks past the segments' write the zeros of the
//             dropped rows.
// A row of H values is read and written in words of NV values (16, 8, 4 or
// 2 bytes): the widest that divides H and on which every tensor's base
// pointer lies (x and alpha; alpha, g and d_x), chosen on the host. A fixed
// order of the sums and no float atomics: a result repeats bit for bit.
// More than 8 heads (the kGroups forms): the heads go in groups of 8, one a
// grid row (blockIdx.y), each walked as above over its columns of the rows;
// softmax is independent per head, so a head's alpha and d_x have the bits
// they would have in a row of 8 heads. The words then divide gcd(H, 8).
// 32 heads in f32 over config4's sampled outer edges (E 59,008; NVIDIA
// H100 80GB HBM3, 700 W, chip_smoke.py path O, queued behind a sleep):
// forward 0.0550 ms, backward 0.0222 (bounds 0.0046, 0.0069).
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
// backward in the layout above, at 16,384 drugs f32 0.0510 ms from
// autograd, one launch on the forward's bounds (the two-sweep walk it
// replaced, with its bounds pass, 0.0871), 0.0611 as the op's own call
// (the bounds pass 0.0092, then the same walk); bf16 0.0415 (0.0466), the
// op's call 0.0516 (0.0463: at ~160 rows a segment the two sweeps' second
// read hits L1, and their lighter warps fill an SM better); config4's
// batch bf16 0.0051 (0.0100), the op's call 0.0093 (bound 0.0005). The
// backward's probe (scripts/probe_variants.py, kind smb: the walk on
// bounds found beforehand) kept 8 rows a lane, 4 warps a block and at
// least 3 blocks an SM (f32 0.0510, bf16 0.0418, config4's batch 0.0052;
// 4 rows 0.0635, 0.0501; 16 rows 0.0688, 0.0535; 8 warps 0.0744, 0.0481,
// 0.0049; 1 block an SM 0.0510, 0.0422). A row's words stay packed in
// registers until used (a bf16 row of 4 heads: 2 registers). The forward
// zeros the dropped rows in its bounds pass, at a cost of 0.005 ms at 100K
// (bounds_and_zero 0.059 against find_bounds 0.055); the separate pass over
// E x H values it replaced took 0.194. scripts/probe_variants.py (kind
// smf) chose for the forward 8 rows a lane, 4 warps a block, at least 3
// blocks an SM (f32 at 100K 0.272 ms, against 0.278 with 8 warps, 0.327
// with 8 warps at 1 block, 0.295 at 4 blocks, 0.344-0.379 for 4 rows a
// lane), and one row a lane where segments are short (config4's batch
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
constexpr int kBwdWarps = 4;  // warps a backward block holds
constexpr int kBwdRows = 8;  // rows a backward lane holds where not short
constexpr int kBwdMinBlocks = 3;  // backward blocks an SM holds at least
constexpr int kZeroRows = 8;  // rows a thread of the backward's zeroing takes

constexpr int kMaxHeads = 8;  // heads a warp walks (a group of them)

// HM: the heads rounded up to a power of two (1 <= heads <= HM <= 8); NV:
// the values of a row's word; R: the rows a lane holds in registers;
// kGroups: heads above 8, walked in groups of 8 (HM 8), group blockIdx.y.
// `heads` is the row's length; hn the heads of the block's group.
template <class T, int HM, int NV, int R, bool kGroups>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  R == kRows ? kFwdMinBlocks : 1)
    softmax_fwd(const T* __restrict__ x, const int* __restrict__ ids,
                const int* __restrict__ first, const int* __restrict__ last,
                int num_segments, int heads, T* __restrict__ alpha) {
  const int h0 = kGroups ? blockIdx.y * kMaxHeads : 0;
  const int hn = kGroups ? min(kMaxHeads, heads - h0) : heads;
  x += h0;
  alpha += h0;
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
        bignn::load_row<HM, NV>(x + static_cast<int64_t>(e) * heads, hn,
                                z[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < HM; ++h)
        if (id[r] == s && h < hn) m[h] = fmaxf(m[h], z[r][h]);
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
        if (id[r] == s && h < hn) {
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
          alpha + static_cast<int64_t>(e0 + lane + 32 * r) * heads, hn,
          z[r]);
    }
    return;
  }
  // a long segment: three sweeps, each row lane + 32 k of the segment
  float v[HM];
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    bignn::load_row<HM, NV>(x + static_cast<int64_t>(e) * heads, hn, v);
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < hn) m[h] = fmaxf(m[h], v[h]);
  }
#pragma unroll
  for (int h = 0; h < HM; ++h) {
    m[h] = bignn::warp_max(m[h]);
    if (!isfinite(m[h])) m[h] = 0.f;
  }
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    bignn::load_row<HM, NV>(x + static_cast<int64_t>(e) * heads, hn, v);
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < hn) l[h] += expf(v[h] - m[h]);
  }
#pragma unroll
  for (int h = 0; h < HM; ++h)
    l[h] = fmaxf(bignn::warp_sum(l[h]), kDenomFloor);
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
    bignn::load_row<HM, NV>(x + r, hn, v);
#pragma unroll
    for (int h = 0; h < HM; ++h) v[h] = expf(v[h] - m[h]) / l[h];
    bignn::store_row<HM, NV>(alpha + r, hn, v);
  }
}

// d_x of segment s = [e0, e1] (R rows a lane in registers, or two sweeps
// for a segment of 32 R positions or more). Each lane sums alpha g over its
// rows e0 + lane + 32 r in order, then the warp by warp_sum; the sum is a
// fused multiply-add, as the two sweeps' `t += a * g` compiles, and d_x the
// same expression in both paths, so they give the same bits.
// (heads: the rows' length; hn: the values of the group walked, at alpha,
// g and d_x as given)
template <class T, int HM, int NV, int R>
__device__ __forceinline__ void bwd_segment(const T* __restrict__ alpha,
                                            const T* __restrict__ g,
                                            const int* __restrict__ ids,
                                            int s, int e0, int e1, int heads,
                                            int hn, T* __restrict__ d_x) {
  const int lane = threadIdx.x % 32;
  float t[HM];
#pragma unroll
  for (int h = 0; h < HM; ++h) t[h] = 0.f;
  if (e1 - e0 < 32 * R) {
    // the segment in registers, as the words loaded (a bf16 row of 4 heads
    // in 2 registers): alpha, g and the ids read once
    using W = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;
    constexpr int kWords = HM / NV;
    int id[R];
    W wa[R][kWords], wg[R][kWords];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = e0 + lane + 32 * r;
      id[r] = e <= e1 ? __ldg(ids + e) : -1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = e0 + lane + 32 * r;
      const int64_t at = static_cast<int64_t>(e) * heads;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (e <= e1 && w * NV < hn) {
          wa[r][w] = __ldg(reinterpret_cast<const W*>(alpha + at + w * NV));
          wg[r][w] = __ldg(reinterpret_cast<const W*>(g + at + w * NV));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (id[r] == s && w * NV < hn) {
          float a[NV], gv[NV];
          bignn::unpack_word<T, NV>(wa[r][w], a);
          bignn::unpack_word<T, NV>(wg[r][w], gv);
#pragma unroll
          for (int i = 0; i < NV; ++i)
            t[w * NV + i] = __fmaf_rn(a[i], gv[i], t[w * NV + i]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HM; ++h) t[h] = bignn::warp_sum(t[h]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (id[r] != s) continue;
      T* row = d_x + static_cast<int64_t>(e0 + lane + 32 * r) * heads;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (w * NV < hn) {
          float a[NV], gv[NV];
          bignn::unpack_word<T, NV>(wa[r][w], a);
          bignn::unpack_word<T, NV>(wg[r][w], gv);
#pragma unroll
          for (int i = 0; i < NV; ++i)
            a[i] = a[i] * gv[i] - a[i] * t[w * NV + i];
          *reinterpret_cast<W*>(row + w * NV) = bignn::pack_word<T, NV, W>(a);
        }
      }
    }
    return;
  }
  // a long segment: two sweeps, each row lane + 32 k of the segment
  float a[HM], gv[HM];
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
    bignn::load_row<HM, NV>(alpha + r, hn, a);
    bignn::load_row<HM, NV>(g + r, hn, gv);
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < hn) t[h] = __fmaf_rn(a[h], gv[h], t[h]);
  }
#pragma unroll
  for (int h = 0; h < HM; ++h) t[h] = bignn::warp_sum(t[h]);
  for (int e = e0 + lane; e <= e1; e += 32) {
    if (__ldg(ids + e) != s) continue;
    const int64_t r = static_cast<int64_t>(e) * heads;
    bignn::load_row<HM, NV>(alpha + r, hn, a);
    bignn::load_row<HM, NV>(g + r, hn, gv);
#pragma unroll
    for (int h = 0; h < HM; ++h) a[h] = a[h] * gv[h] - a[h] * t[h];
    bignn::store_row<HM, NV>(d_x + r, hn, a);
  }
}

// One warp a segment for the blocks below walk_blocks; the blocks from
// walk_blocks on each write zeros on the rows with a dropped id among
// kZeroRows * 32 kBwdWarps rows of their own, ids loaded before any is used.
template <class T, int HM, int NV, int R, bool kGroups>
__global__ void __launch_bounds__(kBwdWarps * 32,
                                  R == 1 ? 1 : kBwdMinBlocks)
    softmax_bwd(const T* __restrict__ alpha, const T* __restrict__ g,
                const int* __restrict__ ids, const int* __restrict__ first,
                const int* __restrict__ last, int num_segments, int num_rows,
                int heads, int walk_blocks, T* __restrict__ d_x) {
  const int h0 = kGroups ? blockIdx.y * kMaxHeads : 0;
  const int hn = kGroups ? min(kMaxHeads, heads - h0) : heads;
  alpha += h0;
  g += h0;
  d_x += h0;
  if (static_cast<int>(blockIdx.x) >= walk_blocks) {
    constexpr int kBlockRows = kZeroRows * kBwdWarps * 32;
    const int e0 = (blockIdx.x - walk_blocks) * kBlockRows + threadIdx.x;
    int id[kZeroRows];
#pragma unroll
    for (int u = 0; u < kZeroRows; ++u) {
      const int e = e0 + u * kBwdWarps * 32;
      id[u] = e < num_rows ? __ldg(ids + e) : 0;
    }
    float zero[HM];
#pragma unroll
    for (int h = 0; h < HM; ++h) zero[h] = 0.f;
#pragma unroll
    for (int u = 0; u < kZeroRows; ++u) {
      const int e = e0 + u * kBwdWarps * 32;
      if (e < num_rows && (id[u] < 0 || id[u] >= num_segments))
        bignn::store_row<HM, NV>(d_x + static_cast<int64_t>(e) * heads, hn,
                                 zero);
    }
    return;
  }
  const int s = blockIdx.x * kBwdWarps + threadIdx.x / 32;
  if (s >= num_segments) return;
  bwd_segment<T, HM, NV, R>(alpha, g, ids, s, first[s], last[s], heads, hn,
                            d_x);
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
                           const int*, int, int, int, int, T*);

// The kernels for a word of nv values (nv divides the heads, so nv <= HM)
// and R rows a lane.
template <class T, int HM, int R, bool kGroups>
FwdKernel<T> fwd_for(int nv) {
  if constexpr (HM >= 2) {
    if (nv == 2) return softmax_fwd<T, HM, 2, R, kGroups>;
  }
  if constexpr (HM >= 4) {
    if (nv == 4) return softmax_fwd<T, HM, 4, R, kGroups>;
  }
  if constexpr (HM >= 8 && sizeof(T) == 2) {
    if (nv == 8) return softmax_fwd<T, HM, 8, R, kGroups>;
  }
  return softmax_fwd<T, HM, 1, R, kGroups>;
}

template <class T, int HM, int R, bool kGroups>
BwdKernel<T> bwd_for(int nv) {
  if constexpr (HM >= 2) {
    if (nv == 2) return softmax_bwd<T, HM, 2, R, kGroups>;
  }
  if constexpr (HM >= 4) {
    if (nv == 4) return softmax_bwd<T, HM, 4, R, kGroups>;
  }
  if constexpr (HM >= 8 && sizeof(T) == 2) {
    if (nv == 8) return softmax_bwd<T, HM, 8, R, kGroups>;
  }
  return softmax_bwd<T, HM, 1, R, kGroups>;
}

// HM: the heads rounded up to 1, 2, 4 or 8; above 8, groups of 8.
template <class T, int R>
FwdKernel<T> fwd_kernel_r(int heads, int nv) {
  if (heads <= 1) return fwd_for<T, 1, R, false>(nv);
  if (heads <= 2) return fwd_for<T, 2, R, false>(nv);
  if (heads <= 4) return fwd_for<T, 4, R, false>(nv);
  if (heads <= kMaxHeads) return fwd_for<T, 8, R, false>(nv);
  return fwd_for<T, 8, R, true>(nv);
}

template <class T, int R>
BwdKernel<T> bwd_kernel_r(int heads, int nv) {
  if (heads <= 1) return bwd_for<T, 1, R, false>(nv);
  if (heads <= 2) return bwd_for<T, 2, R, false>(nv);
  if (heads <= 4) return bwd_for<T, 4, R, false>(nv);
  if (heads <= kMaxHeads) return bwd_for<T, 8, R, false>(nv);
  return bwd_for<T, 8, R, true>(nv);
}

// The values a word may hold: they divide the heads (within a group of 8
// where there are more) and the pointers' alignment.
template <class T>
int softmax_word(int heads, uintptr_t addr) {
  int span = heads;
  if (heads > kMaxHeads) {
    span = kMaxHeads;
    while (heads % span != 0) span /= 2;  // gcd(heads, 8)
  }
  return bignn::word_values<T>(span, addr);
}

// Head groups: gridDim.y.
inline int head_groups(int heads) { return bignn::cdiv(heads, kMaxHeads); }

// R: kRows, or 1 where segments are short on average (the host knows the
// mean, num_rows / num_segments, without reading the bounds); a segment
// longer than 32 R positions takes the sweeps either way.
bool short_segments(int num_rows, int num_segments) {
  return num_rows <= static_cast<int64_t>(kShortMean) * num_segments;
}

template <class T>
FwdKernel<T> fwd_kernel(int heads, int nv, bool short_rows) {
  return short_rows ? fwd_kernel_r<T, 1>(heads, nv)
                    : fwd_kernel_r<T, kRows>(heads, nv);
}

template <class T>
BwdKernel<T> bwd_kernel(int heads, int nv, bool short_rows) {
  return short_rows ? bwd_kernel_r<T, 1>(heads, nv)
                    : bwd_kernel_r<T, kBwdRows>(heads, nv);
}

template <class T>
int softmax_fwd_launch(const void* scores, const void* ids, int num_rows,
                       int heads, int num_segments, void* first, void* last,
                       void* alpha, void* stream) {
  if (heads < 1 || head_groups(heads) > 65535 || num_rows < 0 ||
      num_segments < 0)
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
    const FwdKernel<T> k =
        fwd_kernel<T>(heads, softmax_word<T>(heads, addr),
                      short_segments(num_rows, num_segments));
    const dim3 grid(bignn::cdiv(num_segments, kWarpsPerBlock),
                    head_groups(heads));
    k<<<grid, kWarpsPerBlock * 32, 0, st>>>(static_cast<const T*>(scores), id,
                                            f, l, num_segments, heads,
                                            static_cast<T*>(alpha));
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: with `saved`, first/last hold the bounds the forward found
// on the same ids; else first/last are scratch, and segment_bounds.cuh's
// pass finds the bounds first. Then one launch walks the segments and zeros
// the dropped rows.
template <class T>
int softmax_bwd_launch(const void* alpha, const void* g, const void* ids,
                       int num_rows, int heads, int num_segments, void* first,
                       void* last, void* d_scores, bool saved, void* stream) {
  if (heads < 1 || head_groups(heads) > 65535 || num_rows < 0 ||
      num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* f = static_cast<int*>(first);
  int* l = static_cast<int*>(last);
  if (!saved) bignn::segment_bounds(id, num_rows, num_segments, f, l, st);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(alpha) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(d_scores);
  const BwdKernel<T> k =
      bwd_kernel<T>(heads, softmax_word<T>(heads, addr),
                    short_segments(num_rows, num_segments));
  const int walk_blocks = bignn::cdiv(num_segments, kBwdWarps);
  const int zero_blocks = bignn::cdiv(num_rows, kZeroRows * kBwdWarps * 32);
  if (walk_blocks + zero_blocks > 0) {
    const dim3 grid(walk_blocks + zero_blocks, head_groups(heads));
    k<<<grid, kBwdWarps * 32, 0, st>>>(
        static_cast<const T*>(alpha), static_cast<const T*>(g), id, f, l,
        num_segments, num_rows, heads, walk_blocks,
        static_cast<T*>(d_scores));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// scores/alpha [num_rows, heads] (f32 or bf16, one type), ids [num_rows]
// int32, heads >= 1; first/last are [num_segments] int32 scratch.
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

// alpha/g/d_scores [num_rows, heads] in one type, the rest as above: the
// bounds pass (two launches), then the walk.
int bignn_segment_softmax_bwd_f32(const void* alpha, const void* g,
                                  const void* ids, int num_rows, int heads,
                                  int num_segments, void* first, void* last,
                                  void* d_scores, void* stream) {
  return softmax_bwd_launch<float>(alpha, g, ids, num_rows, heads,
                                   num_segments, first, last, d_scores, false,
                                   stream);
}

int bignn_segment_softmax_bwd_bf16(const void* alpha, const void* g,
                                   const void* ids, int num_rows, int heads,
                                   int num_segments, void* first, void* last,
                                   void* d_scores, void* stream) {
  return softmax_bwd_launch<__nv_bfloat16>(alpha, g, ids, num_rows, heads,
                                           num_segments, first, last,
                                           d_scores, false, stream);
}

// As above, but first/last hold the bounds that the forward found on the
// same ids (read only): one launch.
int bignn_segment_softmax_bwd_saved_f32(const void* alpha, const void* g,
                                        const void* ids, int num_rows,
                                        int heads, int num_segments,
                                        void* first, void* last,
                                        void* d_scores, void* stream) {
  return softmax_bwd_launch<float>(alpha, g, ids, num_rows, heads,
                                   num_segments, first, last, d_scores, true,
                                   stream);
}

int bignn_segment_softmax_bwd_saved_bf16(const void* alpha, const void* g,
                                         const void* ids, int num_rows,
                                         int heads, int num_segments,
                                         void* first, void* last,
                                         void* d_scores, void* stream) {
  return softmax_bwd_launch<__nv_bfloat16>(alpha, g, ids, num_rows, heads,
                                           num_segments, first, last,
                                           d_scores, true, stream);
}

}  // extern "C"
