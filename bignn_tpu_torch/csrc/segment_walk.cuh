// The segment walk shared by the segment sum (segment_sum.cu) and the
// segment max (segment_max.cu, forward and backward): the warps of a
// segment s walk the rows [first[s], last[s]] that the bounds pass found
// (segment_bounds.cuh) and visit the rows whose id is s; other rows (holes,
// other segments' rows) are skipped by their id, so it is right for any ids
// and reads only the rows of s when the ids are sorted.
//
// A walk of short rows, or of segments with few rows, is bound by the
// latency of its dependent loads (the id, then the row), not by bytes. The
// design puts many rows in flight:
//   - A row is read as 16-byte words where its width and every base address
//     allow (f32 4 values, bf16 8), else as 8-, 4- or 2-byte words
//     (elem.cuh: word_values). The lanes of a warp split into row slots of
//     G lanes, G the row's words rounded up to a power of two (at most 32):
//     lane q G + c reads word c of its slot's rows. So [E, 4] f32 rows take
//     one lane each (32 rows a warp), 128-wide f32 rows a whole warp, and
//     128-wide bf16 rows 16 lanes. Rows wider than 32 words take more
//     sweeps over the segment.
//   - Each lane has up to kUnroll rows in flight: it loads their ids (and
//     perm entries) together, then their words. The no-perm form loads row
//     e before its id is known (e lies in [first, last], so the load is in
//     bounds) and visits it only if the id matches, so a pass is one trip to
//     memory; the permuted form needs two. A segment that spans few rows
//     takes 1 or 4 rows a lane, so that its warp issues no idle loads.
//   - Few segments (config2's ~430 molecules a bucket) would leave most of
//     the 132 SMs idle at one warp a segment: then up to kMaxWarps warps
//     share a segment's rows and their partial results are combined in
//     shared memory in warp order.
// The reduction (Op) folds values in float32 in a fixed order: each lane in
// row order, a butterfly across a warp's row slots, then the warps in order.
// No float atomics, so a result repeats bit for bit. Flat offsets are
// 64-bit.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "elem.cuh"
#include "segment_bounds.cuh"

namespace bignn {
namespace {

constexpr int kUnroll = 8;            // most rows a lane has in flight
constexpr int kMaxWarps = 8;          // warps that may share one segment
constexpr int kSegsPerBlock = 2;      // segments of a block of one warp each
constexpr int kFillWarps = 132 * 32;  // warps that keep the 132 SMs busy
constexpr unsigned kFull = 0xffffffffu;

// acc = acc + v, from 0: the segment sum.
struct SumOp {
  static __device__ __forceinline__ float init() { return 0.f; }
  static __device__ __forceinline__ void fold(float& acc, float v) {
    acc += v;
  }
  static __device__ __forceinline__ float finish(float acc) { return acc; }
};

// acc = max(acc, v), from -inf, with a NaN winning and staying (it compares
// false both ways), so the result does not depend on the order of the
// folds; a max that is not finite (a NaN, or no row) is stored as 0.
struct MaxOp {
  static __device__ __forceinline__ float init() { return -INFINITY; }
  static __device__ __forceinline__ void fold(float& acc, float v) {
    if (v > acc || v != v) acc = v;
  }
  static __device__ __forceinline__ float finish(float acc) {
    return isfinite(acc) ? acc : 0.f;
  }
};

// visit(word, r) for each of a lane's rows e, e + step, ... up to e1 whose
// id is s (r = e, or perm[e] in the permuted form), U rows in flight: their
// ids (and perm entries) are loaded together, then their words. The no-perm
// form loads row e before its id is known (it is the row itself). A lane
// that holds no word of the row (not `mine`) visits a zero word.
template <class T, int NV, bool kPerm, int U, class W, class Visit>
__device__ __forceinline__ void walk(const T* col, const int* perm,
                                     const int* ids, int64_t e, int e1,
                                     int64_t step, int s, int feat,
                                     bool mine, Visit& visit) {
  for (; e <= e1; e += step * U) {
    int id[U];
    int64_t r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t eu = e + step * u;
      const bool in = eu <= e1;
      id[u] = in ? __ldg(ids + eu) : -1;
      if constexpr (kPerm) {
        r[u] = in ? __ldg(perm + eu) : -1;
      } else {
        r[u] = in ? eu : -1;
      }
    }
    W word[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool load = mine && r[u] >= 0 && (!kPerm || id[u] == s);
      word[u] = load ? __ldg(reinterpret_cast<const W*>(col + r[u] * feat))
                     : W{};
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (id[u] == s) visit(word[u], r[u]);
  }
}

// The walk of segment s's rows [e0, e1] from row e in slot steps of `step`,
// with as many rows in flight as a lane has, up to kUnroll.
template <class T, int NV, bool kPerm, class W, class Visit>
__device__ __forceinline__ void walk_segment(const T* col, const int* perm,
                                             const int* ids, int64_t e,
                                             int e0, int e1, int64_t step,
                                             int s, int feat, bool mine,
                                             Visit& visit) {
  const int64_t n = static_cast<int64_t>(e1) - e0 + 1;  // rows spanned
  if (n <= step) {
    walk<T, NV, kPerm, 1, W>(col, perm, ids, e, e1, step, s, feat, mine,
                             visit);
  } else if (n <= 4 * step) {
    walk<T, NV, kPerm, 4, W>(col, perm, ids, e, e1, step, s, feat, mine,
                             visit);
  } else {
    walk<T, NV, kPerm, kUnroll, W>(col, perm, ids, e, e1, step, s, feat,
                                   mine, visit);
  }
}

// The lanes of one sweep over words [c0, c0 + 32) of a row of `words`
// words: a slot of 2^lg lanes a row, lane q 2^lg + c on word c0 + c.
struct Sweep {
  int m;      // words of this sweep
  int lg;     // log2 of the lanes a row takes
  int q;      // the lane's row slot
  int c;      // the lane's word within the sweep
  bool mine;  // whether the lane holds a word (c < m)
  int slots;  // row slots a warp
  __device__ __forceinline__ Sweep(int c0, int words, int lane)
      : m(min(32, words - c0)),
        lg(slot_log2(m)),
        q(lane >> lg),
        c(lane & ((1 << lg) - 1)),
        mine(c < m),
        slots(32 >> lg) {}
};

// The segment of warp `warp` of this block, and that warp's index w among
// the warps_per_seg warps of the segment: a block holds kSegsPerBlock
// segments of one warp each, or one segment of warps_per_seg warps.
__device__ __forceinline__ int block_segment(int warp, int warps_per_seg,
                                             int& w) {
  w = warp % warps_per_seg;
  return blockIdx.x * (blockDim.x / 32 / warps_per_seg) +
         warp / warps_per_seg;
}

// out[s] = Op over the rows of segment s (data[perm[e]] in the permuted
// form), finished and rounded once to T. Warp w of a segment reads the rows
// e0 + w R + q + k R warps_per_seg (k = 0, 1, ...) in its slot q, with
// R = 32 / G slots a warp; NV values of T make one word.
template <class Op, class T, int NV, bool kPerm>
__global__ void __launch_bounds__(kMaxWarps * 32)
    reduce_segments(const T* __restrict__ data, const int* __restrict__ perm,
                    const int* __restrict__ ids,
                    const int* __restrict__ first,
                    const int* __restrict__ last, int num_segments, int feat,
                    int warps_per_seg, T* __restrict__ out) {
  using W = typename Word<NV * static_cast<int>(sizeof(T))>::type;
  extern __shared__ float part[];  // [warps_per_seg, 32, NV] when shared
  const int lane = threadIdx.x % 32;
  int w;
  const int s = block_segment(threadIdx.x / 32, warps_per_seg, w);
  if (s >= num_segments) return;  // never a shared segment's warp
  const int e0 = first[s];
  const int e1 = last[s];  // e1 < e0 for an empty segment
  const int words = feat / NV;
  T* o = out + static_cast<int64_t>(s) * feat;
  for (int c0 = 0; c0 < words; c0 += 32) {
    const Sweep sw(c0, words, lane);
    const int64_t step = static_cast<int64_t>(sw.slots) * warps_per_seg;
    const T* col = data + static_cast<int64_t>(c0 + sw.c) * NV;
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = Op::init();
    auto fold_word = [&](const W& word, int64_t) {
      float v[NV];
      unpack_word<T, NV>(word, v);
#pragma unroll
      for (int i = 0; i < NV; ++i) Op::fold(acc[i], v[i]);
    };
    walk_segment<T, NV, kPerm, W>(
        col, perm, ids, e0 + static_cast<int64_t>(w) * sw.slots + sw.q, e0,
        e1, step, s, feat, sw.mine, fold_word);
    // each word's result over the warp's row slots
    for (int d = 1 << sw.lg; d < 32; d <<= 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        Op::fold(acc[i], __shfl_xor_sync(kFull, acc[i], d));
    }
    const bool store = sw.q == 0 && sw.mine;
    auto store_word = [&] {
      float v[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = Op::finish(acc[i]);
      *reinterpret_cast<W*>(o + static_cast<int64_t>(c0 + sw.c) * NV) =
          pack_word<T, NV, W>(v);
    };
    if (warps_per_seg == 1) {
      if (store) store_word();
      continue;
    }
    if (store) {
#pragma unroll
      for (int i = 0; i < NV; ++i) part[(w * 32 + sw.c) * NV + i] = acc[i];
    }
    __syncthreads();
    if (w == 0 && store) {
      for (int k = 1; k < warps_per_seg; ++k) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          Op::fold(acc[i], part[(k * 32 + sw.c) * NV + i]);
      }
      store_word();
    }
    __syncthreads();
  }
}

// The launch shape of a walk: warps a segment, segments a block, blocks,
// threads a block. A segment is shared among more warps while the card has
// room for them and each keeps two passes of rows (mean rows a segment
// spans).
struct WalkGrid {
  int warps_per_seg;
  int blocks;
  int threads;
};

inline WalkGrid walk_grid(int num_rows, int feat, int nv, int num_segments) {
  int wps = 1;
  if (num_segments > 0) {
    const int64_t slots = 32 >> slot_log2(feat / nv < 32 ? feat / nv : 32);
    const int64_t rows = num_rows / num_segments;
    while (wps < kMaxWarps &&
           static_cast<int64_t>(num_segments) * wps < kFillWarps &&
           rows >= 2 * wps * slots * kUnroll)
      wps *= 2;
  }
  const int segs = wps == 1 ? kSegsPerBlock : 1;
  return {wps, cdiv(num_segments, segs), 32 * wps * segs};
}

template <class Op, class T, int NV>
void launch_reduce(const T* data, const int* perm, const int* ids,
                   const int* first, const int* last, int num_rows, int feat,
                   int num_segments, T* out, cudaStream_t st) {
  const WalkGrid wg = walk_grid(num_rows, feat, NV, num_segments);
  const size_t smem =
      wg.warps_per_seg == 1 ? 0 : sizeof(float) * wg.warps_per_seg * 32 * NV;
  if (perm != nullptr) {
    reduce_segments<Op, T, NV, true><<<wg.blocks, wg.threads, smem, st>>>(
        data, perm, ids, first, last, num_segments, feat, wg.warps_per_seg,
        out);
  } else {
    reduce_segments<Op, T, NV, false><<<wg.blocks, wg.threads, smem, st>>>(
        data, perm, ids, first, last, num_segments, feat, wg.warps_per_seg,
        out);
  }
}

// f(std::integral_constant<int, NV>{}) for the word of nv values of T that
// word_values chose (16, 8, 4 or 2 bytes, or one value).
template <class T, class F>
void with_word(int nv, F&& f) {
  if constexpr (sizeof(T) == 2) {
    if (nv == 8) {
      f(std::integral_constant<int, 8>{});
      return;
    }
  }
  if (nv == 4) {
    f(std::integral_constant<int, 4>{});
  } else if (nv == 2) {
    f(std::integral_constant<int, 2>{});
  } else {
    f(std::integral_constant<int, 1>{});
  }
}

}  // namespace
}  // namespace bignn
