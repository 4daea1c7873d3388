// Segment max over rows, for float32 or bf16 data: out[s] = max of data[e]
// over the rows e with ids[e] == s, and 0 where that is empty or not finite
// (the rule of the JAX package's segment_max, bignn_tpu/ops/segment.py:
// 69-72). A NaN in a segment gives NaN, so 0. Values are compared in float32
// and the winner is stored in the data's type: the max of bf16 values is one
// of them, so the bf16 result is exact, equal to the plain version bit for
// bit (the TPU kernel also compares in float32 and casts back, :405, :413).
// Ids may come in any order; ids outside [0, num_segments) are dropped.
//
// Replaces bignn_tpu/ops/pallas/segment.py:_segment_max_kernel
// (segment_max_pallas), used by the max readout, and its VJP
// _segment_max_diff_bwd (:499-512), which the JAX package composes from an
// is-max mask, tie counts by segment_sum_pallas and two gathers. The TPU
// kernel finds each 128-segment block's row range with a searchsorted over
// the ids, so it is right only for sorted ids, and the readout's
// block-local ids put padding runs between molecules (ROADMAP F1, F2).
// These kernels are right for any ids:
//   forward (three launches):
//     1. bounds: each segment's first and last row (segment_bounds.cuh);
//     2. max: the walk of segment_walk.cuh with MaxOp, the segment sum's
//        walk (row slots of 16-byte words, up to 8 rows a lane in flight,
//        each row loaded before its id is known, up to 8 warps a segment
//        when segments are few), folding a max in float32 where the sum
//        adds. A max is exact and its folds commute (NaN wins every fold),
//        so the order of the walk does not change the result.
//   backward (one launch, on the bounds the forward found on the same
//   ids): d[e, f] = g[s, f] / cnt[s, f] where ids[e] = s is kept and
//   data[e, f] == out[s, f], else 0, with cnt[s, f] the rows of s equal to
//   out[s, f]: the composed rule, bit for bit. The compare is in float32
//   against the stored out, as the JAX rule's (:506), so -0.0 == 0.0, and
//   in a segment whose max was NaN or +-inf (stored as 0) the rows equal to
//   0 share g. cnt is an integer; the divide is float32 (g widened), with
//   one rounding to the data's type. The warps of a segment walk its rows
//   twice, in the forward's slots: the first walk counts ties per column
//   (an integer butterfly, then the warps in shared memory), the second
//   reads the rows again (from L2) and writes their d words. Rows that no
//   segment holds (holes between molecules, padding) are written 0 by the
//   blocks past the segments'. Every row of d is written once.
//
// What bounds them on the H100: device-memory bytes. The forward reads each
// valid row once (E * F * sizeof(T)) and the ids, and writes S * F values;
// the backward also reads out and g (S * F each) and writes all E * F of d.
// One comparison per element; the walks are bound by the latency of their
// loads at config2's shapes (~54 rows a segment, holes included).

#include <cuda_runtime.h>

#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"
#include "segment_walk.cuh"

namespace {

constexpr int kZeroRows = 4;  // rows each slot of a zeroing block writes

// d for the rows of segment s (see the head note); the blocks from
// walk_blocks on write 0 to the rows with a dropped id.
template <class T, int NV>
__global__ void __launch_bounds__(bignn::kMaxWarps * 32)
    max_bwd(const T* __restrict__ data, const int* __restrict__ ids,
            const T* __restrict__ out, const T* __restrict__ g,
            const int* __restrict__ first, const int* __restrict__ last,
            int num_rows, int num_segments, int feat, int warps_per_seg,
            int walk_blocks, T* __restrict__ d) {
  using W = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;
  // [warps_per_seg, 32, NV] when shared (named apart from the float
  // buffer of reduce_segments: one extern shared symbol has one type)
  extern __shared__ int ties[];
  const int lane = threadIdx.x % 32;
  const int words = feat / NV;
  if (static_cast<int>(blockIdx.x) >= walk_blocks) {
    // rows of no segment: e in the zeroing blocks' slots, stride nslots
    const bignn::Sweep sw(0, words, lane);
    const int64_t per_block = blockDim.x / 32 * sw.slots;
    const int64_t nslots = (gridDim.x - walk_blocks) * per_block;
    int64_t e = (blockIdx.x - walk_blocks) * per_block +
                threadIdx.x / 32 * sw.slots + sw.q;
    for (; e < num_rows; e += nslots) {
      const int s = __ldg(ids + e);
      if (s >= 0 && s < num_segments) continue;
      W* row = reinterpret_cast<W*>(d + e * feat);
      for (int k = sw.c; k < words; k += 1 << sw.lg) row[k] = W{};
    }
    return;
  }
  int w;
  const int s = bignn::block_segment(threadIdx.x / 32, warps_per_seg, w);
  if (s >= num_segments) return;  // never a shared segment's warp
  const int e0 = first[s];
  const int e1 = last[s];  // e1 < e0 for an empty segment
  for (int c0 = 0; c0 < words; c0 += 32) {
    const bignn::Sweep sw(c0, words, lane);
    const int64_t step = static_cast<int64_t>(sw.slots) * warps_per_seg;
    const int64_t col0 = static_cast<int64_t>(c0 + sw.c) * NV;
    const int64_t e = e0 + static_cast<int64_t>(w) * sw.slots + sw.q;
    // the segment's max and cotangent words
    float o[NV], share[NV];
    int cnt[NV];
    W ow{}, gw{};
    if (sw.mine) {
      ow = __ldg(reinterpret_cast<const W*>(
          out + static_cast<int64_t>(s) * feat + col0));
      gw = __ldg(reinterpret_cast<const W*>(
          g + static_cast<int64_t>(s) * feat + col0));
    }
    bignn::unpack_word<T, NV>(ow, o);
    bignn::unpack_word<T, NV>(gw, share);
#pragma unroll
    for (int i = 0; i < NV; ++i) cnt[i] = 0;
    auto count = [&](const W& word, int64_t) {
      float v[NV];
      bignn::unpack_word<T, NV>(word, v);
#pragma unroll
      for (int i = 0; i < NV; ++i) cnt[i] += v[i] == o[i];
    };
    bignn::walk_segment<T, NV, false, W>(data + col0, nullptr, ids, e, e0,
                                         e1, step, s, feat, sw.mine, count);
    // each word's ties over the warp's row slots, then over its warps
    for (int dd = 1 << sw.lg; dd < 32; dd <<= 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        cnt[i] += __shfl_xor_sync(bignn::kFull, cnt[i], dd);
    }
    if (warps_per_seg > 1) {
      if (sw.q == 0 && sw.mine) {
#pragma unroll
        for (int i = 0; i < NV; ++i) ties[(w * 32 + sw.c) * NV + i] = cnt[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        cnt[i] = 0;
        for (int k = 0; k < warps_per_seg; ++k)
          cnt[i] += ties[(k * 32 + sw.c) * NV + i];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      share[i] = share[i] / static_cast<float>(max(cnt[i], 1));
    auto write = [&](const W& word, int64_t r) {
      if (!sw.mine) return;
      float v[NV];
      bignn::unpack_word<T, NV>(word, v);
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = v[i] == o[i] ? share[i] : 0.f;
      *reinterpret_cast<W*>(d + r * feat + col0) =
          bignn::pack_word<T, NV, W>(v);
    };
    bignn::walk_segment<T, NV, false, W>(data + col0, nullptr, ids, e, e0,
                                         e1, step, s, feat, sw.mine, write);
  }
}

template <class T, int NV>
void launch_max_bwd(const T* data, const int* ids, const T* out, const T* g,
                    const int* first, const int* last, int num_rows,
                    int feat, int num_segments, T* d, cudaStream_t st) {
  const bignn::WalkGrid wg =
      bignn::walk_grid(num_rows, feat, NV, num_segments);
  const int slots = 32 >> bignn::slot_log2(feat / NV < 32 ? feat / NV : 32);
  const int zero_blocks =
      bignn::cdiv(num_rows, wg.threads / 32 * slots * kZeroRows);
  const size_t smem =
      wg.warps_per_seg == 1 ? 0 : sizeof(int) * wg.warps_per_seg * 32 * NV;
  if (wg.blocks + zero_blocks > 0) {
    max_bwd<T, NV><<<wg.blocks + zero_blocks, wg.threads, smem, st>>>(
        data, ids, out, g, first, last, num_rows, num_segments, feat,
        wg.warps_per_seg, wg.blocks, d);
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
      const T* d = static_cast<const T*>(data);
      T* o = static_cast<T*>(out);
      const int nv = bignn::word_values<T>(
          feat, reinterpret_cast<uintptr_t>(data) |
                    reinterpret_cast<uintptr_t>(out));
      bignn::with_word<T>(nv, [&](auto word) {
        bignn::launch_reduce<bignn::MaxOp, T, decltype(word)::value>(
            d, nullptr, id, f, l, num_rows, feat, num_segments, o, st);
      });
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// With `saved`, first/last hold the bounds that the forward found on the
// same ids (read only): one launch. Else they are scratch, and
// segment_bounds.cuh's pass finds the bounds first.
template <class T>
int segment_max_bwd(const void* data, const void* ids, const void* out,
                    const void* g, int num_rows, int feat, int num_segments,
                    void* first, void* last, int saved, void* d,
                    void* stream) {
  if (num_rows < 0 || feat < 0 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows == 0 || feat == 0) return static_cast<int>(cudaGetLastError());
  const int* id = static_cast<const int*>(ids);
  int* f = static_cast<int*>(first);
  int* l = static_cast<int*>(last);
  if (!saved) bignn::segment_bounds(id, num_rows, num_segments, f, l, st);
  const int nv = bignn::word_values<T>(
      feat, reinterpret_cast<uintptr_t>(data) |
                reinterpret_cast<uintptr_t>(out) |
                reinterpret_cast<uintptr_t>(g) |
                reinterpret_cast<uintptr_t>(d));
  bignn::with_word<T>(nv, [&](auto word) {
    launch_max_bwd<T, decltype(word)::value>(
        static_cast<const T*>(data), id, static_cast<const T*>(out),
        static_cast<const T*>(g), f, l, num_rows, feat, num_segments,
        static_cast<T*>(d), st);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// data [num_rows, feat] f32 or bf16, ids [num_rows] int32 (any order; ids
// outside [0, num_segments) dropped), out [num_segments, feat] in the data's
// type; first/last are [num_segments] int32 scratch, left holding each
// segment's bounds (segment_bounds.cuh). Returns cudaGetLastError().
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

// The VJP: data and ids as above, out [num_segments, feat] the forward's
// result and g its cotangent, d [num_rows, feat], all in the data's type.
// saved != 0: first/last hold the bounds the forward found on these ids
// (one launch); else they are scratch for a bounds pass of its own.
int bignn_segment_max_bwd_f32(const void* data, const void* ids,
                              const void* out, const void* g, int num_rows,
                              int feat, int num_segments, void* first,
                              void* last, int saved, void* d, void* stream) {
  return segment_max_bwd<float>(data, ids, out, g, num_rows, feat,
                                num_segments, first, last, saved, d, stream);
}

int bignn_segment_max_bwd_bf16(const void* data, const void* ids,
                               const void* out, const void* g, int num_rows,
                               int feat, int num_segments, void* first,
                               void* last, int saved, void* d, void* stream) {
  return segment_max_bwd<__nv_bfloat16>(data, ids, out, g, num_rows, feat,
                                        num_segments, first, last, saved, d,
                                        stream);
}

}  // extern "C"
