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
//   2. sum: the warps of a segment walk [first, last] and add, in f32, the
//      rows whose id equals the segment; other rows (holes, other
//      segments' rows) are skipped by their id.
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
// (the id, then perm[e], then the row), not by bytes. The design puts many
// rows in flight:
//   - A row is read as 16-byte words where its width and the base address
//     allow (f32 4 values, bf16 8), else as 8-, 4- or 2-byte words. The
//     lanes of a warp split into row slots of G lanes, G the row's words
//     rounded up to a power of two (at most 32): lane q G + c reads word c
//     of its slot's rows. So the gather's [E, 4] f32 rows take one lane
//     each (32 rows a warp), config2's 128-wide f32 rows a whole warp, and
//     128-wide bf16 rows 16 lanes. Rows wider than 32 words take more
//     sweeps over the segment.
//   - Each lane has up to kUnroll rows in flight: it loads their ids (and
//     perm entries) together, then their words. The no-perm form loads
//     row e before its id is known and adds it only if the id matches, so
//     a pass is one trip to memory; the permuted form needs two. A segment
//     that spans few rows (config4's sampled outer graph: ~4 edges a drug)
//     takes 1 or 4 rows a lane, so that its warp issues no idle loads.
//   - Few segments (config2's ~430 molecules a bucket) would leave most of
//     the 132 SMs idle at one warp a segment: then up to kMaxWarps warps
//     share a segment's rows and their sums are added in shared memory in
//     warp order.
// Every sum runs in a fixed order (each lane in row order, a butterfly
// across a warp's row slots, then the warps in order), with no float
// atomics, so a result repeats bit for bit. Flat offsets are 64-bit.
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

namespace {

constexpr int kUnroll = 8;            // most rows a lane has in flight
constexpr int kMaxWarps = 8;          // warps that may share one segment
constexpr int kSegsPerBlock = 2;      // segments of a block of one warp each
constexpr int kFillWarps = 132 * 32;  // warps that keep the 132 SMs busy
constexpr unsigned kFull = 0xffffffffu;

// acc[0 .. NV) += the NV values of T packed in w.
template <class T, int NV, class W>
__device__ __forceinline__ void add_word(const W& w, float (&acc)[NV]) {
  float v[NV];
  bignn::unpack_word<T, NV>(w, v);
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] += v[i];
}

// acc += the word of each of a lane's rows e, e + step, ... up to e1 whose
// id is s, U rows in flight: their ids (and perm entries) are loaded
// together, then their words. The no-perm form loads row e before its id
// is known (it is the row itself) and adds it only if the id matches.
template <class T, int NV, bool kPerm, int U, class W>
__device__ __forceinline__ void walk(const T* col, const int* perm,
                                     const int* ids, int64_t e, int e1,
                                     int64_t step, int s, int feat,
                                     bool mine, float (&acc)[NV]) {
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
      if (id[u] == s) add_word<T, NV>(word[u], acc);
  }
}

// A block holds kSegsPerBlock segments of one warp each, or one segment of
// warps_per_seg warps. Warp w of a segment reads the rows
// e0 + w R + q + k R warps_per_seg (k = 0, 1, ...) in its slot q, with
// R = 32 / G slots a warp; NV values of T make one word.
template <class T, int NV, bool kPerm>
__global__ void __launch_bounds__(kMaxWarps * 32)
    sum_segments(const T* __restrict__ data, const int* __restrict__ perm,
                 const int* __restrict__ ids, const int* __restrict__ first,
                 const int* __restrict__ last, int num_segments, int feat,
                 int warps_per_seg, T* __restrict__ out) {
  using W = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;
  extern __shared__ float part[];  // [warps_per_seg, 32, NV] when shared
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int w = warp % warps_per_seg;
  const int s = blockIdx.x * (blockDim.x / 32 / warps_per_seg) +
                warp / warps_per_seg;
  if (s >= num_segments) return;  // never a shared segment's warp
  const int e0 = first[s];
  const int e1 = last[s];  // e1 < e0 for an empty segment
  const int words = feat / NV;
  T* o = out + static_cast<int64_t>(s) * feat;
  for (int c0 = 0; c0 < words; c0 += 32) {
    const int m = min(32, words - c0);  // words of this sweep
    const int lg = bignn::slot_log2(m);
    const int q = lane >> lg;
    const int c = lane & ((1 << lg) - 1);
    const bool mine = c < m;
    const int slots = 32 >> lg;
    const int64_t step = static_cast<int64_t>(slots) * warps_per_seg;
    const T* col = data + static_cast<int64_t>(c0 + c) * NV;
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
    // as many rows in flight as a lane has, up to kUnroll
    const int64_t e = e0 + static_cast<int64_t>(w) * slots + q;
    const int64_t n = static_cast<int64_t>(e1) - e0 + 1;  // rows spanned
    if (n <= step) {
      walk<T, NV, kPerm, 1, W>(col, perm, ids, e, e1, step, s, feat, mine,
                               acc);
    } else if (n <= 4 * step) {
      walk<T, NV, kPerm, 4, W>(col, perm, ids, e, e1, step, s, feat, mine,
                               acc);
    } else {
      walk<T, NV, kPerm, kUnroll, W>(col, perm, ids, e, e1, step, s, feat,
                                     mine, acc);
    }
    // each word's sums over the warp's row slots
    for (int d = 1 << lg; d < 32; d <<= 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        acc[i] += __shfl_xor_sync(kFull, acc[i], d);
    }
    W* dst = reinterpret_cast<W*>(o + static_cast<int64_t>(c0 + c) * NV);
    if (warps_per_seg == 1) {
      if (q == 0 && mine) *dst = bignn::pack_word<T, NV, W>(acc);
      continue;
    }
    if (q == 0 && mine) {
#pragma unroll
      for (int i = 0; i < NV; ++i) part[(w * 32 + c) * NV + i] = acc[i];
    }
    __syncthreads();
    if (w == 0 && q == 0 && mine) {
      for (int k = 1; k < warps_per_seg; ++k) {
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] += part[(k * 32 + c) * NV + i];
      }
      *dst = bignn::pack_word<T, NV, W>(acc);
    }
    __syncthreads();
  }
}

template <class T, int NV>
void launch_sum(const T* data, const int* perm, const int* ids,
                const int* first, const int* last, int num_rows, int feat,
                int num_segments, T* out, cudaStream_t st) {
  // share a segment among more warps while the card has room for them and
  // each keeps two passes of rows (mean rows a segment spans)
  const int64_t slots = 32 >> bignn::slot_log2(feat / NV < 32 ? feat / NV : 32);
  const int64_t rows = num_rows / num_segments;
  int wps = 1;
  while (wps < kMaxWarps &&
         static_cast<int64_t>(num_segments) * wps < kFillWarps &&
         rows >= 2 * wps * slots * kUnroll)
    wps *= 2;
  const int segs = wps == 1 ? kSegsPerBlock : 1;
  const dim3 grid(bignn::cdiv(num_segments, segs));
  const dim3 block(32 * wps * segs);
  const size_t smem = wps == 1 ? 0 : sizeof(float) * wps * 32 * NV;
  if (perm != nullptr) {
    sum_segments<T, NV, true><<<grid, block, smem, st>>>(
        data, perm, ids, first, last, num_segments, feat, wps, out);
  } else {
    sum_segments<T, NV, false><<<grid, block, smem, st>>>(
        data, perm, ids, first, last, num_segments, feat, wps, out);
  }
}

// Values of T in the widest word (16, 8 or 4 bytes, else one value) on
// which every row of data and of out starts.
template <class T>
int word_values(const void* data, const void* out, int feat) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(out);
  const int64_t row = static_cast<int64_t>(feat) * sizeof(T);
  for (int b = 16; b > static_cast<int>(sizeof(T)); b /= 2)
    if (row % b == 0 && a % b == 0) return b / static_cast<int>(sizeof(T));
  return 1;
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
      const T* d = static_cast<const T*>(data);
      const int* p = static_cast<const int*>(perm);
      T* o = static_cast<T*>(out);
      const int nv = word_values<T>(data, out, feat);
      if constexpr (sizeof(T) == 2) {
        if (nv == 8) {
          launch_sum<T, 8>(d, p, id, f, l, num_rows, feat, num_segments, o,
                           st);
          return static_cast<int>(cudaGetLastError());
        }
      }
      if (nv == 4) {
        launch_sum<T, 4>(d, p, id, f, l, num_rows, feat, num_segments, o, st);
      } else if (nv == 2) {
        launch_sum<T, 2>(d, p, id, f, l, num_rows, feat, num_segments, o, st);
      } else {
        launch_sum<T, 1>(d, p, id, f, l, num_rows, feat, num_segments, o, st);
      }
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
