// Sorted-COO SpMM over an edge list, forward and backward, for float32 or
// bf16 rows (float32 weights, float32 sums, one rounding at the store):
//   y[d, :]   = sum_{e: dst_e = d} w_e x[clip(src_e), :]          (forward)
//   d_x[s, :] = sum_{e: src_e = s, 0 <= dst_e < num_out} w_e g[dst_e, :]
// with w_e = 1 when no weights are given (GIN's unweighted sum). Edges with
// dst outside [0, num_out) (padding: dst == node_cap) take no part.
//
// Replaces bignn_tpu/ops/pallas/spmm.py:spmm_pallas: its forward (_forward:
// a row gather x[src], the weight, then the Pallas sorted segment sum over
// dst) and its backward (_dx_sorted: the per-edge cotangent g[dst] * w,
// permuted to source order and summed by the same Pallas kernel over
// src_sorted). Both write an [E, F] message tensor to HBM and read it back;
// here neither direction does: each output row is summed in registers and
// stored once.
//   forward:  one warp per destination row walks the row's edges (bounds of
//             segment_bounds.cuh over dst, so padding ids between runs, the
//             holes of F1, are skipped and never summed). The warp loads 32
//             edges' ids and weights at once, one per lane, and hands them
//             round by shuffles.
//   backward: the same kernel in a permuted-read form: one warp per source
//             row walks its positions i in the source-sorted order
//             (src_sorted, bounds over it) and reads edge e = perm[i]: row
//             g[dst_e] and weight w_e. This is _dx_sorted fused: no permuted
//             copy of the cotangent is made.
// Narrow rows: a lane reads VEC consecutive values in one 16-byte load (4
// floats, or 8 bf16) when F is a multiple of VEC and the rows are 16-byte
// aligned; else bf16 pairs (even F) or single values. An edge takes L = the
// power of two >= F / VEC lanes (at most 32), so a warp works on P = 32 / L
// edges at once (float32 F = 32: 8 lanes, 4 edges; F = 64: 2 edges; F =
// 128: 1 edge; bf16 F = 128: 16 lanes, 2 edges); the P partial sums are
// added by butterfly shuffles at the end. Each sum runs in a fixed order and
// there are no float atomics: a result repeats bit for bit.
// bf16 rounding as the JAX package's (ops/pallas/spmm.py:55, :97): the
// weight is rounded to bf16 and so is each weighted message w_e x[s], before
// the float32 sum (unweighted messages are the bf16 rows themselves). For
// float32 both roundings are the identity.
//
// What bounds it on the H100: device-memory bytes of the row gathers. Each
// edge reads one F-wide row of x (E * F * sizeof(T) bytes; the rows a molecule's
// edges read are few and L2 holds them, so the least the card must move is
// x, the ids, the weights and y once each), against the plain version's [E,
// F] messages written and read again. The walk is latency-bound as much as
// byte-bound: an edge is a dependent id load and a row load, and a molecule
// row has only ~3 edges (with its self-loop), so a warp has little in flight.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "elem.cuh"
#include "segment_bounds.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// One warp per output row r. Position i in [first[r], last[r]] belongs to r
// when ids[i] == r; it names edge e = perm[i] (e = i without perm), whose
// gathered row is rows[e] and weight weight[e] (1 without weights). clip:
// a gathered index outside [0, num_x) is clipped (the forward, as JAX's
// take(mode="clip")); otherwise such an edge is dropped (the backward's
// padding edges, dst == num_out).
template <class T, int VEC, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    spmm_rows(const T* __restrict__ x, int num_x, const int* __restrict__ ids,
              const int* __restrict__ perm, const int* __restrict__ rows,
              const float* __restrict__ weight, const int* __restrict__ first,
              const int* __restrict__ last, int num_out, int feat, bool clip,
              T* __restrict__ out) {
  constexpr int L = 32 / P;  // lanes per edge
  const int lane = threadIdx.x % 32;
  const int grp = lane / L;  // which of the P edges in flight
  const int sub = lane % L;
  const int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= num_out) return;
  const int i0 = first[r];
  const int i1 = last[r];  // i1 < i0 for an empty row
  T* o = out + static_cast<int64_t>(r) * feat;
  for (int f0 = 0; f0 < feat; f0 += L * VEC) {
    const int c = f0 + sub * VEC;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int base = i0; base <= i1; base += 32) {
      const int mine = base + lane;
      int my_row = -1;
      float my_w = 0.f;
      if (mine <= i1 && __ldg(ids + mine) == r) {
        const int e = perm == nullptr ? mine : __ldg(perm + mine);
        int g = __ldg(rows + e);
        if (clip) {
          g = min(max(g, 0), num_x - 1);
        } else if (g >= num_x) {
          g = -1;
        }
        if (g >= 0) {
          my_row = g;
          my_w = weight == nullptr ? 1.f
                                   : bignn::round_to<T>(__ldg(weight + e));
        }
      }
      const int n = min(32, i1 - base + 1);
      for (int j = 0; j < n; j += P) {
        // j <= 32 - P, so j + grp is a lane; lanes past n hold row -1
        const int g = __shfl_sync(kFull, my_row, j + grp);
        const float w = __shfl_sync(kFull, my_w, j + grp);
        if (g < 0 || c >= feat) continue;
        float v[VEC];
        bignn::load_vec<VEC>(x + static_cast<int64_t>(g) * feat + c, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += bignn::round_to<T>(w * v[k]);
      }
    }
    // the P groups' partial sums, in a fixed butterfly order
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
#pragma unroll
      for (int off = L; off < 32; off <<= 1)
        acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    }
    if (grp == 0 && c < feat) bignn::store_vec<VEC>(o + c, acc);
  }
}

template <class T, int VEC>
void launch_rows(int per_edge, dim3 grid, dim3 block, cudaStream_t st,
                 const T* x, int num_x, const int* ids, const int* perm,
                 const int* rows, const float* weight, const int* first,
                 const int* last, int num_out, int feat, bool clip, T* out) {
  // P edges at once, so that an edge's L = 32 / P lanes cover its row
  if (per_edge <= 4) {
    spmm_rows<T, VEC, 8><<<grid, block, 0, st>>>(
        x, num_x, ids, perm, rows, weight, first, last, num_out, feat, clip,
        out);
  } else if (per_edge <= 8) {
    spmm_rows<T, VEC, 4><<<grid, block, 0, st>>>(
        x, num_x, ids, perm, rows, weight, first, last, num_out, feat, clip,
        out);
  } else if (per_edge <= 16) {
    spmm_rows<T, VEC, 2><<<grid, block, 0, st>>>(
        x, num_x, ids, perm, rows, weight, first, last, num_out, feat, clip,
        out);
  } else {
    spmm_rows<T, VEC, 1><<<grid, block, 0, st>>>(
        x, num_x, ids, perm, rows, weight, first, last, num_out, feat, clip,
        out);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <class T>
int spmm(const void* x, int num_x, const void* ids, int num_pos,
         const void* perm, const void* rows, const void* weight, int num_out,
         int feat, bool clip, void* first, void* last, void* out,
         void* stream) {
  if (num_x < 0 || num_pos < 0 || num_out < 0 || feat < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_out > 0) {
    const int* id = static_cast<const int*>(ids);
    int* f = static_cast<int*>(first);
    int* l = static_cast<int*>(last);
    bignn::segment_bounds(id, num_pos, num_out, f, l, st);
    if (feat > 0) {
      const T* xx = static_cast<const T*>(x);
      T* o = static_cast<T*>(out);
      // 16-byte loads: 4 floats or 8 bf16 a lane
      constexpr int kWide = 16 / sizeof(T);
      const bool wide = feat % kWide == 0 && aligned(xx, 16) &&
                        aligned(o, 16);
      const dim3 grid(bignn::cdiv(num_out, kWarpsPerBlock));
      const dim3 block(kWarpsPerBlock * 32);
      const int* p = static_cast<const int*>(perm);
      const int* r = static_cast<const int*>(rows);
      const float* w = static_cast<const float*>(weight);
      if (wide) {
        launch_rows<T, kWide>(feat / kWide, grid, block, st, xx, num_x, id,
                              p, r, w, f, l, num_out, feat, clip, o);
      } else if constexpr (std::is_same<T, float>::value) {
        launch_rows<T, 1>(feat, grid, block, st, xx, num_x, id, p, r, w, f,
                          l, num_out, feat, clip, o);
      } else if (bignn::pairs_ok<T>(feat) && aligned(xx, 4) &&
                 aligned(o, 4)) {
        launch_rows<T, 2>(feat / 2, grid, block, st, xx, num_x, id, p, r, w,
                          f, l, num_out, feat, clip, o);
      } else {
        launch_rows<T, 1>(feat, grid, block, st, xx, num_x, id, p, r, w, f,
                          l, num_out, feat, clip, o);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Forward. x [num_x, feat] f32 or bf16, src/dst [num_edges] int32 (dst
// sorted for speed, right in any order), weight [num_edges] f32 or null, out
// [num_out, feat] in x's type; first/last are [num_out] int32 scratch.
// Returns cudaGetLastError().
int bignn_spmm_f32(const void* x, int num_x, const void* src, const void* dst,
                   const void* weight, int num_edges, int num_out, int feat,
                   void* first, void* last, void* out, void* stream) {
  return spmm<float>(x, num_x, dst, num_edges, nullptr, src, weight, num_out,
                     feat, true, first, last, out, stream);
}

int bignn_spmm_bf16(const void* x, int num_x, const void* src,
                    const void* dst, const void* weight, int num_edges,
                    int num_out, int feat, void* first, void* last, void* out,
                    void* stream) {
  return spmm<__nv_bfloat16>(x, num_x, dst, num_edges, nullptr, src, weight,
                             num_out, feat, true, first, last, out, stream);
}

// Backward d_x. g [num_g, feat] f32 or bf16 (the cotangent of the forward's
// output, num_g = its num_out), dst/weight as in the forward,
// perm/src_sorted [num_edges] int32 (argsort of src, src[perm]), d_x
// [num_x, feat] in g's type; first/last are [num_x] int32 scratch.
int bignn_spmm_bwd_f32(const void* g, int num_g, const void* dst,
                       const void* weight, const void* perm,
                       const void* src_sorted, int num_edges, int num_x,
                       int feat, void* first, void* last, void* d_x,
                       void* stream) {
  return spmm<float>(g, num_g, src_sorted, num_edges, perm, dst, weight,
                     num_x, feat, false, first, last, d_x, stream);
}

int bignn_spmm_bwd_bf16(const void* g, int num_g, const void* dst,
                        const void* weight, const void* perm,
                        const void* src_sorted, int num_edges, int num_x,
                        int feat, void* first, void* last, void* d_x,
                        void* stream) {
  return spmm<__nv_bfloat16>(g, num_g, src_sorted, num_edges, perm, dst,
                             weight, num_x, feat, false, first, last, d_x,
                             stream);
}

}  // extern "C"
