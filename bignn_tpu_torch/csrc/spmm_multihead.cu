// Multi-head weighted aggregation on the flat [*, H*D] layout (GAT message
// passing over an edge list), forward and backward, with F = H * D, for
// float32 or bf16 v, alpha and g (products and sums in float32, one
// rounding at each store):
//   out[d, c]      = sum_{e: dst_e = d} alpha[e, h(c)] v[src_e, c]
//   d_v[s, c]      = sum_{e: src_e = s, dst_e < num_out} alpha[e, h(c)] g[dst_e, c]
//   d_alpha[e, h]  = sum_{c in head h} g[dst_e, c] v[src_e, c]   (0 when
//                    dst_e >= num_out)
// where h(c) = c / D. Edges with dst outside [0, num_out) (padding) take no
// part.
//
// Replaces bignn_tpu/ops/multihead.py:spmm_multihead on its Pallas path:
// the forward _mh_forward (gather v[src], scale by alpha, Pallas segment sum
// over dst) and the backward _mh_bwd (d_alpha as a per-head dot of the
// gathered rows; d_v as a Pallas segment sum of (g[dst] * alpha)[src_perm]
// over src_sorted). Both write [E, H*D] messages to HBM; here neither
// direction writes any [E, *] tensor wider than [E, H]:
//   forward:  one warp per destination walks its edges in edge order (bounds
//             of segment_bounds.cuh over dst). The warp loads 32 edges' ids
//             at once, one per lane, and broadcasts them with shuffles; each
//             lane gathers up to 8 columns (F <= 256) of the row v[src_e]
//             and accumulates alpha * v in registers.
//   backward: one warp per source walks its edges in the source-sorted
//             order (src_perm, src_sorted; bounds over src_sorted). The row
//             v[s] stays in registers. For each edge e the warp reads
//             g[dst_e] once and uses it twice: d_v[s] += alpha[e] * g[dst_e]
//             in registers, and d_alpha[e, h] = <g[dst_e], v[s]> over head
//             h's columns, reduced across the lanes by butterfly shuffles.
//             Every edge belongs to exactly one source, so d_alpha is
//             written once per edge and d_v once per source.
// No float atomics and a fixed order of every sum: a result repeats bit for
// bit. Every flat offset is 64-bit.
//
// What bounds it on the H100: device-memory bytes of the row gathers,
// E * F * 4 (8.2 GB for the 100K-drug graph's 16.1M edges at F = 128, a
// gather of 512-byte rows of a [N, F] table that L2 partly holds), against
// 2 * E * F * 4 written and read again by the plain version's messages.
// Per edge a warp does F multiply-adds (plus F for d_alpha, and H
// five-step shuffle reductions in the backward). In bf16 a lane reads its
// columns as pairs (__nv_bfloat162): the same walk, one edge after another,
// moves half the bytes; its latency stays.
//
// The JAX package rounds each bf16 message alpha * v to bf16 before the
// segment sum (multihead.py:81-83); here products are summed in float32 and
// rounded once, as the plain version of the port does.

#include <cuda_runtime.h>

#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"

namespace {

constexpr int kMaxHeads = 8;
constexpr int kColsPerLane = 8;  // F <= 256
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// Column of a lane's k-th value: V = 1 strides by 32 (lane + 32 k); V = 2
// reads pairs (2 lane + 64 (k / 2) + k % 2), for bf16 rows of even width.
template <int V>
__device__ __forceinline__ int col_of(int lane, int k) {
  return V == 1 ? lane + 32 * k : 2 * lane + 64 * (k / 2) + (k % 2);
}

template <class T, int V>
__device__ __forceinline__ void load_cols(const T* row, int feat, int lane,
                                          float (&out)[kColsPerLane]) {
#pragma unroll
  for (int k = 0; k < kColsPerLane; k += V) {
    const int c = col_of<V>(lane, k);
    if constexpr (V == 2) {
      const float2 p = c < feat ? bignn::load2(row + c) : make_float2(0.f, 0.f);
      out[k] = p.x;
      out[k + 1] = p.y;
    } else {
      out[k] = c < feat ? bignn::load1(row + c) : 0.f;
    }
  }
}

template <class T, int V>
__device__ __forceinline__ void store_cols(T* row, int feat, int lane,
                                           const float (&v)[kColsPerLane]) {
#pragma unroll
  for (int k = 0; k < kColsPerLane; k += V) {
    const int c = col_of<V>(lane, k);
    if constexpr (V == 2) {
      if (c < feat) bignn::store2(row + c, v[k], v[k + 1]);
    } else {
      if (c < feat) row[c] = bignn::from_f32<T>(v[k]);
    }
  }
}

template <class T, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    mh_forward(const T* __restrict__ v, const int* __restrict__ src,
               const int* __restrict__ dst, const T* __restrict__ alpha,
               const int* __restrict__ first, const int* __restrict__ last,
               int num_src, int num_out, int heads, int head_dim,
               T* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int d = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (d >= num_out) return;
  const int feat = heads * head_dim;
  const int e0 = first[d];
  const int e1 = last[d];
  int head[kColsPerLane];
  float acc[kColsPerLane], vals[kColsPerLane];
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = col_of<V>(lane, k);
    head[k] = c < feat ? c / head_dim : -1;
    acc[k] = 0.f;
  }
  for (int base = e0; base <= e1; base += 32) {
    const int mine = base + lane;
    const bool ok = mine <= e1 && __ldg(dst + mine) == d;
    int my_src = ok ? __ldg(src + mine) : -1;
    if (ok) my_src = min(max(my_src, 0), num_src - 1);  // JAX's clipped take
    const int n = min(32, e1 - base + 1);
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(kFull, my_src, j);
      if (s < 0) continue;  // a hole: another destination's edge
      load_cols<T, V>(v + static_cast<int64_t>(s) * feat, feat, lane, vals);
      const T* a = alpha + static_cast<int64_t>(base + j) * heads;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k)
        if (head[k] >= 0) acc[k] += bignn::load1(a + head[k]) * vals[k];
    }
  }
  store_cols<T, V>(out + static_cast<int64_t>(d) * feat, feat, lane, acc);
}

template <class T, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    mh_backward(const T* __restrict__ v, const T* __restrict__ g,
                const int* __restrict__ dst, const T* __restrict__ alpha,
                const int* __restrict__ perm,
                const int* __restrict__ src_sorted,
                const int* __restrict__ first, const int* __restrict__ last,
                int num_src, int num_out, int heads, int head_dim,
                T* __restrict__ d_v, T* __restrict__ d_alpha) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_src) return;
  const int feat = heads * head_dim;
  const int i0 = first[s];
  const int i1 = last[s];
  int head[kColsPerLane];
  float vs[kColsPerLane], acc[kColsPerLane], gv[kColsPerLane];
  load_cols<T, V>(v + static_cast<int64_t>(s) * feat, feat, lane, vs);
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = col_of<V>(lane, k);
    head[k] = c < feat ? c / head_dim : -1;
    acc[k] = 0.f;
  }
  for (int base = i0; base <= i1; base += 32) {
    const int mine = base + lane;
    const bool ok = mine <= i1 && __ldg(src_sorted + mine) == s;
    const int my_e = ok ? __ldg(perm + mine) : -1;
    const int my_d = ok ? __ldg(dst + my_e) : -1;
    const int n = min(32, i1 - base + 1);
    for (int j = 0; j < n; ++j) {
      const int e = __shfl_sync(kFull, my_e, j);
      if (e < 0) continue;  // a hole: another source's position
      const int dd = __shfl_sync(kFull, my_d, j);
      T* da = d_alpha + static_cast<int64_t>(e) * heads;
      if (dd < 0 || dd >= num_out) {  // padding edge: no part, d_alpha 0
        if (lane < heads) da[lane] = bignn::from_f32<T>(0.f);
        continue;
      }
      load_cols<T, V>(g + static_cast<int64_t>(dd) * feat, feat, lane, gv);
      const T* a = alpha + static_cast<int64_t>(e) * heads;
      float part[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) part[h] = 0.f;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        if (head[k] >= 0) {
          acc[k] += bignn::load1(a + head[k]) * gv[k];
          const float p = gv[k] * vs[k];
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h)
            if (h == head[k]) part[h] += p;
        }
      }
      float mine_sum = 0.f;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < heads) {
          const float t = bignn::warp_sum(part[h]);
          if (lane == h) mine_sum = t;
        }
      }
      if (lane < heads) da[lane] = bignn::from_f32<T>(mine_sum);
    }
  }
  store_cols<T, V>(d_v + static_cast<int64_t>(s) * feat, feat, lane, acc);
}

bool bad_shape(int num_edges, int num_src, int num_out, int heads,
               int head_dim) {
  return num_edges < 0 || num_src < 1 || num_out < 0 || heads < 1 ||
         heads > kMaxHeads || head_dim < 1 ||
         heads * head_dim > 32 * kColsPerLane;
}

template <class T>
int forward(const void* v, const void* src, const void* dst,
            const void* alpha, int num_edges, int num_src, int num_out,
            int heads, int head_dim, void* first, void* last, void* out,
            void* stream) {
  if (bad_shape(num_edges, num_src, num_out, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_out > 0) {
    int* f = static_cast<int*>(first);
    int* l = static_cast<int*>(last);
    const int* d = static_cast<const int*>(dst);
    bignn::segment_bounds(d, num_edges, num_out, f, l, st);
    const dim3 grid(bignn::cdiv(num_out, kWarpsPerBlock));
    const dim3 block(kWarpsPerBlock * 32);
    const T* vv = static_cast<const T*>(v);
    const int* s = static_cast<const int*>(src);
    const T* a = static_cast<const T*>(alpha);
    T* o = static_cast<T*>(out);
    if (bignn::pairs_ok<T>(heads * head_dim)) {
      mh_forward<T, 2><<<grid, block, 0, st>>>(vv, s, d, a, f, l, num_src,
                                               num_out, heads, head_dim, o);
    } else {
      mh_forward<T, 1><<<grid, block, 0, st>>>(vv, s, d, a, f, l, num_src,
                                               num_out, heads, head_dim, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int backward(const void* v, const void* g, const void* dst, const void* alpha,
             const void* perm, const void* src_sorted, int num_edges,
             int num_src, int num_out, int heads, int head_dim, void* first,
             void* last, void* d_v, void* d_alpha, void* stream) {
  if (bad_shape(num_edges, num_src, num_out, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(first);
  int* l = static_cast<int*>(last);
  const int* ss = static_cast<const int*>(src_sorted);
  bignn::segment_bounds(ss, num_edges, num_src, f, l, st);
  const dim3 grid(bignn::cdiv(num_src, kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(g);
  const int* d = static_cast<const int*>(dst);
  const T* a = static_cast<const T*>(alpha);
  const int* p = static_cast<const int*>(perm);
  T* dv = static_cast<T*>(d_v);
  T* da = static_cast<T*>(d_alpha);
  if (bignn::pairs_ok<T>(heads * head_dim)) {
    mh_backward<T, 2><<<grid, block, 0, st>>>(vv, gg, d, a, p, ss, f, l,
                                              num_src, num_out, heads,
                                              head_dim, dv, da);
  } else {
    mh_backward<T, 1><<<grid, block, 0, st>>>(vv, gg, d, a, p, ss, f, l,
                                              num_src, num_out, heads,
                                              head_dim, dv, da);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v [num_src, heads * head_dim], src/dst [num_edges] int32, alpha
// [num_edges, heads], out [num_out, heads * head_dim], v/alpha/out in one
// type (f32 or bf16); first/last are [num_out] int32 scratch. heads <= 8,
// heads * head_dim <= 256. Returns cudaGetLastError().
int bignn_spmm_multihead_fwd_f32(const void* v, const void* src,
                                 const void* dst, const void* alpha,
                                 int num_edges, int num_src, int num_out,
                                 int heads, int head_dim, void* first,
                                 void* last, void* out, void* stream) {
  return forward<float>(v, src, dst, alpha, num_edges, num_src, num_out,
                        heads, head_dim, first, last, out, stream);
}

int bignn_spmm_multihead_fwd_bf16(const void* v, const void* src,
                                  const void* dst, const void* alpha,
                                  int num_edges, int num_src, int num_out,
                                  int heads, int head_dim, void* first,
                                  void* last, void* out, void* stream) {
  return forward<__nv_bfloat16>(v, src, dst, alpha, num_edges, num_src,
                                num_out, heads, head_dim, first, last, out,
                                stream);
}

// g [num_out, heads * head_dim] (the cotangent of out), perm/src_sorted
// [num_edges] int32 (argsort of src, src[perm]), d_v like v, d_alpha like
// alpha, all floating tensors in one type; first/last are [num_src] int32
// scratch. An edge whose src lies outside [0, num_src) is in no source's
// range and leaves its d_alpha row unwritten (the wrapper zero-fills it).
int bignn_spmm_multihead_bwd_f32(const void* v, const void* g,
                                 const void* dst, const void* alpha,
                                 const void* perm, const void* src_sorted,
                                 int num_edges, int num_src, int num_out,
                                 int heads, int head_dim, void* first,
                                 void* last, void* d_v, void* d_alpha,
                                 void* stream) {
  return backward<float>(v, g, dst, alpha, perm, src_sorted, num_edges,
                         num_src, num_out, heads, head_dim, first, last, d_v,
                         d_alpha, stream);
}

int bignn_spmm_multihead_bwd_bf16(const void* v, const void* g,
                                  const void* dst, const void* alpha,
                                  const void* perm, const void* src_sorted,
                                  int num_edges, int num_src, int num_out,
                                  int heads, int head_dim, void* first,
                                  void* last, void* d_v, void* d_alpha,
                                  void* stream) {
  return backward<__nv_bfloat16>(v, g, dst, alpha, perm, src_sorted,
                                 num_edges, num_src, num_out, heads, head_dim,
                                 first, last, d_v, d_alpha, stream);
}

}  // extern "C"
