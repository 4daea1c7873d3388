// Multi-head weighted aggregation on the flat [*, H*D] layout (GAT message
// passing over an edge list), forward and backward, with F = H * D:
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
// five-step shuffle reductions in the backward).

#include <cuda_runtime.h>

#include <cstdint>

#include "segment_bounds.cuh"

namespace {

constexpr int kMaxHeads = 8;
constexpr int kColsPerLane = 8;  // F <= 256
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    mh_forward(const float* __restrict__ v, const int* __restrict__ src,
               const int* __restrict__ dst, const float* __restrict__ alpha,
               const int* __restrict__ first, const int* __restrict__ last,
               int num_src, int num_out, int heads, int head_dim,
               float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int d = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (d >= num_out) return;
  const int feat = heads * head_dim;
  const int e0 = first[d];
  const int e1 = last[d];
  int head[kColsPerLane];
  float acc[kColsPerLane];
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    head[k] = (lane + 32 * k) / head_dim;
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
      const float* row = v + static_cast<int64_t>(s) * feat;
      const float* a = alpha + static_cast<int64_t>(base + j) * heads;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c < feat) acc[k] += __ldg(a + head[k]) * __ldg(row + c);
      }
    }
  }
  float* o = out + static_cast<int64_t>(d) * feat;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < feat) o[c] = acc[k];
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    mh_backward(const float* __restrict__ v, const float* __restrict__ g,
                const int* __restrict__ dst, const float* __restrict__ alpha,
                const int* __restrict__ perm,
                const int* __restrict__ src_sorted,
                const int* __restrict__ first, const int* __restrict__ last,
                int num_src, int num_out, int heads, int head_dim,
                float* __restrict__ d_v, float* __restrict__ d_alpha) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= num_src) return;
  const int feat = heads * head_dim;
  const int i0 = first[s];
  const int i1 = last[s];
  int head[kColsPerLane];
  float vs[kColsPerLane], acc[kColsPerLane];
  const float* vrow = v + static_cast<int64_t>(s) * feat;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = lane + 32 * k;
    head[k] = c / head_dim;
    vs[k] = c < feat ? __ldg(vrow + c) : 0.f;
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
      float* da = d_alpha + static_cast<int64_t>(e) * heads;
      if (dd < 0 || dd >= num_out) {  // padding edge: no part, d_alpha 0
        if (lane < heads) da[lane] = 0.f;
        continue;
      }
      const float* grow = g + static_cast<int64_t>(dd) * feat;
      const float* a = alpha + static_cast<int64_t>(e) * heads;
      float part[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) part[h] = 0.f;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c < feat) {
          const float gc = __ldg(grow + c);
          acc[k] += __ldg(a + head[k]) * gc;
          const float p = gc * vs[k];
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
      if (lane < heads) da[lane] = mine_sum;
    }
  }
  float* o = d_v + static_cast<int64_t>(s) * feat;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < feat) o[c] = acc[k];
  }
}

bool bad_shape(int num_edges, int num_src, int num_out, int heads,
               int head_dim) {
  return num_edges < 0 || num_src < 1 || num_out < 0 || heads < 1 ||
         heads > kMaxHeads || head_dim < 1 ||
         heads * head_dim > 32 * kColsPerLane;
}

}  // namespace

extern "C" {

// v [num_src, heads * head_dim] f32, src/dst [num_edges] int32, alpha
// [num_edges, heads] f32, out [num_out, heads * head_dim] f32; first/last
// are [num_out] int32 scratch. heads <= 8, heads * head_dim <= 256.
// Returns cudaGetLastError().
int bignn_spmm_multihead_fwd_f32(const void* v, const void* src,
                                 const void* dst, const void* alpha,
                                 int num_edges, int num_src, int num_out,
                                 int heads, int head_dim, void* first,
                                 void* last, void* out, void* stream) {
  if (bad_shape(num_edges, num_src, num_out, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_out > 0) {
    int* f = static_cast<int*>(first);
    int* l = static_cast<int*>(last);
    const int* d = static_cast<const int*>(dst);
    bignn::segment_bounds(d, num_edges, num_out, f, l, st);
    mh_forward<<<bignn::cdiv(num_out, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
                 st>>>(static_cast<const float*>(v),
                       static_cast<const int*>(src), d,
                       static_cast<const float*>(alpha), f, l, num_src,
                       num_out, heads, head_dim, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// g [num_out, heads * head_dim] f32 (the cotangent of out), perm/src_sorted
// [num_edges] int32 (argsort of src, src[perm]), d_v like v, d_alpha like
// alpha; first/last are [num_src] int32 scratch. An edge whose src lies
// outside [0, num_src) is in no source's range and leaves its d_alpha row
// unwritten (the wrapper zero-fills it).
int bignn_spmm_multihead_bwd_f32(const void* v, const void* g,
                                 const void* dst, const void* alpha,
                                 const void* perm, const void* src_sorted,
                                 int num_edges, int num_src, int num_out,
                                 int heads, int head_dim, void* first,
                                 void* last, void* d_v, void* d_alpha,
                                 void* stream) {
  if (bad_shape(num_edges, num_src, num_out, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(first);
  int* l = static_cast<int*>(last);
  const int* ss = static_cast<const int*>(src_sorted);
  bignn::segment_bounds(ss, num_edges, num_src, f, l, st);
  mh_backward<<<bignn::cdiv(num_src, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
                st>>>(static_cast<const float*>(v),
                      static_cast<const float*>(g),
                      static_cast<const int*>(dst),
                      static_cast<const float*>(alpha),
                      static_cast<const int*>(perm), ss, f, l, num_src,
                      num_out, heads, head_dim, static_cast<float*>(d_v),
                      static_cast<float*>(d_alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
