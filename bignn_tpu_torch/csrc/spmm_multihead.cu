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
//   backward: the walk over the source-sorted order (src_perm, src_sorted;
//             bounds over src_sorted) that gives d_v and d_alpha together:
//             for each edge e of source s the row g[dst_e] is read once and
//             used twice, d_v[s] += alpha[e] * g[dst_e] in registers and
//             d_alpha[e, h] = <g[dst_e], v[s]> over head h's columns. Every
//             edge belongs to one source, so d_alpha is written once per
//             edge and d_v once per source.
// No float atomics and a fixed order of every sum: a result repeats bit for
// bit. Every flat offset is 64-bit.
//
// What bounds it on the H100: the row gathers. The forward reads E * F * 4
// bytes of v rows (8.2 GB for the 100K-drug graph's 16.1M edges at F 128);
// the backward E * F * 4 of g rows (1.33 GB at 16,384 drugs, E 2.6M), from
// a [N, F] table that L2 holds (8 MB), against compulsory bytes of 0.14 GB
// (ids, alpha, d_alpha, v, g and d_v once: 0.0422 ms at 3.35 TB/s). The
// plain version writes and reads 2 * E * F * 4 bytes of messages. So the
// gathers are bound by L2's latency and rate, and the backward is laid out
// to keep many rows in flight:
//   - Lanes hold 16-byte words (4 f32 or 8 bf16 values) where F and the
//     pointers allow, else single values, in row slots of G lanes as
//     segment_sum.cu's (G the row's words rounded up to a power of two):
//     a 128-wide f32 row takes a warp, a 128-wide bf16 row 16 lanes, so a
//     warp walks two bf16 edges at once.
//   - Head h's columns are then a group of D / NV consecutive lanes (8 at
//     D 32 in f32): an edge's d_alpha[e, h] is one butterfly of log2(D /
//     NV) shuffles over the group, and the groups' first lanes store the H
//     values in one instruction. (The walk it replaced, lanes over columns
//     with 4-byte loads, paid H five-step butterflies and an H x 8
//     head select per edge.) A head that does not split into such a group
//     (D 3, or single values) takes a per-head butterfly over the slot.
//   - The warp loads the ids of 32 positions at once, one a lane (src_sorted
//     and perm together, then dst), and the next 32 while this chunk's rows
//     load; each slot then loads the g rows (and alpha values) of up to 8
//     edges before it reduces any, where the walk it replaced had one.
//   - A block holds 8 sources, a warp each. A source of more than 256
//     positions is shared by the block's 8 warps, chunk by chunk; their d_v
//     rows are added in shared memory in warp order. Which sources are long
//     is read from the bounds on the device, so the host never waits.
//     synthetic-large's outer graph has at most 244 edges a drug (mean
//     161), so no source there is long.
//   - Measured by scripts/compare_kernel_trees.py (device time of calls
//     queued back to back; NVIDIA H100 80GB HBM3, 700 W), H 4, D 32: f32 at
//     16,384 drugs (E 2.6M) 0.410 ms (the walk it replaced 2.27;
//     torch.sparse.mm of the transposed CSR plus sampled_addmm 0.894), on a
//     shard of config5-large's 8-shard plan (112,532 rows, 2.0M edges)
//     0.377 ms (1.80), bf16 on config4's sampled batch 0.029 ms (0.053).
//     scripts/probe_mh_bwd.py chose 4 rows a lane in flight and 4 blocks an
//     SM (at most 64 registers): 8 rows at 2 blocks took 0.534 ms, 16 rows
//     at 1 block 1.21, so warps in flight matter more than rows a warp.
//     That is ~3.2 TB/s of gathered g rows, from L2.
// Per edge the backward does 2 F multiply-adds; the forward walks one
// destination a warp, one edge after another, its lanes over columns
// (4-byte loads, bf16 pairs), and is not yet redesigned.
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
constexpr int kWarpsPerBlock = 4;  // forward
constexpr int kBwdWarps = 8;        // backward: sources a block holds
constexpr int kBwdMinBlocks = 4;    // backward blocks an SM holds at least
constexpr int kRowsInFlight = 4;    // g rows a backward lane loads at once
constexpr int kLong = 256;  // positions above which a source is the block's
constexpr int kMaxVals = 8;  // values of a row a backward lane holds
constexpr int kMaxFeat = 32 * kColsPerLane;
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

// The backward's lane layout (segment_sum.cu's row slots): a row of F
// values is `words` words of NV values (16 bytes where F and the pointers
// allow, else single values); the 32 lanes form 32 >> lg slots of
// G = 1 << lg lanes, G the words rounded up to a power of two (at most 32),
// and lane q G + c holds words c, c + G, ... (K of them) of slot q's rows.
// In the grouped form a word lies inside one head and a head's words are a
// power-of-two group of lanes (head_dim / NV of them).
template <class T, int NV>
using WordOf = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;

struct BwdArgs {
  const void* v;
  const void* g;
  const int* dst;
  const void* alpha;
  const int* perm;
  const int* src_sorted;
  const int* first;
  const int* last;
  int num_src, num_out, heads, head_dim, lg;
  void* d_v;
  void* d_alpha;
};

// The edge at position b + lane of the source-sorted order when it is
// source s's, else -1 (past i1, or a hole). Its two ids load together.
__device__ __forceinline__ int chunk_edge(const int* __restrict__ perm,
                                          const int* __restrict__ ss, int b,
                                          int i1, int s, int lane) {
  const int i = b + lane;
  if (i > i1) return -1;
  const int id = __ldg(ss + i);
  const int e = __ldg(perm + i);
  return id == s ? e : -1;
}

// A lane's K words of row r (zeros past the row), as floats.
template <class T, int NV, int K>
__device__ __forceinline__ void load_words(const T* __restrict__ rows,
                                           int64_t r, int feat, int c,
                                           int lg, float (&out)[K][NV]) {
  const WordOf<T, NV>* row =
      reinterpret_cast<const WordOf<T, NV>*>(rows + r * feat);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = c + (k << lg);
    bignn::unpack_word<T, NV>(w < feat / NV ? __ldg(row + w)
                                            : WordOf<T, NV>{},
                              out[k]);
  }
}

// acc += alpha[e, h(col)] * g[dst_e] and d_alpha[e, :] for the source s's
// positions b, b + 1, ... up to i1 taken in chunks of 32 every cstep
// positions: the chunk's edge and destination ids one a lane (the next
// chunk's ids in flight while this chunk's rows load), then the rows of U
// edges a slot, all loaded before any is reduced.
template <class T, int NV, int K, bool kGrouped>
__device__ __forceinline__ void bwd_walk(const BwdArgs& a, int s, int b,
                                         int i1, int cstep, int lane,
                                         const float (&vs)[K][NV],
                                         float (&acc)[K][NV]) {
  using W = WordOf<T, NV>;
  constexpr int U = K >= kRowsInFlight ? 1 : kRowsInFlight / K;
  constexpr int NA = kGrouped ? 1 : NV;  // alpha values a word needs
  const T* __restrict__ g = static_cast<const T*>(a.g);
  const T* __restrict__ alpha = static_cast<const T*>(a.alpha);
  T* __restrict__ d_alpha = static_cast<T*>(a.d_alpha);
  const int heads = a.heads;
  const int feat = heads * a.head_dim;
  const int lg = a.lg;
  const int slots = 32 >> lg;
  const int q = lane >> lg;
  const int c = lane & ((1 << lg) - 1);
  const int gs = kGrouped ? a.head_dim / NV : 1;  // lanes of a head's group
  // the head of each value this lane holds; -1 past the row
  int head[K][NV];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (c + (k << lg)) * NV + i;
      head[k][i] = c + (k << lg) < feat / NV ? col / a.head_dim : -1;
    }
  }
  int e_l = chunk_edge(a.perm, a.src_sorted, b, i1, s, lane);
  int d_l = e_l >= 0 ? __ldg(a.dst + e_l) : -1;
  for (; b <= i1; b += cstep) {
    const int e_next = chunk_edge(a.perm, a.src_sorted, b + cstep, i1, s,
                                  lane);
    const int n = min(32, i1 - b + 1);
    for (int j0 = 0; j0 < n; j0 += slots * U) {
      int e[U];
      bool live[U];
      W w[U][K];
      float al[U][K][NA];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + q + slots * u;
        e[u] = __shfl_sync(kFull, e_l, j & 31);
        const int d = __shfl_sync(kFull, d_l, j & 31);
        if (j >= 32) e[u] = -1;
        // padding edges (dst outside [0, num_out)) get d_alpha 0
        live[u] = e[u] >= 0 && d >= 0 && d < a.num_out;
        const W* row = reinterpret_cast<const W*>(
            g + static_cast<int64_t>(live[u] ? d : 0) * feat);
        const T* ar = alpha + static_cast<int64_t>(live[u] ? e[u] : 0) * heads;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool in = live[u] && head[k][0] >= 0;
          w[u][k] = in ? __ldg(row + c + (k << lg)) : W{};
#pragma unroll
          for (int i = 0; i < NA; ++i)
            al[u][k][i] =
                live[u] && head[k][i] >= 0 ? bignn::load1(ar + head[k][i])
                                           : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T* da = d_alpha + static_cast<int64_t>(e[u] >= 0 ? e[u] : 0) * heads;
        float part[kGrouped ? K : kMaxHeads];
#pragma unroll
        for (int h = 0; h < (kGrouped ? K : kMaxHeads); ++h) part[h] = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float gv[NV];
          bignn::unpack_word<T, NV>(w[u][k], gv);
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            acc[k][i] += al[u][k][kGrouped ? 0 : i] * gv[i];
            const float p = gv[i] * vs[k][i];
            if constexpr (kGrouped) {
              part[k] += p;
            } else {
#pragma unroll
              for (int h = 0; h < kMaxHeads; ++h)
                if (h == head[k][i]) part[h] += p;
            }
          }
        }
        if constexpr (kGrouped) {
          // one butterfly over each head's group; its first lane stores,
          // so an edge's H values go out in one store instruction
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float t = part[k];
            for (int o = 1; o < gs; o <<= 1) t += __shfl_xor_sync(kFull, t, o);
            if (e[u] >= 0 && head[k][0] >= 0 && (c & (gs - 1)) == 0)
              da[head[k][0]] = bignn::from_f32<T>(t);
          }
        } else {
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h) {
            if (h < heads) {
              float t = part[h];
              for (int o = 1; o < (1 << lg); o <<= 1)
                t += __shfl_xor_sync(kFull, t, o);
              if (e[u] >= 0 && c == 0) da[h] = bignn::from_f32<T>(t);
            }
          }
        }
      }
    }
    e_l = e_next;
    d_l = e_l >= 0 ? __ldg(a.dst + e_l) : -1;
  }
}

// acc summed over the warp's row slots (a fixed butterfly): slot 0's lanes
// hold the warp's sums.
template <int K, int NV>
__device__ __forceinline__ void slot_sum(float (&acc)[K][NV], int lg) {
  for (int o = 1 << lg; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        acc[k][i] += __shfl_xor_sync(kFull, acc[k][i], o);
    }
  }
}

// A block holds kBwdWarps sources. Each source of up to kLong positions is
// walked by its own warp; a longer one by all the block's warps, chunk w,
// w + kBwdWarps, ... to warp w, their d_v rows added in shared memory in
// warp order. Whether a source is long is read from its bounds on the
// device, never on the host.
template <class T, int NV, int K, bool kGrouped>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks)
    mh_backward(__grid_constant__ const BwdArgs a) {
  using W = WordOf<T, NV>;
  __shared__ float part[kBwdWarps * kMaxFeat];
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ d_v = static_cast<T*>(a.d_v);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int feat = a.heads * a.head_dim;
  const int q = lane >> a.lg;
  const int c = lane & ((1 << a.lg) - 1);
  const int s0 = blockIdx.x * kBwdWarps;
  float vs[K][NV], acc[K][NV];
  const int s = s0 + warp;
  if (s < a.num_src && a.last[s] - a.first[s] < kLong) {
    load_words<T, NV, K>(v, s, feat, c, a.lg, vs);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[k][i] = 0.f;
    }
    bwd_walk<T, NV, K, kGrouped>(a, s, a.first[s], a.last[s], 32, lane, vs,
                                 acc);
    slot_sum(acc, a.lg);
    W* out = reinterpret_cast<W*>(d_v + static_cast<int64_t>(s) * feat);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = c + (k << a.lg);
      if (q == 0 && w < feat / NV) out[w] = bignn::pack_word<T, NV, W>(acc[k]);
    }
  }
  for (int j = 0; j < kBwdWarps && s0 + j < a.num_src; ++j) {
    const int sj = s0 + j;
    const int i0 = a.first[sj];
    const int i1 = a.last[sj];
    if (i1 - i0 < kLong) continue;
    load_words<T, NV, K>(v, sj, feat, c, a.lg, vs);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[k][i] = 0.f;
    }
    bwd_walk<T, NV, K, kGrouped>(a, sj, i0 + 32 * warp, i1, 32 * kBwdWarps,
                                 lane, vs, acc);
    slot_sum(acc, a.lg);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = c + (k << a.lg);
      if (q == 0 && w < feat / NV) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          part[warp * feat + w * NV + i] = acc[k][i];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < feat; col += blockDim.x) {
      float t = part[col];
      for (int w = 1; w < kBwdWarps; ++w) t += part[w * feat + col];
      d_v[static_cast<int64_t>(sj) * feat + col] = bignn::from_f32<T>(t);
    }
    __syncthreads();
  }
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
    // pairs need every row of v and out on 4 bytes
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
    if (bignn::pairs_ok<T>(heads * head_dim) && addr % 4 == 0) {
      mh_forward<T, 2><<<grid, block, 0, st>>>(vv, s, d, a, f, l, num_src,
                                               num_out, heads, head_dim, o);
    } else {
      mh_forward<T, 1><<<grid, block, 0, st>>>(vv, s, d, a, f, l, num_src,
                                               num_out, heads, head_dim, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T, int NV, int K, bool kGrouped>
void launch_backward(const BwdArgs& a, cudaStream_t st) {
  mh_backward<T, NV, K, kGrouped>
      <<<bignn::cdiv(a.num_src, kBwdWarps), kBwdWarps * 32, 0, st>>>(a);
}

// K, the words a lane holds, rounded up to 1, 2, 4 or 8 (K NV <= 8 values).
template <class T, int NV, bool kGrouped>
void launch_backward_k(const BwdArgs& a, int k, cudaStream_t st) {
  if (k <= 1) {
    launch_backward<T, NV, 1, kGrouped>(a, st);
  } else if constexpr (kMaxVals / NV >= 2) {
    if (k <= 2) {
      launch_backward<T, NV, 2, kGrouped>(a, st);
    } else if constexpr (kMaxVals / NV >= 8) {
      if (k <= 4) {
        launch_backward<T, NV, 4, kGrouped>(a, st);
      } else {
        launch_backward<T, NV, 8, kGrouped>(a, st);
      }
    }
  }
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
  // 16-byte words where every row of v, g and d_v starts on 16 bytes
  constexpr int kWide = 16 / static_cast<int>(sizeof(T));
  const int feat = heads * head_dim;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(d_v);
  const bool wide = feat % kWide == 0 && addr % 16 == 0;
  const int nv = wide ? kWide : 1;
  const int words = feat / nv;
  const int lg = bignn::slot_log2(words < 32 ? words : 32);
  const int k = bignn::cdiv(words, 1 << lg);
  const int group = head_dim / nv;
  const bool grouped = wide && head_dim % nv == 0 && group <= 32 &&
                       (group & (group - 1)) == 0;
  const BwdArgs a{v, g, static_cast<const int*>(dst), alpha,
                  static_cast<const int*>(perm), ss, f, l, num_src, num_out,
                  heads, head_dim, lg, d_v, d_alpha};
  if (grouped) {
    launch_backward_k<T, kWide, true>(a, k, st);
  } else if (wide) {
    launch_backward_k<T, kWide, false>(a, k, st);
  } else {
    launch_backward_k<T, 1, false>(a, k, st);
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
