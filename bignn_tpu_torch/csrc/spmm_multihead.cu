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
//   forward:  the walk over each destination's edges in edge order (bounds
//             of segment_bounds.cuh over dst): out[d] += alpha[e] * v[src_e]
//             in registers, written once per destination.
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
// bytes of v rows (1.33 GB at 16,384 drugs, E 2.6M, F 128; 8.2 GB for the
// 100K-drug graph's 16.1M edges), the backward as many of g rows, from a
// [N, F] table that L2 holds at 16,384 drugs (8 MB; 51 MB at 100K, about
// L2's size), against compulsory bytes of 0.14 GB at E 2.6M (ids, alpha,
// v and out once: 0.0422 ms at 3.35 TB/s for the backward's). The plain
// version writes and reads 2 * E * F * 4 bytes of messages. So the gathers
// are bound by L2's latency and rate, and both directions are laid out to
// keep many rows in flight:
//   - Lanes hold 16-byte words (4 f32 or 8 bf16 values) where F, D and the
//     pointers allow, else single values, in row slots of G lanes as
//     segment_sum.cu's (G the row's words rounded up to a power of two):
//     a 128-wide f32 row takes a warp, a 128-wide bf16 row 16 lanes, so a
//     warp walks two bf16 edges at once. A slot sums its edges in edge
//     order, in float32; the slots' partials are added by shuffles in a
//     fixed order at the end, and rounded once at the store.
//   - A word lies inside one head, so a lane loads alpha[e, h] once an edge
//     and word (the walk the forward replaced, lanes over columns with
//     4-byte loads, loaded it once a column: 8 loads of the same 1-4
//     values an edge).
//   - In the backward, head h's columns are a group of D / NV consecutive
//     lanes (8 at D 32 in f32): an edge's d_alpha[e, h] is one butterfly
//     of log2(D / NV) shuffles over the group, and the groups' first lanes
//     store the H values in one instruction. (The walk it replaced paid H
//     five-step butterflies and an H x 8 head select per edge.) A head
//     that does not split into such a group (D 3, or single values) takes
//     a per-head butterfly over the slot.
//   - The warp loads the ids of 32 positions at once, one a lane (forward:
//     dst and src together; backward: src_sorted and perm together, then
//     dst), and the next 32 while this chunk's rows load; each slot then
//     loads the rows (and alpha values) of up to 4 edges before it adds
//     any, where the walks they replaced had one row in flight a warp.
//   - A block holds 8 destinations (forward) or sources (backward), a warp
//     each. One of more than 256 positions is shared by the block's 8
//     warps, chunk by chunk; their rows are added in shared memory in warp
//     order. Which are long is read from the bounds on the device, so the
//     host never waits. synthetic-large's outer graph has at most 244 edges
//     a drug (mean 161), so none there is long.
//   - Measured by scripts/compare_kernel_trees.py (device time of calls
//     queued back to back; NVIDIA H100 80GB HBM3, 700 W), H 4, D 32:
//     backward f32 at 16,384 drugs (E 2.6M) 0.410 ms (the walk it replaced
//     2.27; torch.sparse.mm of the transposed CSR plus sampled_addmm
//     0.894), on a shard of config5-large's 8-shard plan (112,532 rows,
//     2.0M edges) 0.377 ms (1.80), bf16 on config4's sampled batch 0.029
//     ms (0.053). scripts/probe_variants.py (mhb) chose 4 rows a lane in
//     flight and 4 blocks an SM (at most 64 registers): 8 rows at 2 blocks
//     took 0.534 ms, 16 rows at 1 block 1.21, so warps in flight matter
//     more than rows a warp. That is ~3.2 TB/s of gathered g rows, from L2.
//     Forward, the same way: f32 at 16,384 drugs 0.218 ms (the walk it
//     replaced, lanes over columns with one row in flight a warp, 0.799;
//     torch.sparse.mm of the [N H, N H] CSR of alpha 0.593), on the
//     shard 0.185 (0.682), at 100K drugs (E 16.1M, v 51 MB) 1.32 (5.08;
//     4.88), bf16 on config4's batch 0.020 (0.023), bf16 at 100K 0.79
//     (2.57). scripts/probe_variants.py (mhf) kept the backward's choice:
//     2 rows in flight took 0.252 ms at 16,384 drugs, 8 rows at 2 or 3
//     blocks an SM 0.230 and 0.220, 4 warps a block 0.218, as 4 rows at 4
//     blocks and 8 warps; at 100K 1.33 (2 rows 1.46, 8 rows 1.58-1.62, 4
//     warps 1.39). ~6 TB/s of gathered v rows at 16,384 drugs, from L2.
// Per edge the backward does 2 F multiply-adds, the forward F.
//
// Wide rows (more than 8 heads, or F above 256) are swept in strips of at
// most 256 columns (rows of up to 8 heads and 256 columns keep the forms
// above, compiled without strips):
//   - head_dim <= 256: a strip holds whole heads (forward: min(8, 256 /
//     head_dim); backward: as many as fit 256 padded columns), so a 16-byte
//     word and a head's lane group stay inside it and d_alpha of its heads
//     is whole in the strip (H 32, D 24: 4 strips of 8 heads; H 4, D 256:
//     a head a strip).
//   - head_dim > 256: a head is cut into strips of 256 columns. d_alpha is
//     then a sum over the head's strips: each strip writes its partial dot
//     in float32 to the wrapper's scratch [strips of a head, E, H], and
//     mh_dot_finish adds them in strip order and rounds once (no atomics).
// The forward takes a strip a block (blockIdx.y, the kStrip forms), each
// re-reading the edge ids. The backward (mh_backward_strips, below) walks
// a source's strips in one warp, its ids loaded once, a head's words in a
// padded lane group. Measured at config4's sampled outer edges (E 59,008;
// NVIDIA H100 80GB HBM3, 700 W; scripts/compare_kernel_trees.py and
// scripts/probe_variants.py kind mhs, queued behind a sleep), the backward
// in bf16: H 4, D 256 0.125 ms (a strip a block with the per-head select:
// 0.142), H 32, D 24 0.111 (0.977: the select of 8 heads over 8-value
// words spilled); in float32 0.165 and 0.165 (0.437, 0.572; torch.sparse.mm
// and sampled_addmm 0.350 at H 4, D 256). 8 words a lane in flight took
// 0.17-0.33 ms, a strip's share of the grid 0.14-0.21: warps in flight
// matter more than loads a warp (as kRowsInFlight's choice found).

// The JAX package rounds each bf16 message alpha * v to bf16 before the
// segment sum (multihead.py:81-83); here products are summed in float32 and
// rounded once, as the plain version of the port does.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"

namespace {

constexpr int kMaxHeads = 8;
constexpr int kFwdWarps = 8;        // forward: destinations a block holds
constexpr int kFwdMinBlocks = 4;    // forward blocks an SM holds at least
constexpr int kFwdRows = 4;         // v rows a forward lane loads at once
constexpr int kBwdWarps = 8;        // backward: sources a block holds
constexpr int kBwdMinBlocks = 4;    // backward blocks an SM holds at least
constexpr int kRowsInFlight = 4;    // g rows a backward lane loads at once
// the backward's strips (mh_backward_strips): words a lane loads at once,
// and blocks an SM holds at least
constexpr int kStripRows = 4;
constexpr int kStripMinBlocks = 3;
constexpr int kLong = 256;  // positions above which a row is the block's
constexpr int kMaxVals = 8;  // values of a row a lane holds
constexpr int kMaxFeat = 32 * kMaxVals;  // columns a row (or strip) holds
constexpr unsigned kFull = 0xffffffffu;

// The lane layout of both directions (segment_sum.cu's row slots): a row of
// F values is `words` words of NV values (16 bytes where F, D and the
// pointers allow, else single values); the 32 lanes form 32 >> lg slots of
// G = 1 << lg lanes, G the words rounded up to a power of two (at most 32),
// and lane q G + c holds words c, c + G, ... (K of them) of slot q's rows.
// A 16-byte word lies inside one head (D a multiple of NV) in the forward;
// in the backward's grouped form a head's words are also a power-of-two
// group of lanes (head_dim / NV of them).
template <class T, int NV>
using WordOf = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;

struct FwdArgs {
  const void* v;
  const int* src;
  const int* dst;
  const void* alpha;
  const int* first;
  const int* last;
  int num_src, num_out, heads, head_dim, lg;
  void* out;
  int strip_heads;  // kStrip: whole heads a strip holds (head_dim <= 256)
  int head_strips;  // kStrip: strips of a head (head_dim > 256), else 0
};

// A forward block's strip of the row: columns col0 + [0, width), its
// first head h0, the strip's first column at hoff in head h0.
struct Strip {
  int col0, width, h0, hoff;
};

template <bool kStrip>
__device__ __forceinline__ Strip strip_of(const FwdArgs& a) {
  if constexpr (!kStrip) {
    return {0, a.heads * a.head_dim, 0, 0};
  } else {
    const int j = blockIdx.y;
    if (a.head_strips == 0) {
      const int h0 = j * a.strip_heads;
      const int nh = min(a.strip_heads, a.heads - h0);
      return {h0 * a.head_dim, nh * a.head_dim, h0, 0};
    }
    const int h = j / a.head_strips, p = j % a.head_strips;
    const int off = p * kMaxFeat;
    return {h * a.head_dim + off, min(kMaxFeat, a.head_dim - off), h, off};
  }
}

// The clipped source (JAX's take(..., mode="clip")) of the edge at position
// b + lane when it is destination d's, else -1 (past i1, or a hole). Its two
// ids load together.
__device__ __forceinline__ int chunk_src(const FwdArgs& a, int b, int i1,
                                         int d, int lane) {
  const int i = b + lane;
  if (i > i1) return -1;
  const int id = __ldg(a.dst + i);
  const int s = __ldg(a.src + i);
  return id == d ? min(max(s, 0), a.num_src - 1) : -1;
}

// acc += alpha[e, h(col)] * v[src_e] over destination d's positions b, b +
// 1, ... up to i1, taken in chunks of 32 every cstep positions: the chunk's
// ids one a lane (the next chunk's in flight while this chunk's rows load),
// then the rows of U edges a slot, all loaded before any is added. Slot q
// takes the chunk's positions q, q + slots, ... in order, so each slot sums
// its edges in edge order.
template <class T, int NV, int K, bool kStrip>
__device__ __forceinline__ void fwd_walk(const FwdArgs& a, const Strip& sp,
                                         int d, int b, int i1, int cstep,
                                         int lane, float (&acc)[K][NV]) {
  using W = WordOf<T, NV>;
  constexpr int U = K >= kFwdRows ? 1 : kFwdRows / K;
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ alpha = static_cast<const T*>(a.alpha);
  const int heads = a.heads;
  const int feat = heads * a.head_dim;
  const int lg = a.lg;
  const int slots = 32 >> lg;
  const int q = lane >> lg;
  const int c = lane & ((1 << lg) - 1);
  // the head of each word this lane holds (a word lies in one head); -1
  // past the row's strip
  int head[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = c + (k << lg);
    if constexpr (kStrip) {
      head[k] = w < sp.width / NV ? sp.h0 + (w * NV + sp.hoff) / a.head_dim
                                  : -1;
    } else {
      head[k] = w < feat / NV ? w * NV / a.head_dim : -1;
    }
  }
  int s_l = chunk_src(a, b, i1, d, lane);
  for (; b <= i1; b += cstep) {
    const int s_next = chunk_src(a, b + cstep, i1, d, lane);
    const int n = min(32, i1 - b + 1);
    for (int j0 = 0; j0 < n; j0 += slots * U) {
      W w[U][K];
      float al[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + q + slots * u;
        int src = __shfl_sync(kFull, s_l, j & 31);
        if (j >= 32) src = -1;
        const W* row = reinterpret_cast<const W*>(
            v + static_cast<int64_t>(src >= 0 ? src : 0) * feat +
            (kStrip ? sp.col0 : 0));
        const T* ar = alpha + static_cast<int64_t>(src >= 0 ? b + j : 0) *
                                  heads;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool in = src >= 0 && head[k] >= 0;
          w[u][k] = in ? __ldg(row + c + (k << lg)) : W{};
          al[u][k] = in ? bignn::load1(ar + head[k]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float x[NV];
          bignn::unpack_word<T, NV>(w[u][k], x);
#pragma unroll
          for (int i = 0; i < NV; ++i) acc[k][i] += al[u][k] * x[i];
        }
      }
    }
    s_l = s_next;
  }
}

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
  int strip_heads;  // as FwdArgs
  int head_strips;
  int64_t num_edges;
  float* dot_part;  // head_strips > 0: [head_strips, E, heads] partial dots
  int strips;       // mh_backward_strips: strips of a row
  int pw;           // mh_backward_strips: lanes (words) a head's group spans
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

// A block holds kFwdWarps destinations. Each destination of up to kLong
// positions is walked by its own warp; a longer one by all the block's
// warps, chunk w, w + kFwdWarps, ... to warp w, their rows added in shared
// memory in warp order. Whether a destination is long is read from its
// bounds on the device, never on the host. A destination without edges
// gets zeros.
template <class T, int NV, int K, bool kStrip>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks)
    mh_forward(__grid_constant__ const FwdArgs a) {
  using W = WordOf<T, NV>;
  __shared__ float part[kFwdWarps * kMaxFeat];
  const Strip sp = strip_of<kStrip>(a);
  T* __restrict__ out = static_cast<T*>(a.out) + (kStrip ? sp.col0 : 0);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int feat = a.heads * a.head_dim;
  const int width = kStrip ? sp.width : feat;  // the columns of the strip
  const int q = lane >> a.lg;
  const int c = lane & ((1 << a.lg) - 1);
  const int d0 = blockIdx.x * kFwdWarps;
  float acc[K][NV];
  const int d = d0 + warp;
  if (d < a.num_out && a.last[d] - a.first[d] < kLong) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[k][i] = 0.f;
    }
    fwd_walk<T, NV, K, kStrip>(a, sp, d, a.first[d], a.last[d], 32, lane,
                               acc);
    slot_sum(acc, a.lg);
    W* o = reinterpret_cast<W*>(out + static_cast<int64_t>(d) * feat);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = c + (k << a.lg);
      if (q == 0 && w < width / NV) o[w] = bignn::pack_word<T, NV, W>(acc[k]);
    }
  }
  for (int j = 0; j < kFwdWarps && d0 + j < a.num_out; ++j) {
    const int dj = d0 + j;
    const int i0 = a.first[dj];
    const int i1 = a.last[dj];
    if (i1 - i0 < kLong) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[k][i] = 0.f;
    }
    fwd_walk<T, NV, K, kStrip>(a, sp, dj, i0 + 32 * warp, i1,
                               32 * kFwdWarps, lane, acc);
    slot_sum(acc, a.lg);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = c + (k << a.lg);
      if (q == 0 && w < width / NV) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          part[warp * width + w * NV + i] = acc[k][i];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < width; col += blockDim.x) {
      float t = part[col];
      for (int w = 1; w < kFwdWarps; ++w) t += part[w * width + col];
      out[static_cast<int64_t>(dj) * feat + col] = bignn::from_f32<T>(t);
    }
    __syncthreads();
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
      if (q == 0 && w < feat / NV)
        out[w] = bignn::pack_word<T, NV, W>(acc[k]);
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

// ---------------------------------------------------------------------------
// The backward's strips (rows of more than 8 heads or 256 columns). A warp
// walks one source over every strip of its row in turn, so the source's
// bounds and the first chunk's edge and destination ids load once for all
// strips (a grid axis of strips walked them once a strip). In a strip, a
// head's hw words (or a wide head's strip of 256 columns) take a padded
// group of pw lanes: pw = hw rounded up to a power of two up to 32 words,
// else to a multiple of 32. Lane c of a slot of G lanes holds positions c,
// c + G, ... (K of them) of the strip's padded words; position v is word
// (v / pw) hw + v % pw of the strip, of head v / pw, where v % pw < hw
// (the padding lanes, e.g. 1 lane in 4 at H 32, D 24 in bf16, hold
// zeros). So every word lies in one head, each word loads one alpha value,
// and an edge's dot of a head is one butterfly of log2(pw) shuffles over
// its group (pw > G: the head's K / (pw / G) words summed in the lane
// first, then 5 shuffles): no per-value head table or select. d_alpha of
// a head that a strip holds whole is stored by its group's first lane; a
// wide head's strips write their partial dots to the scratch as before.
// Each lane has kStripRows words in flight (U = kStripRows / K edges).

// A source's strip j: columns col0 + ..., heads h0 + [0, nh), hw words a
// head (a wide head's strip: its words), p its index among its head's
// strips.
struct BStrip {
  int col0, h0, nh, hw, p;
};

template <int NV>
__device__ __forceinline__ BStrip bwd_strip(const BwdArgs& a, int j) {
  if (a.head_strips == 0) {
    const int h0 = j * a.strip_heads;
    return {h0 * a.head_dim, h0, min(a.strip_heads, a.heads - h0),
            a.head_dim / NV, 0};
  }
  const int h = j / a.head_strips, p = j % a.head_strips;
  const int off = p * kMaxFeat;
  return {h * a.head_dim + off, h, 1, min(kMaxFeat, a.head_dim - off) / NV,
          p};
}

// The word of the strip each of the lane's K positions holds (-1: padding
// or past the strip), and its head in the strip.
template <int K>
__device__ __forceinline__ void strip_lanes(const BwdArgs& a,
                                            const BStrip& sp, int c,
                                            int (&wk)[K], int (&hk)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = c + (k << a.lg);
    const int hl = v / a.pw;
    const int wi = v - hl * a.pw;
    hk[k] = hl;
    wk[k] = hl < sp.nh && wi < sp.hw ? hl * sp.hw + wi : -1;
  }
}

// acc += alpha[e, h] * g[dst_e] and d_alpha[e, h] over the strip's heads
// for the source s's positions b, b + 1, ... up to i1 in chunks of 32
// every cstep positions; e_l, d_l: the first chunk's edge and destination
// ids (one a lane, -1 past it), loaded by the caller.
template <class T, int NV, int K>
__device__ __forceinline__ void bwd_walk_strip(
    const BwdArgs& a, const BStrip& sp, const int (&wk)[K],
    const int (&hk)[K], int s, int b, int i1, int cstep, int lane, int e_l,
    int d_l, const float (&vs)[K][NV], float (&acc)[K][NV]) {
  using W = WordOf<T, NV>;
  constexpr int U = K >= kStripRows ? 1 : kStripRows / K;
  const T* __restrict__ g = static_cast<const T*>(a.g);
  const T* __restrict__ alpha = static_cast<const T*>(a.alpha);
  T* __restrict__ d_alpha = static_cast<T*>(a.d_alpha);
  const int heads = a.heads;
  const int feat = heads * a.head_dim;
  const int lg = a.lg;
  const int slots = 32 >> lg;
  const int q = lane >> lg;
  const int c = lane & ((1 << lg) - 1);
  const int pw = a.pw;
  const int span = min(pw, 1 << lg);    // lanes of a head's butterfly
  const int kpw = max(1, pw >> lg);     // positions of a head in a lane
  for (; b <= i1; b += cstep) {
    const int e_next = chunk_edge(a.perm, a.src_sorted, b + cstep, i1, s,
                                  lane);
    const int n = min(32, i1 - b + 1);
    for (int j0 = 0; j0 < n; j0 += slots * U) {
      int e[U];
      W w[U][K];
      float al[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + q + slots * u;
        e[u] = __shfl_sync(kFull, e_l, j & 31);
        const int d = __shfl_sync(kFull, d_l, j & 31);
        if (j >= 32) e[u] = -1;
        // padding edges (dst outside [0, num_out)) get d_alpha 0
        const bool live = e[u] >= 0 && d >= 0 && d < a.num_out;
        const W* row = reinterpret_cast<const W*>(
            g + static_cast<int64_t>(live ? d : 0) * feat + sp.col0);
        const T* ar =
            alpha + static_cast<int64_t>(live ? e[u] : 0) * heads + sp.h0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool in = live && wk[k] >= 0;
          w[u][k] = in ? __ldg(row + wk[k]) : W{};
          al[u][k] = in ? bignn::load1(ar + hk[k]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float gv[NV];
          bignn::unpack_word<T, NV>(w[u][k], gv);
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            acc[k][i] += al[u][k] * gv[i];
            t += gv[i] * vs[k][i];
          }
          if ((k + 1) % kpw == 0) {  // the lane's last position of a head
            for (int o = 1; o < span; o <<= 1)
              t += __shfl_xor_sync(kFull, t, o);
            const int h = pw > (1 << lg) ? k / kpw : hk[k];
            const bool first = pw > (1 << lg) ? c == 0 : (c & (pw - 1)) == 0;
            if (e[u] >= 0 && first && h < sp.nh) {
              if (a.dot_part != nullptr) {  // a strip of a wide head
                a.dot_part[(sp.p * a.num_edges + e[u]) * heads + sp.h0 + h] =
                    t;
              } else {
                d_alpha[static_cast<int64_t>(e[u]) * heads + sp.h0 + h] =
                    bignn::from_f32<T>(t);
              }
            }
            t = 0.f;
          }
        }
      }
    }
    e_l = e_next;
    d_l = e_l >= 0 ? __ldg(a.dst + e_l) : -1;
  }
}

// A lane's words of row r's strip at its positions (zeros at padding), as
// floats.
template <class T, int NV, int K>
__device__ __forceinline__ void strip_words(const T* __restrict__ rows,
                                            int64_t r, int feat,
                                            const BStrip& sp,
                                            const int (&wk)[K],
                                            float (&out)[K][NV]) {
  const WordOf<T, NV>* row =
      reinterpret_cast<const WordOf<T, NV>*>(rows + r * feat + sp.col0);
#pragma unroll
  for (int k = 0; k < K; ++k)
    bignn::unpack_word<T, NV>(wk[k] >= 0 ? __ldg(row + wk[k])
                                         : WordOf<T, NV>{},
                              out[k]);
}

// A block holds kBwdWarps sources; each walks its row's strips in turn (a
// source of more than kLong positions: all the block's warps, strip by
// strip, their d_v rows added in shared memory in warp order).
template <class T, int NV, int K>
__global__ void __launch_bounds__(kBwdWarps * 32, kStripMinBlocks)
    mh_backward_strips(__grid_constant__ const BwdArgs a) {
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
  const int s = s0 + warp;
  if (s < a.num_src && a.last[s] - a.first[s] < kLong) {
    const int i0 = a.first[s];
    const int i1 = a.last[s];
    const int e_l = chunk_edge(a.perm, a.src_sorted, i0, i1, s, lane);
    const int d_l = e_l >= 0 ? __ldg(a.dst + e_l) : -1;
    for (int j = 0; j < a.strips; ++j) {
      const BStrip sp = bwd_strip<NV>(a, j);
      int wk[K], hk[K];
      strip_lanes(a, sp, c, wk, hk);
      float vs[K][NV], acc[K][NV];
      strip_words<T, NV, K>(v, s, feat, sp, wk, vs);
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[k][i] = 0.f;
      }
      bwd_walk_strip<T, NV, K>(a, sp, wk, hk, s, i0, i1, 32, lane, e_l, d_l,
                               vs, acc);
      slot_sum(acc, a.lg);
      W* out = reinterpret_cast<W*>(d_v + static_cast<int64_t>(s) * feat +
                                    sp.col0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (q == 0 && wk[k] >= 0)
          out[wk[k]] = bignn::pack_word<T, NV, W>(acc[k]);
      }
    }
  }
  for (int jj = 0; jj < kBwdWarps && s0 + jj < a.num_src; ++jj) {
    const int sj = s0 + jj;
    const int i0 = a.first[sj];
    const int i1 = a.last[sj];
    if (i1 - i0 < kLong) continue;
    const int b = i0 + 32 * warp;
    const int e_l = chunk_edge(a.perm, a.src_sorted, b, i1, sj, lane);
    const int d_l = e_l >= 0 ? __ldg(a.dst + e_l) : -1;
    for (int j = 0; j < a.strips; ++j) {
      const BStrip sp = bwd_strip<NV>(a, j);
      const int width = sp.nh * sp.hw * NV;  // the strip's columns
      int wk[K], hk[K];
      strip_lanes(a, sp, c, wk, hk);
      float vs[K][NV], acc[K][NV];
      strip_words<T, NV, K>(v, sj, feat, sp, wk, vs);
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[k][i] = 0.f;
      }
      bwd_walk_strip<T, NV, K>(a, sp, wk, hk, sj, b, i1, 32 * kBwdWarps,
                               lane, e_l, d_l, vs, acc);
      slot_sum(acc, a.lg);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (q == 0 && wk[k] >= 0) {
#pragma unroll
          for (int i = 0; i < NV; ++i)
            part[warp * width + wk[k] * NV + i] = acc[k][i];
        }
      }
      __syncthreads();
      for (int col = threadIdx.x; col < width; col += blockDim.x) {
        float t = part[col];
        for (int w = 1; w < kBwdWarps; ++w) t += part[w * width + col];
        d_v[static_cast<int64_t>(sj) * feat + sp.col0 + col] =
            bignn::from_f32<T>(t);
      }
      __syncthreads();
    }
  }
}

// d_alpha[i] = the partial dots of element i (a wide head's strips) added
// in strip order, rounded once.
template <class T>
__global__ void mh_dot_finish(const float* __restrict__ dot_part, int strips,
                              int64_t size, T* __restrict__ d_alpha) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < size; i += step) {
    float t = dot_part[i];
    for (int p = 1; p < strips; ++p) t += dot_part[p * size + i];
    d_alpha[i] = bignn::from_f32<T>(t);
  }
}

bool bad_shape(int num_edges, int num_src, int num_out, int heads,
               int head_dim) {
  return num_edges < 0 || num_src < 1 || num_out < 0 || heads < 1 ||
         head_dim < 1 ||
         static_cast<int64_t>(heads) * head_dim > (int64_t{1} << 30);
}

// How a row of heads x head_dim is swept: strips (false: the whole row, up
// to 8 heads and 256 columns), the heads a strip holds (head_dim <= 256),
// the strips of a head (head_dim > 256, else 0), and the widest strip.
struct Sweep {
  bool strips;
  int strip_heads, head_strips, width;
};

Sweep sweep_of(int heads, int head_dim) {
  if (heads <= kMaxHeads && heads * head_dim <= kMaxFeat)
    return {false, heads, 0, heads * head_dim};
  if (head_dim <= kMaxFeat) {
    const int hs = std::min(kMaxHeads, kMaxFeat / head_dim);
    return {true, hs, 0, hs * head_dim};
  }
  const int per = bignn::cdiv(head_dim, kMaxFeat);
  return {true, 1, per, kMaxFeat};
}

// The backward's strips (mh_backward_strips) of words of nv values: a
// head's words padded to pw lanes, the heads a strip holds (head_dim <=
// 256, as many as fit 256 padded columns; a wider head: its strips of 256
// columns), the strips of a row, and the padded words of the widest strip.
struct StripLanes {
  int pw, strip_heads, strips, words;
};

StripLanes strip_lanes_of(int heads, int head_dim, int nv) {
  const int hw = std::min(head_dim, kMaxFeat) / nv;
  const int pw =
      hw <= 32 ? 1 << bignn::slot_log2(hw) : bignn::cdiv(hw, 32) * 32;
  if (head_dim > kMaxFeat) {
    return {pw, 1, heads * bignn::cdiv(head_dim, kMaxFeat), pw};
  }
  const int hs = std::min(heads, std::max(1, kMaxFeat / nv / pw));
  return {pw, hs, bignn::cdiv(heads, hs), hs * pw};
}

// The row slots of rows of `words` words: (lg, K), G = 1 << lg lanes a
// slot and K words a lane.
void slots_of(int words, int* lg, int* k) {
  *lg = bignn::slot_log2(words < 32 ? words : 32);
  *k = bignn::cdiv(words, 1 << *lg);
}

// The forward's strips of a row: gridDim.y.
int strip_count(const FwdArgs& a) {
  return a.head_strips > 0 ? a.heads * a.head_strips
                           : bignn::cdiv(a.heads, a.strip_heads);
}

template <class T, int NV, bool kStrip>
struct Forward {
  template <int K>
  static void launch(const FwdArgs& a, cudaStream_t st) {
    const dim3 grid(bignn::cdiv(a.num_out, kFwdWarps),
                    kStrip ? strip_count(a) : 1);
    mh_forward<T, NV, K, kStrip><<<grid, kFwdWarps * 32, 0, st>>>(a);
  }
};

template <class T, int NV, bool kGrouped>
struct Backward {
  template <int K>
  static void launch(const BwdArgs& a, cudaStream_t st) {
    const dim3 grid(bignn::cdiv(a.num_src, kBwdWarps));
    mh_backward<T, NV, K, kGrouped><<<grid, kBwdWarps * 32, 0, st>>>(a);
  }
};

template <class T, int NV>
struct BackwardStrips {
  template <int K>
  static void launch(const BwdArgs& a, cudaStream_t st) {
    const dim3 grid(bignn::cdiv(a.num_src, kBwdWarps));
    mh_backward_strips<T, NV, K><<<grid, kBwdWarps * 32, 0, st>>>(a);
  }
};

// L::launch<K> with K, the words a lane holds, rounded up to 1, 2, 4 or 8
// (K NV <= 8 values).
template <class L, int NV, class Args>
void launch_k(const Args& a, int k, cudaStream_t st) {
  if (k <= 1) {
    L::template launch<1>(a, st);
  } else if constexpr (kMaxVals / NV >= 2) {
    if (k <= 2) {
      L::template launch<2>(a, st);
    } else if constexpr (kMaxVals / NV >= 8) {
      if (k <= 4) {
        L::template launch<4>(a, st);
      } else {
        L::template launch<8>(a, st);
      }
    }
  }
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
    // 16-byte words where every row of v and out starts on 16 bytes and a
    // word lies inside one head (and so inside one strip)
    constexpr int kWide = 16 / static_cast<int>(sizeof(T));
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
    const bool wide = head_dim % kWide == 0 && addr % 16 == 0;
    const Sweep sw = sweep_of(heads, head_dim);
    int lg, k;
    slots_of(sw.width / (wide ? kWide : 1), &lg, &k);
    const FwdArgs a{v, static_cast<const int*>(src), d, alpha, f, l,
                    num_src, num_out, heads, head_dim, lg, out,
                    sw.strip_heads, sw.head_strips};
    if (sw.strips) {
      if (wide) {
        launch_k<Forward<T, kWide, true>, kWide>(a, k, st);
      } else {
        launch_k<Forward<T, 1, true>, 1>(a, k, st);
      }
    } else if (wide) {
      launch_k<Forward<T, kWide, false>, kWide>(a, k, st);
    } else {
      launch_k<Forward<T, 1, false>, 1>(a, k, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Floats of the backward's scratch: a wide head's strips' partial dots,
// [head_strips, num_edges, heads] (0 where a head fits one strip).
int64_t dot_part_floats(int num_edges, int heads, int head_dim) {
  return static_cast<int64_t>(sweep_of(heads, head_dim).head_strips) *
         num_edges * heads;
}

template <class T>
int backward(const void* v, const void* g, const void* dst, const void* alpha,
             const void* perm, const void* src_sorted, int num_edges,
             int num_src, int num_out, int heads, int head_dim, void* first,
             void* last, void* d_v, void* d_alpha, void* dot_part,
             long long dot_part_size, void* stream) {
  if (bad_shape(num_edges, num_src, num_out, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  const Sweep sw = sweep_of(heads, head_dim);
  const int64_t need = dot_part_floats(num_edges, heads, head_dim);
  if (need > 0 && (dot_part == nullptr || dot_part_size < need))
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
  // (in strips every strip starts on a head, or on a multiple of 256
  // columns of one, so a word that lies inside a head lies inside a strip)
  const bool wide = (sw.strips ? head_dim : feat) % kWide == 0 &&
                    addr % 16 == 0;
  const int nv = wide ? kWide : 1;
  float* parts = sw.head_strips > 0 ? static_cast<float*>(dot_part) : nullptr;
  BwdArgs a{v, g, static_cast<const int*>(dst), alpha,
            static_cast<const int*>(perm), ss, f, l, num_src, num_out,
            heads, head_dim, 0, d_v, parts != nullptr ? nullptr : d_alpha,
            sw.strip_heads, sw.head_strips, num_edges, parts, 1, 0};
  int k;
  if (sw.strips) {
    const StripLanes sl = strip_lanes_of(heads, head_dim, nv);
    a.strip_heads = sl.strip_heads;
    a.strips = sl.strips;
    a.pw = sl.pw;
    slots_of(sl.words, &a.lg, &k);
    if (wide) {
      launch_k<BackwardStrips<T, kWide>, kWide>(a, k, st);
    } else {
      launch_k<BackwardStrips<T, 1>, 1>(a, k, st);
    }
  } else {
    slots_of(sw.width / nv, &a.lg, &k);
    const int group = head_dim / nv;
    const bool grouped = wide && head_dim % nv == 0 && group <= 32 &&
                         (group & (group - 1)) == 0;
    if (grouped) {
      launch_k<Backward<T, kWide, true>, kWide>(a, k, st);
    } else if (wide) {
      launch_k<Backward<T, kWide, false>, kWide>(a, k, st);
    } else {
      launch_k<Backward<T, 1, false>, 1>(a, k, st);
    }
  }
  if (parts != nullptr) {
    const int64_t size = static_cast<int64_t>(num_edges) * heads;
    const int blocks =
        static_cast<int>(std::min<int64_t>(size / 256 + 1, 4096));
    mh_dot_finish<T><<<blocks, 256, 0, st>>>(parts, sw.head_strips, size,
                                             static_cast<T*>(d_alpha));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v [num_src, heads * head_dim], src/dst [num_edges] int32, alpha
// [num_edges, heads], out [num_out, heads * head_dim], v/alpha/out in one
// type (f32 or bf16); first/last are [num_out] int32 scratch. Any heads and
// head_dim (rows above 8 heads or 256 columns go in strips). Returns
// cudaGetLastError().
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

// The backward's scratch for num_edges edges of heads x head_dim: its
// float count, written to `floats` (int64).
int bignn_spmm_multihead_bwd_scratch(int num_edges, int heads, int head_dim,
                                     void* floats, void* stream) {
  (void)stream;
  *static_cast<int64_t*>(floats) =
      num_edges > 0 && heads > 0 && head_dim > 0
          ? dot_part_floats(num_edges, heads, head_dim)
          : 0;
  return static_cast<int>(cudaSuccess);
}

// g [num_out, heads * head_dim] (the cotangent of out), perm/src_sorted
// [num_edges] int32 (argsort of src, src[perm]), d_v like v, d_alpha like
// alpha, all floating tensors in one type; first/last are [num_src] int32
// scratch. An edge whose src lies outside [0, num_src) is in no source's
// range and leaves its d_alpha row unwritten (the wrapper zero-fills it).
// dot_part: float32 zeros of the size bignn_spmm_multihead_bwd_scratch
// gives (a wide head's strips' partial dots), dot_part_size its floats;
// null and 0 where that size is 0.
int bignn_spmm_multihead_bwd_f32(const void* v, const void* g,
                                 const void* dst, const void* alpha,
                                 const void* perm, const void* src_sorted,
                                 int num_edges, int num_src, int num_out,
                                 int heads, int head_dim, void* first,
                                 void* last, void* d_v, void* d_alpha,
                                 void* dot_part, long long dot_part_size,
                                 void* stream) {
  return backward<float>(v, g, dst, alpha, perm, src_sorted, num_edges,
                         num_src, num_out, heads, head_dim, first, last, d_v,
                         d_alpha, dot_part, dot_part_size, stream);
}

int bignn_spmm_multihead_bwd_bf16(const void* v, const void* g,
                                  const void* dst, const void* alpha,
                                  const void* perm, const void* src_sorted,
                                  int num_edges, int num_src, int num_out,
                                  int heads, int head_dim, void* first,
                                  void* last, void* d_v, void* d_alpha,
                                  void* dot_part, long long dot_part_size,
                                  void* stream) {
  return backward<__nv_bfloat16>(v, g, dst, alpha, perm, src_sorted,
                                 num_edges, num_src, num_out, heads, head_dim,
                                 first, last, d_v, d_alpha, dot_part,
                                 dot_part_size, stream);
}

}  // extern "C"
