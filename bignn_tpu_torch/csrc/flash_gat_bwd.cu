// Masked additive (GAT) attention over a dense multiplicity mask, backward
// from the forward's logsumexp (the flash VJP):
//   z[d, s, h]   = score_l[d, h] + score_r[s, h];  e = leaky_relu(z),
//                  masked to NEG where cnt[d, s] == 0
//   alpha        = cnt[d, s] * exp(min(e - lse[d, h], 0))
//   d_e          = alpha * (g[d, h, :] . v[s, h, :] - delta[d, h])
//   d_z          = z > 0 ? d_e : slope * d_e
//   dsl[d, h]    = sum_s d_z
//   dsr[s, h]    = sum_d d_z
//   dv[s, h, :]  = sum_d alpha * g[d, h, :]
// with delta[d, h] = g[d, h, :] . out[d, h, :] from the wrapper.
//
// Replaces bignn_tpu/ops/pallas/flash_gat.py:_bwd_kernel (_flash_bwd), with
// its NEG masking and min(e - lse, 0): a row with no edges has lse == NEG,
// and without them exp(e - NEG) overflows. No [N, N, H] tensor is written.
// On the TPU both products (G V^T and alpha^T G) are MXU matmuls.
//
// What bounds it on the H100: operations. Per (d, s, h) pair it does the
// D-wide dot g . v, the D-wide multiply-add into dv (here on the tensor
// cores in 3xTF32, three TF32 products each), and the score, exp and d_z
// in float32: at N 1,704, H 4, D 32 that is 3 x 1.49 GFLOP at TF32's 495
// TFLOP/s (0.0090 ms) plus 0.07 GFLOP at float32's 67 (0.0010), 0.0101 ms
// (chip_smoke.bound_ms, flash_bwd_flops); the inputs are 12 MB (cnt, read
// once a head, from L2 after the first).
//
// Design: one kernel over (source tile of kTile columns, head, part of the
// destination sweep) and a short reduction pass; no float atomics, every
// sum in a fixed order, so a result repeats bit for bit.
//   tiles: a block owns kTile sources of one head, stages their v rows in
//     shared memory once, and sweeps its part of the destinations in chunks
//     of kTile, g rows double-buffered by cp.async (16-byte copies where
//     head_dim and the pointers allow, else 4-byte ones). Both products of
//     a chunk, the 64 x 64 pair tile g v^T and dv += alpha^T g, are
//     mma.sync m16n8k8 tensor-core tiles in 3xTF32: each float32 operand x
//     is split into TF32 halves hi + lo, and a b = lo_a hi_b + hi_a lo_b +
//     hi_a hi_b keeps float32-level products (plain TF32 keeps ~3 digits),
//     each k-step's product added to the sum in float32 (mma_3xtf32).
//     v is split once a block, alpha as the epilogue writes it, g as its
//     fragments are loaded. The epilogue turns a lane's 16 dots into alpha
//     and d_z in registers (the mask from L2, loaded while the copies fly)
//     and writes alpha transposed, [s][d], for the second product.
//     dsl sums over a lane group's sources by shuffles, then the block's two
//     source halves in order, and goes to scratch, one partial a source
//     tile; dsr sums over the sweep in registers, then over lane groups and
//     the 4 destination quarters in order.
//   splits: the sweep is cut into `splits` parts (blockIdx.z) so that the
//     busiest SM has the fewest chunks (sweep_splits); each part writes its
//     own dsr and dv partials to scratch.
//   reduce: dsl = sum over source tiles, dsr and dv = sum over parts, in
//     index order.
// The wrapper allocates the scratch (bignn_flash_gat_bwd_scratch_f32 says
// how much).
//
// Wider heads (head_dim above 64) take flash_gat_bwd_wide: the same tiles,
// pairs, fragments and sums. What bounds it is the same count of products
// (8x D 32's at D 256: 0.0731 ms), but the narrow tiling does not fit: at
// D 256 v, g's two buffers and alpha^T take 218 KB, one block an SM. The
// first wide form ran 8 warps there, each with a 64-float dv sum, cut both
// operands into TF32 halves with cvt.rna at every fragment load (255
// registers, 64 bytes spilled; 2 warps a scheduler to hide the splits),
// and sweep_splits cut the sweep into 7 parts whose dv partials went through
// device memory and flash_gat_bwd_reduce (~105 MB a call). This form:
//   - 16 warps a block at D 256 (8 at 128; kWideDvCols): in g v^T a warp
//     owns 16 destinations and 16 sources (32 at 128), in alpha^T g 16
//     sources and 64 of the strip's features, so dv's sum is 32 floats a
//     lane and the launch bounds hold a lane to 128 registers at D 256, 4
//     warps a scheduler;
//   - the halves are cut by bit masks (split_tf32_trunc, as the forward):
//     three integer or float operations, no conversion;
//   - the sweep is cut into at most kWideMaxSplits parts: N 1,704, H 4,
//     D 256 runs one (108 blocks, every chunk of a tile in one block), so
//     dv goes straight to its output and the reduction adds dsl alone;
//     H 8, D 128 runs 3 (648 blocks) through the scratch as before.
//   v is not split once a block: its halves would take 133 KB beside g's
//   133 KB. The mask stays 8 loads from L2 a lane a chunk, issued before
//   the chunk's copies are waited on: a staged mask tile (17 KB) does not
//   fit beside them either.
//   Above 256 features a head is cut into strips of 256 (blockIdx.z
//   holds the strip beside the part of the sweep). The dot g . v needs
//   every feature, so each chunk stages the strips of its g rows and of
//   the tile's v rows in turn and adds their k-steps into the same
//   accumulators, strip 0 first: the dot is whole, summed over the
//   features in order, before alpha and d_z use it. Then the block
//   stages its own strip of g for dv += alpha^T g. The first strip's
//   blocks write dsl and dsr; the others compute the same values and
//   write only their strip of dv. No float atomics here either.
//   Measured (NVIDIA H100 80GB HBM3, 700.00 W; device ms queued behind a
//   sleep, scripts/probe_variants.py fgb): N 1,704, H 4, D 256 0.3603 (the
//   first wide form 0.5335), 4.9x its bound; H 8, D 128 0.3566 (0.5322).
//   128 registers at D 256, 255 at 128, 20-28 bytes spilled. Taken out one
//   at a time at D 256 (scripts/probe_flash_phases.py): g v^T 0.124 ms,
//   alpha^T g 0.058, the two smaller products of 3xTF32 0.129, the mask's
//   loads 0.023, the exp 0.009; so it is issue-bound as the forward
//   (3xTF32's products alone: 0.111 ms at mma.sync's 322 TFLOP/s,
//   scripts/probe_mma_rate.py). Variants: 32 dv features a warp 0.50 at D
//   256, 8 warps there 0.365, one part 0.386 at D 128, up to 16 parts
//   0.380 at D 256; the three products' adds split in two chains 0.443.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; device ms of a call from
// scripts/compare_kernel_trees.py): N 1,704, H 4, D 32 (config2) 0.091 (the
// port's first pair of kernels, which read both operands of every FMA from
// shared memory and computed g . v twice, 0.405): 9.0x the bound; the tiles
// 0.076-0.077, the reduction 0.005, and the epilogue (exp, mask loads from
// L2) costs about as much as both products. scripts/probe_variants.py (kind
// fgb): 1 block an SM 0.119, the sweep uncut 0.125. The same tiles with FFMA
// register micro-tiles (16 x 16 threads, 4 x 4 pairs each, every float4 read
// from shared memory feeding four FMAs) took 0.105 (4.5x their own bound at
// float32's rate), and so did float32 FMAs for g . v with alpha^T g on
// tensor cores; chaining the k-steps through the tensor cores' accumulator
// took 0.088 but failed chip_smoke.py's step check (below). Plain TF32, one
// hi x hi product a k-step, fails chip_smoke.py's kernel check at 8.6e-4 of
// the scale and config2's step check on a_l at 5.4e-2 (limits 1e-4).

#include <cuda_runtime.h>

#include <cstdint>

#include "elem.cuh"
#include "tf32_mma.cuh"

namespace {

using bignn::cp_async16;
using bignn::cp_async4;
using bignn::cp_async_commit;
using bignn::cp_async_wait;
using bignn::mma_3xtf32;
using bignn::split_tf32;
using bignn::split_tf32_trunc;

constexpr int kTile = 64;      // sources a block owns; destinations a chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxHeadDim = 64;  // flash_gat_bwd_tiles; wider: _wide
constexpr int kMaxStrip = 256;   // features of a head a wide block owns
constexpr int kBlocksPerSm = 2;  // blocks an SM holds (launch bounds)
constexpr int kMaxSplits = 16;   // parts of the sweep, at most (scratch)
constexpr int kWideDvCols = 64;      // features of dv a wide warp owns
constexpr int kWideMaxSplits = 4;    // parts of a wide sweep, at most
constexpr int kWideMinBlocks = 1;    // wide blocks an SM holds
constexpr int kAlphaRow = kTile + 4;  // floats a row of alpha^T
constexpr float kNeg = -1e30f;

struct Inputs {
  const float* score_l;  // [n, heads]
  const float* score_r;  // [n, heads]
  const float* v;        // [n, heads, head_dim]
  const float* cnt;      // [n, n], cnt[d, s]
  const float* lse;      // [n, heads]
  const float* delta;    // [n, heads]
  const float* g;        // [n, heads, head_dim]
  int n, heads, head_dim;
  float slope;
};

// rows [r0, r0 + kTile) of x[:, h, :] into tile (zero past n and head_dim),
// by cp.async: 16 bytes a copy where vec, else 4
// (features c0 + [0, kDP) of the head: a strip of a wide head), by the
// block's kThr threads
template <int kDP, int kThr = kThreads>
__device__ __forceinline__ void stage(float (*tile)[kDP + 4],
                                      const float* __restrict__ x, int r0,
                                      const Inputs& in, int h, bool vec,
                                      int c0 = 0) {
  const int64_t cols = static_cast<int64_t>(in.heads) * in.head_dim;
  const float* xh = x + h * in.head_dim + c0;
  const int width = in.head_dim - c0;
  if (vec) {
    constexpr int kQuads = kDP / 4;
    for (int i = threadIdx.x; i < kTile * kQuads; i += kThr) {
      const int r = i / kQuads, c = 4 * (i % kQuads);
      const bool ok = r0 + r < in.n && c < width;
      cp_async16(&tile[r][c], ok ? xh + (r0 + r) * cols + c : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kDP; i += kThr) {
      const int r = i / kDP, c = i % kDP;
      const bool ok = r0 + r < in.n && c < width;
      cp_async4(&tile[r][c], ok ? xh + (r0 + r) * cols + c : x, ok);
    }
  }
}

// kDP: head_dim rounded up to 32 or 64 (flash_gat_bwd_tiles; WideSmem: 128
// or 256); staged rows are zero past head_dim.
template <int kDP>
struct Smem {
  static constexpr int kRow = kDP + 4;  // floats a staged row
  float v_hi[kTile][kRow];              // the block's sources, split once
  float v_lo[kTile][kRow];
  float g[2][kTile][kRow];              // a chunk's destinations, 2 buffers
  float alpha_hi[kTile][kAlphaRow];     // the chunk's alpha, [s][d], split
  float alpha_lo[kTile][kAlphaRow];
  float dsl_red[2][kTile];              // dsl of the two source halves
};

// One (source tile, head, part of the sweep): dsl partials of the tile to
// dsl_part[tile], dsr and dv of the part to dsr_out[part], dv_out[part].
// 8 warps. In g v^T warp w owns destinations 16 (w % 4) + [0, 16) and
// sources 32 (w / 4) + [0, 32), four m16n8 tiles; in alpha^T g sources
// 16 (w % 4) + [0, 16) and features (w / 4) kDP / 2 + [0, kDP / 2). A lane
// holds the pairs of its fragments: destinations gid and gid + 8, sources
// 8 t + 2 tig + {0, 1} of tile t.
template <int kDP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    flash_gat_bwd_tiles(Inputs in, bool vec, int splits,
                        float* __restrict__ dsl_part,
                        float* __restrict__ dsr_out,
                        float* __restrict__ dv_out) {
  static_assert(kThreads == 256 && kTile == 64, "8 warps, 64 x 64 pairs");
  constexpr int kFeatTiles = kDP / 16;  // n8 tiles of dv a warp owns
  extern __shared__ uint4 smem_raw[];
  Smem<kDP>& sm = *reinterpret_cast<Smem<kDP>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int tile = blockIdx.x, h = blockIdx.y, part = blockIdx.z;
  const int n = in.n, heads = in.heads;
  const int s0 = tile * kTile;
  const int chunks = (n + kTile - 1) / kTile;
  const int c_begin = static_cast<int64_t>(part) * chunks / splits;
  const int c_end = static_cast<int64_t>(part + 1) * chunks / splits;
  const int dr = 16 * (warp % 4), sc = 32 * (warp / 4);  // g v^T
  const int ms = 16 * (warp % 4), fn = (warp / 4) * (kDP / 2);  // alpha^T g

  stage<kDP>(sm.v_hi, in.v, s0, in, h, vec);
  stage<kDP>(sm.g[0], in.g, c_begin * kTile, in, h, vec);
  cp_async_commit();

  // the lane's sources: j = 2 t + b is source sc + 8 t + 2 tig + b
  float sr[8], dsr_acc[8], dv_acc[kFeatTiles][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = s0 + sc + 8 * (j / 2) + 2 * tig + j % 2;
    sr[j] = s < n ? in.score_r[s * heads + h] : 0.f;
    dsr_acc[j] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < kFeatTiles; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) dv_acc[t][r] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const int d0 = c * kTile;
    if (c + 1 < c_end) {
      stage<kDP>(sm.g[buf ^ 1], in.g, d0 + kTile, in, h, vec);
    }
    cp_async_commit();
    // the lane's destinations i (dr + gid + 8 i) and their mask, from L2
    // while the copies fly
    float sl[2], lse[2], delta[2], cnt[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = d0 + dr + gid + 8 * i;
      const bool ok = d < n;
      sl[i] = ok ? in.score_l[d * heads + h] : 0.f;
      lse[i] = ok ? in.lse[d * heads + h] : kNeg;
      delta[i] = ok ? in.delta[d * heads + h] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = s0 + sc + 8 * (j / 2) + 2 * tig + j % 2;
        cnt[i][j] = ok && s < n
            ? __ldg(in.cnt + static_cast<int64_t>(d) * n + s) : 0.f;
      }
    }
    cp_async_wait<1>();  // this chunk's g rows (and the tile's v) are in
    __syncthreads();
    if (c == c_begin) {  // split v once: hi in place, lo beside it
      for (int i = tid; i < kTile * kDP; i += kThreads) {
        const int r = i / kDP, k = i % kDP;
        uint32_t hi, lo;
        split_tf32(sm.v_hi[r][k], hi, lo);
        sm.v_hi[r][k] = __uint_as_float(hi);
        sm.v_lo[r][k] = __uint_as_float(lo);
      }
      __syncthreads();
    }

    // d_alpha = g v^T: four m16n8 tiles, k over the head's features
    float (*gs)[Smem<kDP>::kRow] = sm.g[buf];
    float dot[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) dot[t][r] = 0.f;
#pragma unroll
    for (int k = 0; k < kDP; k += 8) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(gs[dr + gid][k + tig], a_hi[0], a_lo[0]);
      split_tf32(gs[dr + gid + 8][k + tig], a_hi[1], a_lo[1]);
      split_tf32(gs[dr + gid][k + tig + 4], a_hi[2], a_lo[2]);
      split_tf32(gs[dr + gid + 8][k + tig + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int s = sc + 8 * t + gid;
        const uint32_t b_hi[2] = {__float_as_uint(sm.v_hi[s][k + tig]),
                                  __float_as_uint(sm.v_hi[s][k + tig + 4])};
        const uint32_t b_lo[2] = {__float_as_uint(sm.v_lo[s][k + tig]),
                                  __float_as_uint(sm.v_lo[s][k + tig + 4])};
        mma_3xtf32(dot[t], a_hi, a_lo, b_hi, b_lo);
      }
    }

    // alpha and d_z of the lane's 16 pairs, as _bwd_kernel computes them;
    // dsr sums the lane's two destinations in order, then over the chunks
    float row[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r / 2, j = 2 * t + r % 2;
        const float z = sl[i] + sr[j];
        const float e = cnt[i][j] > 0.f ? (z > 0.f ? z : in.slope * z) : kNeg;
        const float a = cnt[i][j] * expf(fminf(e - lse[i], 0.f));
        const float de = a * (dot[t][r] - delta[i]);
        const float dz = z > 0.f ? de : in.slope * de;
        uint32_t hi, lo;
        split_tf32(a, hi, lo);
        const int s = sc + 8 * t + 2 * tig + r % 2, d = dr + gid + 8 * i;
        sm.alpha_hi[s][d] = __uint_as_float(hi);
        sm.alpha_lo[s][d] = __uint_as_float(lo);
        row[i] += dz;
        dsr_acc[j] += dz;
      }
    // dsl: over the warp's 32 sources (a lane group), then the two halves
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = row[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (tig == 0) sm.dsl_red[warp / 4][dr + gid + 8 * i] = x;
    }
    __syncthreads();  // alpha^T and the dsl halves are complete
    if (tid < kTile && d0 + tid < n) {
      dsl_part[(static_cast<int64_t>(tile) * n + d0 + tid) * heads + h] =
          sm.dsl_red[0][tid] + sm.dsl_red[1][tid];
    }

    // dv += alpha^T g: kFeatTiles m16n8 tiles, k over the chunk's
    // destinations
#pragma unroll 2
    for (int k = 0; k < kTile; k += 8) {
      const uint32_t a_hi[4] = {
          __float_as_uint(sm.alpha_hi[ms + gid][k + tig]),
          __float_as_uint(sm.alpha_hi[ms + gid + 8][k + tig]),
          __float_as_uint(sm.alpha_hi[ms + gid][k + tig + 4]),
          __float_as_uint(sm.alpha_hi[ms + gid + 8][k + tig + 4])};
      const uint32_t a_lo[4] = {
          __float_as_uint(sm.alpha_lo[ms + gid][k + tig]),
          __float_as_uint(sm.alpha_lo[ms + gid + 8][k + tig]),
          __float_as_uint(sm.alpha_lo[ms + gid][k + tig + 4]),
          __float_as_uint(sm.alpha_lo[ms + gid + 8][k + tig + 4])};
#pragma unroll
      for (int t = 0; t < kFeatTiles; ++t) {
        const int f = fn + 8 * t + gid;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(gs[k + tig][f], b_hi[0], b_lo[0]);
        split_tf32(gs[k + tig + 4][f], b_hi[1], b_lo[1]);
        mma_3xtf32(dv_acc[t], a_hi, a_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // the buffer and alpha^T are free for the next chunk
  }
  cp_async_wait<0>();

  // dsr: over the lane groups of a warp, then the 4 destination quarters
  // in order
  float* red = &sm.alpha_hi[0][0];  // [4][kTile]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float x = dsr_acc[j];
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    x += __shfl_xor_sync(0xffffffffu, x, 8);
    x += __shfl_xor_sync(0xffffffffu, x, 16);
    if (gid == 0)
      red[(warp % 4) * kTile + sc + 8 * (j / 2) + 2 * tig + j % 2] = x;
  }
  __syncthreads();
  const int64_t nh = static_cast<int64_t>(n) * heads;
  if (tid < kTile && s0 + tid < n) {
    float sum = 0.f;
    for (int q = 0; q < 4; ++q) sum += red[q * kTile + tid];
    dsr_out[part * nh + (s0 + tid) * heads + h] = sum;
  }
  float* dv_p = dv_out + part * nh * in.head_dim;
#pragma unroll
  for (int t = 0; t < kFeatTiles; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = s0 + ms + gid + 8 * (r / 2);
      const int f = fn + 8 * t + 2 * tig + r % 2;
      if (s < n && f < in.head_dim)
        dv_p[(static_cast<int64_t>(s) * heads + h) * in.head_dim + f] =
            dv_acc[t][r];
    }
}

// The wide form (head_dim above 64). A block owns kTile sources of one head
// (a strip of kDP features of them above 256) and 4 kGroups warps, kGroups
// = kDP / kWideDvCols (8 warps at kDP 128, 16 at 256): in g v^T warp w owns
// destinations 16 (w % 4) + [0, 16) and kSrc sources kSrc (w / 4) + [0,
// kSrc); in alpha^T g sources 16 (w % 4) + [0, 16) and kWideDvCols features
// kWideDvCols (w / 4) + [0, kWideDvCols). v and alpha^T are staged as they
// are (split once they would not fit beside g's two buffers) and cut into
// TF32 halves by bit masks as their fragments load.
template <int kDP>
struct WideSmem {
  static constexpr int kRow = kDP + 4;
  static constexpr int kGroups = kDP / kWideDvCols;  // source or feature
                                                     // groups of warps
  static constexpr int kThreads = 4 * kGroups * 32;
  static constexpr int kSrc = kTile / kGroups;    // sources a warp in g v^T
  static constexpr int kSrcTiles = kSrc / 8;
  static constexpr int kFeat = kWideDvCols;       // features a warp in dv
  static constexpr int kFeatTiles = kFeat / 8;
  static_assert(kDP % kWideDvCols == 0 && kTile % (8 * kGroups) == 0 &&
                    kWideDvCols % 8 == 0,
                "the wide form's warps tile its pairs and features");
  float v[kTile][kRow];             // the block's sources (a strip of them)
  float g[2][kTile][kRow];          // a chunk's destinations, 2 buffers
  float alpha[kTile][kAlphaRow];    // the chunk's alpha, [s][d]
  float dsl_red[kGroups][kTile];    // dsl of the source groups
};

// dot += g v^T over kDP features (the warp's kSrcTiles m16n8 tiles), both
// operands split as they load.
template <int kDP, int kSrcTiles>
__device__ __forceinline__ void wide_dot(const float (*gs)[kDP + 4],
                                         const float (*vs)[kDP + 4], int dr,
                                         int sc, int gid, int tig,
                                         float (&dot)[kSrcTiles][4]) {
#pragma unroll 8
  for (int k = 0; k < kDP; k += 8) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32_trunc(gs[dr + gid][k + tig], a_hi[0], a_lo[0]);
    split_tf32_trunc(gs[dr + gid + 8][k + tig], a_hi[1], a_lo[1]);
    split_tf32_trunc(gs[dr + gid][k + tig + 4], a_hi[2], a_lo[2]);
    split_tf32_trunc(gs[dr + gid + 8][k + tig + 4], a_hi[3], a_lo[3]);
#pragma unroll
    for (int t = 0; t < kSrcTiles; ++t) {
      const int s = sc + 8 * t + gid;
      uint32_t b_hi[2], b_lo[2];
      split_tf32_trunc(vs[s][k + tig], b_hi[0], b_lo[0]);
      split_tf32_trunc(vs[s][k + tig + 4], b_hi[1], b_lo[1]);
      mma_3xtf32(dot[t], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// flash_gat_bwd_tiles for head_dim above 64: kDP 128 or 256 (strips of
// 256 above that); blockIdx.z = strip * splits + part. The same pairs and
// sums; dv of the block's strip of features. A lane holds destinations
// gid and gid + 8 and sources 8 t + 2 tig + {0, 1} of tile t of its
// g v^T tiles.
template <int kDP>
__global__ void __launch_bounds__(WideSmem<kDP>::kThreads, kWideMinBlocks)
    flash_gat_bwd_wide(Inputs in, bool vec, int splits, int strips,
                       float* __restrict__ dsl_part,
                       float* __restrict__ dsr_out,
                       float* __restrict__ dv_out) {
  using S = WideSmem<kDP>;
  constexpr int kThr = S::kThreads;
  constexpr int kSrcTiles = S::kSrcTiles, kFeatTiles = S::kFeatTiles;
  constexpr int kJ = 2 * kSrcTiles;  // a lane's sources in g v^T
  extern __shared__ uint4 smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int tile = blockIdx.x, h = blockIdx.y;
  const int part = blockIdx.z % splits, strip = blockIdx.z / splits;
  const int n = in.n, heads = in.heads;
  const int s0 = tile * kTile, c_own = strip * kDP;
  const bool whole = strips == 1;  // the head in one strip: g prefetched
  const int chunks = (n + kTile - 1) / kTile;
  const int c_begin = static_cast<int64_t>(part) * chunks / splits;
  const int c_end = static_cast<int64_t>(part + 1) * chunks / splits;
  const int dr = 16 * (warp % 4), sc = S::kSrc * (warp / 4);  // g v^T
  const int ms = 16 * (warp % 4), fn = S::kFeat * (warp / 4);  // alpha^T g

  if (whole) {
    stage<kDP, kThr>(sm.v, in.v, s0, in, h, vec);
    stage<kDP, kThr>(sm.g[0], in.g, c_begin * kTile, in, h, vec);
  }
  cp_async_commit();

  float sr[kJ], dsr_acc[kJ], dv_acc[kFeatTiles][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int s = s0 + sc + 8 * (j / 2) + 2 * tig + j % 2;
    sr[j] = s < n ? in.score_r[s * heads + h] : 0.f;
    dsr_acc[j] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < kFeatTiles; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) dv_acc[t][r] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int buf = whole ? (c - c_begin) & 1 : 0;
    const int d0 = c * kTile;
    if (whole && c + 1 < c_end) {
      stage<kDP, kThr>(sm.g[buf ^ 1], in.g, d0 + kTile, in, h, vec);
    }
    cp_async_commit();
    // the lane's destinations i (dr + gid + 8 i) and their mask, from L2
    // while the copies fly
    float sl[2], lse[2], delta[2], cnt[2][kJ];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = d0 + dr + gid + 8 * i;
      const bool ok = d < n;
      sl[i] = ok ? in.score_l[d * heads + h] : 0.f;
      lse[i] = ok ? in.lse[d * heads + h] : kNeg;
      delta[i] = ok ? in.delta[d * heads + h] : 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int s = s0 + sc + 8 * (j / 2) + 2 * tig + j % 2;
        cnt[i][j] = ok && s < n
            ? __ldg(in.cnt + static_cast<int64_t>(d) * n + s) : 0.f;
      }
    }
    float dot[kSrcTiles][4];
#pragma unroll
    for (int t = 0; t < kSrcTiles; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) dot[t][r] = 0.f;
    if (whole) {
      cp_async_wait<1>();  // this chunk's g rows (and the tile's v) are in
      __syncthreads();
      wide_dot<kDP>(sm.g[buf], sm.v, dr, sc, gid, tig, dot);
    } else {
      // the dot over every strip in order, then this block's strip of g
      for (int q = 0; q < strips; ++q) {
        stage<kDP, kThr>(sm.v, in.v, s0, in, h, vec, q * kDP);
        stage<kDP, kThr>(sm.g[0], in.g, d0, in, h, vec, q * kDP);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        wide_dot<kDP>(sm.g[0], sm.v, dr, sc, gid, tig, dot);
        __syncthreads();  // g[0] and v are free
      }
      stage<kDP, kThr>(sm.g[0], in.g, d0, in, h, vec, c_own);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }

    float row[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kSrcTiles; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r / 2, j = 2 * t + r % 2;
        const float z = sl[i] + sr[j];
        const float e = cnt[i][j] > 0.f ? (z > 0.f ? z : in.slope * z) : kNeg;
        const float a = cnt[i][j] * expf(fminf(e - lse[i], 0.f));
        const float de = a * (dot[t][r] - delta[i]);
        const float dz = z > 0.f ? de : in.slope * de;
        sm.alpha[sc + 8 * t + 2 * tig + r % 2][dr + gid + 8 * i] = a;
        row[i] += dz;
        dsr_acc[j] += dz;
      }
    // dsl: over the warp's sources (a lane group), then the source groups
    // in order
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = row[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (tig == 0) sm.dsl_red[warp / 4][dr + gid + 8 * i] = x;
    }
    __syncthreads();  // alpha^T and the dsl groups are complete
    if (strip == 0 && tid < kTile && d0 + tid < n) {
      float x = sm.dsl_red[0][tid];
#pragma unroll
      for (int q = 1; q < S::kGroups; ++q) x += sm.dsl_red[q][tid];
      dsl_part[(static_cast<int64_t>(tile) * n + d0 + tid) * heads + h] = x;
    }

    // dv += alpha^T g over the block's strip of features
    const float (*gs)[S::kRow] = sm.g[buf];
#pragma unroll 1
    for (int k = 0; k < kTile; k += 8) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32_trunc(sm.alpha[ms + gid][k + tig], a_hi[0], a_lo[0]);
      split_tf32_trunc(sm.alpha[ms + gid + 8][k + tig], a_hi[1], a_lo[1]);
      split_tf32_trunc(sm.alpha[ms + gid][k + tig + 4], a_hi[2], a_lo[2]);
      split_tf32_trunc(sm.alpha[ms + gid + 8][k + tig + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int t = 0; t < kFeatTiles; ++t) {
        const int f = fn + 8 * t + gid;
        uint32_t b_hi[2], b_lo[2];
        split_tf32_trunc(gs[k + tig][f], b_hi[0], b_lo[0]);
        split_tf32_trunc(gs[k + tig + 4][f], b_hi[1], b_lo[1]);
        mma_3xtf32(dv_acc[t], a_hi, a_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // the buffer and alpha^T are free for the next chunk
  }
  cp_async_wait<0>();

  // dsr: over the lane groups of a warp, then the 4 destination quarters
  // in order
  float* red = &sm.alpha[0][0];  // [4][kTile]
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    float x = dsr_acc[j];
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    x += __shfl_xor_sync(0xffffffffu, x, 8);
    x += __shfl_xor_sync(0xffffffffu, x, 16);
    if (gid == 0)
      red[(warp % 4) * kTile + sc + 8 * (j / 2) + 2 * tig + j % 2] = x;
  }
  __syncthreads();
  const int64_t nh = static_cast<int64_t>(n) * heads;
  if (strip == 0 && tid < kTile && s0 + tid < n) {
    float sum = 0.f;
    for (int q = 0; q < 4; ++q) sum += red[q * kTile + tid];
    dsr_out[part * nh + (s0 + tid) * heads + h] = sum;
  }
  float* dv_p = dv_out + part * nh * in.head_dim;
#pragma unroll
  for (int t = 0; t < kFeatTiles; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = s0 + ms + gid + 8 * (r / 2);
      const int f = c_own + fn + 8 * t + 2 * tig + r % 2;
      if (s < n && f < in.head_dim)
        dv_p[(static_cast<int64_t>(s) * heads + h) * in.head_dim + f] =
            dv_acc[t][r];
    }
}

// dsl = sum of the source tiles' partials; with splits > 1, dsr and dv =
// sum of the parts' partials; each in index order.
__global__ void flash_gat_bwd_reduce(
    const float* __restrict__ dsl_part, int tiles,
    const float* __restrict__ dsr_part, const float* __restrict__ dv_part,
    int splits, int64_t nh, int64_t nhd, float* __restrict__ dsl,
    float* __restrict__ dsr, float* __restrict__ dv) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  for (int64_t i = first; i < nh; i += step) {
    float a = 0.f;
    for (int t = 0; t < tiles; ++t) a += dsl_part[t * nh + i];
    dsl[i] = a;
    if (splits > 1) {
      float b = 0.f;
      for (int k = 0; k < splits; ++k) b += dsr_part[k * nh + i];
      dsr[i] = b;
    }
  }
  if (splits > 1) {
    for (int64_t i = first; i < nhd; i += step) {
      float a = 0.f;
      for (int k = 0; k < splits; ++k) a += dv_part[k * nhd + i];
      dv[i] = a;
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Strips of a head of head_dim features: 1 up to 256, else strips of 256.
int strips_of(int head_dim) {
  return head_dim <= kMaxStrip ? 1 : cdiv(head_dim, kMaxStrip);
}

// Parts of the destination sweep: the count, up to kMaxSplits and one
// chunk a part, whose busiest SM has the fewest chunks to do, blocks dealt
// out in turn (ties: fewer parts, less scratch), up to max_splits parts.
// N 1,704, H 4 on 132 SMs: 108 tiles x 27 chunks; 7 parts give 6 blocks
// of 4 chunks on the busiest SM (24 chunks; 22.1 on average), 1 part 27.
// `heads` counts a wide head's strips.
int sweep_splits(int n, int heads, int max_splits) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int chunks = cdiv(n, kTile);
  const int64_t base = static_cast<int64_t>(chunks) * heads;
  int best = 1;
  int64_t best_load = INT64_MAX;
  for (int k = 1; k <= max_splits && k <= chunks; ++k) {
    const int64_t load = (base * k + sms - 1) / sms * cdiv(chunks, k);
    if (load < best_load) {
      best = k;
      best_load = load;
    }
  }
  return best;
}

// The parts of the sweep at this shape: the wide form's, with no more than
// kWideMaxSplits, so that its dv partials stay off device memory where
// they do not pay (N 1,704, H 4, D 256: one part).
int splits_of(int n, int heads, int head_dim) {
  return sweep_splits(n, heads * strips_of(head_dim),
                      head_dim <= kMaxHeadDim ? kMaxSplits : kWideMaxSplits);
}

int64_t scratch_floats(int n, int heads, int head_dim, int splits) {
  const int64_t nh = static_cast<int64_t>(n) * heads;
  return cdiv(n, kTile) * nh + (splits > 1 ? splits * nh * (head_dim + 1) : 0);
}

template <int kDP>
cudaError_t launch_tiles(const Inputs& in, bool vec, int splits,
                         float* dsl_part, float* dsr_out, float* dv_out,
                         cudaStream_t st) {
  constexpr int kBytes = sizeof(Smem<kDP>);
  static int done[bignn::kMaxDevices] = {};
  const cudaError_t set =
      bignn::allow_smem(flash_gat_bwd_tiles<kDP>, kBytes, done);
  if (set != cudaSuccess) return set;
  const dim3 grid(cdiv(in.n, kTile), in.heads, splits);
  flash_gat_bwd_tiles<kDP><<<grid, kThreads, kBytes, st>>>(
      in, vec, splits, dsl_part, dsr_out, dv_out);
  return cudaGetLastError();
}

template <int kDP>
cudaError_t launch_wide(const Inputs& in, bool vec, int splits, int strips,
                        float* dsl_part, float* dsr_out, float* dv_out,
                        cudaStream_t st) {
  constexpr int kBytes = sizeof(WideSmem<kDP>);
  static int done[bignn::kMaxDevices] = {};
  const cudaError_t set =
      bignn::allow_smem(flash_gat_bwd_wide<kDP>, kBytes, done);
  if (set != cudaSuccess) return set;
  const dim3 grid(cdiv(in.n, kTile), in.heads, splits * strips);
  flash_gat_bwd_wide<kDP><<<grid, WideSmem<kDP>::kThreads, kBytes, st>>>(
      in, vec, splits, strips, dsl_part, dsr_out, dv_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The float32 scratch bignn_flash_gat_bwd_f32 needs at this shape on the
// current device, written to *floats (int64). Launches nothing; returns 0.
int bignn_flash_gat_bwd_scratch_f32(int n, int heads, int head_dim,
                                    void* floats, void* stream) {
  (void)stream;
  *static_cast<int64_t*>(floats) =
      n > 0 && heads > 0 && head_dim > 0
          ? scratch_floats(n, heads, head_dim,
                           splits_of(n, heads, head_dim))
          : 0;
  return static_cast<int>(cudaSuccess);
}

// score_l/score_r/lse/delta [n, heads] f32, v/g [n, heads, head_dim] f32,
// cnt [n, n] f32; dsl/dsr [n, heads] f32, dv [n, heads, head_dim] f32;
// any head_dim >= 1 (heads <= 65535); scratch
// [scratch_floats] f32, as bignn_flash_gat_bwd_scratch_f32 sizes it.
// Launches the tile kernel and the reduction on the stream; returns
// cudaGetLastError().
int bignn_flash_gat_bwd_f32(const void* score_l, const void* score_r,
                            const void* v, const void* cnt, const void* lse,
                            const void* delta, const void* g, int n,
                            int heads, int head_dim, float slope, void* dsl,
                            void* dsr, void* dv, void* scratch,
                            long long scratch_size, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (heads <= 0 || heads > 65535 || head_dim <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int strips = strips_of(head_dim);
  const int splits = splits_of(n, heads, head_dim);
  if (scratch_size < scratch_floats(n, heads, head_dim, splits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{static_cast<const float*>(score_l),
                  static_cast<const float*>(score_r),
                  static_cast<const float*>(v),
                  static_cast<const float*>(cnt),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<const float*>(g),
                  n, heads, head_dim, slope};
  const bool vec = head_dim % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(g)) % 16 == 0;
  const int64_t nh = static_cast<int64_t>(n) * heads;
  float* dsl_part = static_cast<float*>(scratch);
  float* dsr_out = static_cast<float*>(dsr);
  float* dv_out = static_cast<float*>(dv);
  if (splits > 1) {
    dsr_out = dsl_part + cdiv(n, kTile) * nh;
    dv_out = dsr_out + splits * nh;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      head_dim <= 32
          ? launch_tiles<32>(in, vec, splits, dsl_part, dsr_out, dv_out, st)
      : head_dim <= kMaxHeadDim
          ? launch_tiles<64>(in, vec, splits, dsl_part, dsr_out, dv_out, st)
      : head_dim <= 128
          ? launch_wide<128>(in, vec, splits, strips, dsl_part, dsr_out,
                             dv_out, st)
          : launch_wide<256>(in, vec, splits, strips, dsl_part, dsr_out,
                             dv_out, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nhd = nh * head_dim;
  const int64_t work = splits > 1 ? nhd : nh;
  const int blocks = static_cast<int>(work / 256 + 1 < 1024 ? work / 256 + 1
                                                            : 1024);
  flash_gat_bwd_reduce<<<blocks, 256, 0, st>>>(
      dsl_part, cdiv(n, kTile), dsr_out, dv_out, splits, nh, nhd,
      static_cast<float*>(dsl), static_cast<float*>(dsr),
      static_cast<float*>(dv));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
