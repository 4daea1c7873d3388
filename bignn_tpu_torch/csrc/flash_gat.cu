// Masked additive (GAT) attention over a dense multiplicity mask, forward:
//   e[d, s, h]  = leaky_relu(score_l[d, h] + score_r[s, h])
//   p[d, s, h]  = cnt[d, s] * exp(e - m[d, h]),  m = max over s with cnt > 0
//   out[d, h, :] = sum_s p * v[s, h, :] / max(sum_s p, 1e-30)
//   lse[d, h]   = m + log(sum_s p), or -1e30 for a row with no edges
//
// Replaces bignn_tpu/ops/pallas/flash_gat.py:_fwd_kernel (_flash_fwd) and
// computes the same numbers as its no-grad XLA forward _fused_fwd_xla:
// NEG = -1e30, multiplicity scaling, the 1e-30 denominator floor, and zero
// output for rows with no edges. No [N, N, H] tensor is written.
//
// What bounds it on the H100: operations. Per (d, s, h) pair it does the
// score, its LeakyReLU, the exp and the multiplicity in float32, and the
// D-wide multiply-add p v, here on the tensor cores in 3xTF32 (three TF32
// products): at N 1,704, H 4, D 32, 3 x 0.74 GFLOP at TF32's 495 TFLOP/s
// (0.0045 ms) plus 0.05 GFLOP at float32's 67 (0.0007), 0.0052 ms
// (chip_smoke.bound_ms, flash_fwd_flops); the inputs are 12 MB (cnt, read
// from device memory once by the row-max pass and from L2 by the sweep).
// At D 256 the products are 8x larger: 0.0367 ms.
//
// Both forms take the row max from one read of the block's cnt rows:
//     fl(sl + x) is monotone in x, and LeakyReLU is monotone (slope >= 0)
//     or V-shaped (slope < 0), so over the sources s with cnt[d, s] > 0
//       m[d, h] = max(lrelu(sl + max_s sr[s, h]), lrelu(sl + min_s sr[s, h]))
//     bit for bit the direct max (tests/test_torch_softmax_flash.py holds
//     it against ops/flash_gat.py:flash_row_max_plain). Warps take the
//     block's rows in turn, lanes stride a row's sources, and the masked
//     max and min of score_r reduce by shuffles (row_bounds).
// Both multiply p by v in 3xTF32 on mma.sync m16n8k8 tiles (mma_3xtf32:
// each k-step's product added to the sum in float32), the TF32 halves cut
// by bit masks (split_tf32_trunc), not cvt.rna. No float atomics and every
// sum in a fixed order, so a result repeats bit for bit.
//
// Narrow form (head_dim up to 64; flash_gat_fwd<32|64>): a block owns
// kRows = 16 destination rows (one m16 tile) and kHeadsPerBlock heads
// (grid (N / 16, H / 4)); its warps are (head, part): kParts warps share a
// head's sweep over the sources. The sweep: stages of kStage sources, the
// cnt tile, score_r and the heads' v rows copied into shared memory by
// cp.async (16-byte copies where the widths and pointers allow, else 4),
// kBuffers stages in flight. In a stage each warp takes kSteps k-steps of
// 8 sources (half at head_dim 64, so that a stage holds the same bytes):
// its lanes compute p straight into the A-fragment layout (rows gid and
// gid + 8, sources tig and tig + 4) from the staged cnt and score_r and the
// rows' score_l and m in registers, and multiply it with v's B fragments
// (split as they are loaded). The row sum l adds the lane's own p in
// k-step order; the epilogue adds l over a row's 4 lanes by shuffles, then
// the parts' sums of l and of p v in part order through shared memory.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; device ms of a call from
// scripts/compare_kernel_trees.py): N 1,704, H 4, D 32 (config2) 0.0731
// (the port's first kernel, a block per 16 rows and head, two sweeps over
// the mask and p v on CUDA cores from shared memory, 0.2038): 14x the
// bound. scripts/probe_variants.py chose 16 rows and 4 heads a block, 4
// parts, 2 k-steps a stage and 3 buffers (0.0733): 2 buffers 0.0776, one
// head a block 0.0775.
//
// Wide form (head_dim above 64; flash_gat_fwd_wide<128|256>). The narrow
// tiling, widened (one head of 256 features a block), ran at 9.4x its bound
// (0.3466 ms at N 1,704, H 4, D 256): each block re-staged its head's whole
// v for 16 rows (~747 MB from L2 a call), and its 4 warps split the
// sources, so each held a 16 x 256 sum (255 registers) and the parts were
// added through 64 KB of shared memory. This form:
//   - a block owns kWideRows = 64 destination rows of one head and a strip
//     of kDP features (128 up to head_dim 128, else 256; grid (N / 64, H,
//     head_dim / kDP)): 64 rows share each staged v tile (~190 MB from L2
//     at D 256);
//   - its warps split the rows and the strip's features, never the
//     sources: a warp owns kWideMTiles = 2 m16 tiles by kWideWarpCols = 32
//     features (8 warps at kDP 128, two blocks an SM; 16 at 256, one), its
//     sum in registers (32 floats a lane), each v fragment split once for
//     both m16 tiles; no parts to add;
//   - p of a stage is computed once a block, a lane a source and a warp a
//     set of rows, from the staged cnt and score_r, and written to shared
//     memory already split into TF32 halves for the A fragments; the lane
//     keeps its rows' running l (the stages in order), added over the 32
//     source lanes by shuffles at the end;
//   - the row max keeps kWideInFlight loads of cnt in flight a lane;
//   - every strip's block computes m, p and l with the same bits (they
//     depend on no feature), and the first strip's block writes lse.
//   Measured (NVIDIA H100 80GB HBM3, 700.00 W; device ms queued behind a
//   sleep, scripts/probe_variants.py fgf): N 1,704, H 4, D 256 0.2166 (the
//   first wide form 0.3466), 5.9x its bound; H 8, D 128 0.2448 (0.4375).
//   128 registers, 40-52 bytes spilled (the launch bounds' cap). Taken out
//   one at a time at D 256 (scripts/probe_flash_phases.py): all of p v
//   0.098 ms, the two smaller products of 3xTF32 0.081, the exp 0.016, the
//   row max 0.016. mma.sync in TF32 runs at 314-324 TFLOP/s on this card
//   (scripts/probe_mma_rate.py; 3xTF32's products at D 256: 0.056 ms), so
//   what holds the form is issue: per mma.sync, v's splits, the float32
//   adds of 3xTF32 and the fragment loads. Variants: 32 or 128
//   rows, one or four m16 tiles a warp, 64 features a warp, 3 or 4 stages,
//   8 or 16 loads in flight: 0.21-0.64; p of the next stage computed
//   during this stage's p v (one barrier a stage) 0.30 (spilled 140
//   bytes).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kRows = 16;          // destination rows a block owns
constexpr int kHeadsPerBlock = 4;  // heads a block owns
constexpr int kParts = 4;          // warps that share a head's sweep
constexpr int kSteps = 2;          // k-steps of 8 sources a warp takes a
                                   // stage at 128 staged features (half
                                   // at 256)
constexpr int kBuffers = 3;        // stages in shared memory (copies ahead)
constexpr int kMinBlocks = 1;      // blocks an SM holds (launch bounds)
constexpr int kMaxInFlight = 4;    // 16-byte cnt loads a lane has in flight
constexpr float kNeg = -1e30f;
constexpr float kFloor = 1e-30f;

// the wide form (head_dim above 64)
constexpr int kWideRows = 64;       // destination rows a block owns
constexpr int kWideMTiles = 2;      // m16 tiles (16 rows each) a warp owns
constexpr int kWideWarpCols = 32;   // features a warp owns
constexpr int kWideBuffers = 2;     // stages in shared memory
constexpr int kWideThreadsPerSm = 512;  // threads an SM holds (launch
                                        // bounds: 2 blocks at kDP 128)
constexpr int kWideStage = 32;      // sources a stage: one a lane for p
constexpr int kWideInFlight = 8;    // 16-byte cnt loads a lane has in flight

struct Inputs {
  const float* score_l;  // [n, heads]
  const float* score_r;  // [n, heads]
  const float* v;        // [n, heads, head_dim]
  const float* cnt;      // [n, n], cnt[d, s]
  int n, heads, head_dim;
  float slope;
};

__device__ __forceinline__ float leaky_relu(float z, float slope) {
  return z > 0.f ? z : slope * z;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Source s, whose cnt is w, into the masked max and min of score_r for the
// block's kHB heads.
template <int kHB>
__device__ __forceinline__ void take_bounds(float w, int s, const Inputs& in,
                                            int h0, float (&mx)[kHB],
                                            float (&mn)[kHB]) {
  if (w > 0.f) {
#pragma unroll
    for (int hb = 0; hb < kHB; ++hb) {
      if (h0 + hb < in.heads) {
        const float x = __ldg(in.score_r + s * in.heads + h0 + hb);
        mx[hb] = fmaxf(mx[hb], x);
        mn[hb] = fminf(mn[hb], x);
      }
    }
  }
}

// The masked max and min of score_r over destination d's sources, for
// heads h0 + [0, kHB), reduced over the warp (every lane gets them).
template <int kInFlight, int kHB>
__device__ __forceinline__ void row_bounds(int d, const Inputs& in, int h0,
                                           bool vec_cnt, int lane,
                                           float (&mx)[kHB],
                                           float (&mn)[kHB]) {
  const int n = in.n;
#pragma unroll
  for (int hb = 0; hb < kHB; ++hb) {
    mx[hb] = -INFINITY;
    mn[hb] = INFINITY;
  }
  if (d < n) {
    const float* row = in.cnt + static_cast<int64_t>(d) * n;
    if (vec_cnt) {  // 4 sources a load, kInFlight loads at once
      for (int s0 = 4 * lane; s0 < n; s0 += 128 * kInFlight) {
        float4 w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int s = s0 + 128 * u;
          w[u] = s < n ? __ldg(reinterpret_cast<const float4*>(row + s))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int s = s0 + 128 * u;
          take_bounds(w[u].x, s, in, h0, mx, mn);
          take_bounds(w[u].y, s + 1, in, h0, mx, mn);
          take_bounds(w[u].z, s + 2, in, h0, mx, mn);
          take_bounds(w[u].w, s + 3, in, h0, mx, mn);
        }
      }
    } else {
      for (int s0 = lane; s0 < n; s0 += 32 * kInFlight) {
        float w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int s = s0 + 32 * u;
          w[u] = s < n ? __ldg(row + s) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          take_bounds(w[u], s0 + 32 * u, in, h0, mx, mn);
      }
    }
  }
#pragma unroll
  for (int hb = 0; hb < kHB; ++hb) {
    mx[hb] = bignn::warp_max(mx[hb]);
    mn[hb] = warp_min(mn[hb]);
  }
}

// m of a row from its score_l and bounds: NEG for a row with no edges (the
// plain version's clamp to NEG).
__device__ __forceinline__ float row_max(float sl, float mx, float mn,
                                         float slope) {
  if (mn > mx) return kNeg;
  return fmaxf(fmaxf(leaky_relu(sl + mx, slope), leaky_relu(sl + mn, slope)),
               kNeg);
}

// ---- the narrow form ----

// kDP: head_dim rounded up to 32 or 64.
template <int kDP>
struct Smem {
  static_assert(kDP <= 64, "wider heads take the wide form");
  static constexpr int kHB = kHeadsPerBlock;
  static constexpr int kThreads = kHB * kParts * 32;
  static constexpr int kCols = kHB * kDP;  // features staged a source
  // k-steps a warp takes a stage: the same bytes of v a stage at every kDP
  static constexpr int kWarpSteps = kCols <= 128 || kSteps == 1
                                        ? kSteps
                                        : kSteps * 128 / kCols;
  static constexpr int kStage = kParts * kWarpSteps * 8;  // sources a stage
  static constexpr int kCntRow = kStage + 4;  // 4 mod 32: conflict-free
  // floats a staged v row: 8 mod 32, so that a B fragment's 4 source rows
  // and 8 features fall in 32 banks
  static constexpr int kVRow = kCols + 8;
  // the parts' sums of p v, once the stages are used
  static constexpr int kRed = kParts * kHB * kRows * kDP;
  union {
    float v[kBuffers][kStage][kVRow];
    float red[kRed];
  };
  float cnt[kBuffers][kRows][kCntRow];
  float sr[kBuffers][kStage][kHB];
  float m[kRows][kHB];
  float sl[kRows][kHB];
};

// Stage s0 + [0, kStage) of the sources into buffer buf: the block's cnt
// rows, score_r and the v rows of its heads; zeros past n, the heads and
// head_dim (p is 0 there, and 0 times a zero row adds nothing).
template <int kDP>
__device__ __forceinline__ void stage(Smem<kDP>& sm, int buf, int s0, int d0,
                                      int h0, const Inputs& in, bool vec_v,
                                      bool vec_cnt) {
  constexpr int kStage = Smem<kDP>::kStage;
  constexpr int kHB = Smem<kDP>::kHB;
  constexpr int kThreads = Smem<kDP>::kThreads;
  const int n = in.n;
  if (vec_cnt) {  // n % 4 == 0: a quad of sources is in or out whole
    constexpr int kQuads = kStage / 4;
    for (int i = threadIdx.x; i < kRows * kQuads; i += kThreads) {
      const int r = i / kQuads, c = 4 * (i % kQuads);
      const bool ok = d0 + r < n && s0 + c < n;
      bignn::cp_async16(
          &sm.cnt[buf][r][c],
          ok ? in.cnt + static_cast<int64_t>(d0 + r) * n + s0 + c : in.cnt,
          ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kStage; i += kThreads) {
      const int r = i / kStage, c = i % kStage;
      const bool ok = d0 + r < n && s0 + c < n;
      bignn::cp_async4(
          &sm.cnt[buf][r][c],
          ok ? in.cnt + static_cast<int64_t>(d0 + r) * n + s0 + c : in.cnt,
          ok);
    }
  }
  for (int i = threadIdx.x; i < kStage * kHB; i += kThreads) {
    const int j = i / kHB, hb = i % kHB;
    const bool ok = s0 + j < n && h0 + hb < in.heads;
    bignn::cp_async4(&sm.sr[buf][j][hb],
                     ok ? in.score_r + (s0 + j) * in.heads + h0 + hb
                        : in.score_r,
                     ok);
  }
  const int64_t cols = static_cast<int64_t>(in.heads) * in.head_dim;
  if (vec_v) {  // head_dim % 4 == 0: a quad of features is in or out whole
    constexpr int kQuads = kHB * kDP / 4;
    for (int i = threadIdx.x; i < kStage * kQuads; i += kThreads) {
      const int j = i / kQuads, q = 4 * (i % kQuads);
      const int hb = q / kDP, c = q % kDP;
      const bool ok = s0 + j < n && h0 + hb < in.heads && c < in.head_dim;
      bignn::cp_async16(&sm.v[buf][j][q],
                        ok ? in.v + (s0 + j) * cols + (h0 + hb) * in.head_dim
                                 + c
                           : in.v,
                        ok);
    }
  } else {
    constexpr int kCols = kHB * kDP;
    for (int i = threadIdx.x; i < kStage * kCols; i += kThreads) {
      const int j = i / kCols, q = i % kCols;
      const int hb = q / kDP, c = q % kDP;
      const bool ok = s0 + j < n && h0 + hb < in.heads && c < in.head_dim;
      bignn::cp_async4(&sm.v[buf][j][q],
                       ok ? in.v + (s0 + j) * cols + (h0 + hb) * in.head_dim
                                + c
                          : in.v,
                       ok);
    }
  }
}

template <int kDP>
__global__ void __launch_bounds__(Smem<kDP>::kThreads, kMinBlocks)
    flash_gat_fwd(Inputs in, bool vec_v, bool vec_cnt,
                  float* __restrict__ out,   // [n, heads, head_dim]
                  float* __restrict__ lse) {  // [n, heads]
  using S = Smem<kDP>;
  constexpr int kHB = S::kHB;
  constexpr int kThreads = S::kThreads;
  static_assert(kBuffers >= 2, "a stage in flight while one is used");
  static_assert(kBuffers * kRows * S::kCntRow >= kParts * kHB * kRows,
                "the parts' sums of p fit the cnt buffers");
  constexpr int kTiles = kDP / 8;  // n8 tiles of the head's features
  extern __shared__ uint4 smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int hh = warp / kParts, part = warp % kParts;
  const int n = in.n, heads = in.heads;
  const int d0 = blockIdx.x * kRows, h0 = blockIdx.y * kHB;
  const int stages = (n + S::kStage - 1) / S::kStage;

  // the first stages' copies fly while the row max is taken
#pragma unroll
  for (int b = 0; b < kBuffers - 1; ++b) {
    if (b < stages) {
      stage<kDP>(sm, b, b * S::kStage, d0, h0, in, vec_v, vec_cnt);
    }
    bignn::cp_async_commit();
  }

  // the row max: the masked max and min of score_r over each row's sources
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int d = d0 + r;
    float mx[kHB], mn[kHB];
    row_bounds<kMaxInFlight>(d, in, h0, vec_cnt, lane, mx, mn);
    if (lane == 0) {
#pragma unroll
      for (int hb = 0; hb < kHB; ++hb) {
        const bool ok = d < n && h0 + hb < heads;
        const float sl = ok ? in.score_l[d * heads + h0 + hb] : 0.f;
        sm.m[r][hb] = row_max(sl, mx[hb], mn[hb], in.slope);
        sm.sl[r][hb] = sl;
      }
    }
  }
  __syncthreads();

  // the sweep: rows gid and gid + 8 of head hh, this warp's k-steps
  float sl[2], m[2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sl[i] = sm.sl[gid + 8 * i][hh];
    m[i] = sm.m[gid + 8 * i][hh];
  }
  float acc[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;

  for (int st = 0; st < stages; ++st) {
    const int buf = st % kBuffers;
    bignn::cp_async_wait<kBuffers - 2>();  // this stage's copies are in
    __syncthreads();  // ... for every thread, and the last stage is used
    if (st + kBuffers - 1 < stages) {
      stage<kDP>(sm, (st + kBuffers - 1) % kBuffers,
                 (st + kBuffers - 1) * S::kStage, d0, h0, in, vec_v,
                 vec_cnt);
    }
    bignn::cp_async_commit();
#pragma unroll
    for (int k = 0; k < S::kWarpSteps; ++k) {
      const int j = (part * S::kWarpSteps + k) * 8;  // the k-step's source
      // a = {p[gid][tig], p[gid + 8][tig], p[gid][tig + 4],
      //      p[gid + 8][tig + 4]}
      float p[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = q % 2, c = j + tig + 4 * (q / 2);
        const float w = sm.cnt[buf][gid + 8 * i][c];
        const float e = leaky_relu(sl[i] + sm.sr[buf][c][hh], in.slope);
        p[q] = w > 0.f ? w * expf(e - m[i]) : 0.f;
      }
      l[0] += p[0];
      l[0] += p[2];
      l[1] += p[1];
      l[1] += p[3];
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bignn::split_tf32_trunc(p[q], a_hi[q], a_lo[q]);
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        const int f = hh * kDP + 8 * t + gid;
        uint32_t b_hi[2], b_lo[2];
        bignn::split_tf32_trunc(sm.v[buf][j + tig][f], b_hi[0], b_lo[0]);
        bignn::split_tf32_trunc(sm.v[buf][j + tig + 4][f], b_hi[1], b_lo[1]);
        bignn::mma_3xtf32(acc[t], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
  bignn::cp_async_wait<0>();
  __syncthreads();  // every stage used: the buffers are free

  // the parts' sums: l over a row's 4 lanes, then each part's l and p v to
  // shared memory (the staging buffers), added in part order
  float* lred = &sm.cnt[0][0][0];  // [kParts][kHB][kRows]
  float* red = sm.red;             // [kParts][kHB][kRows][kDP]
  const int slot = part * kHB + hh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x = l[i];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (tig == 0) lred[slot * kRows + gid + 8 * i] = x;
  }
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = gid + 8 * (r / 2), col = 8 * t + 2 * tig + r % 2;
      red[(slot * kRows + row) * kDP + col] = acc[t][r];
    }
  __syncthreads();
  for (int i = tid; i < kHB * kRows * kDP; i += kThreads) {
    const int hb = i / (kRows * kDP), row = (i / kDP) % kRows, col = i % kDP;
    const int d = d0 + row, h = h0 + hb;
    if (d >= n || h >= heads || col >= in.head_dim) continue;
    float a = 0.f, s = 0.f;
    for (int q = 0; q < kParts; ++q) {
      const int at = (q * kHB + hb) * kRows + row;
      a += red[at * kDP + col];
      s += lred[at];
    }
    out[(static_cast<int64_t>(d) * heads + h) * in.head_dim + col] =
        a / fmaxf(s, kFloor);
    if (col == 0) {
      lse[d * heads + h] = s > 0.f ? sm.m[row][hb] + logf(fmaxf(s, kFloor))
                                   : kNeg;
    }
  }
}

// ---- the wide form ----

// kDP: 128 (head_dim up to 128) or 256 (above: strips of 256). A block
// owns kDP features of a head (a strip), kWideRows rows and kThreads / 32
// warps: kWarpRows rows by kWideWarpCols features a warp.
template <int kDP>
struct WideSmem {
  static constexpr int kWarpRows = 16 * kWideMTiles;          // a warp's
  static constexpr int kRowGroups = kWideRows / kWarpRows;
  static constexpr int kColGroups = kDP / kWideWarpCols;
  static constexpr int kWarps = kRowGroups * kColGroups;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kMinBlocks =  // blocks an SM holds (launch bounds)
      kWideThreadsPerSm > kThreads ? kWideThreadsPerSm / kThreads : 1;
  static constexpr int kTiles = kWideWarpCols / 8;           // n8 tiles
  static constexpr int kRowsPerWarp = kWideRows / kWarps;    // p's rows
  static_assert(kWideRows % kWarpRows == 0 && kDP % kWideWarpCols == 0 &&
                    kWideWarpCols % 8 == 0 && kWideRows % kWarps == 0 &&
                    kWideBuffers >= 2 && kWideStage == 32,
                "the wide form's warps tile its rows and strip");
  static constexpr int kPRow = kWideStage + 4;  // 4 mod 32: conflict-free
  static constexpr int kVRow = kDP + 8;         // 8 mod 32, as Smem::kVRow
  float v[kWideBuffers][kWideStage][kVRow];
  float cnt[kWideBuffers][kWideRows][kPRow];
  float sr[kWideBuffers][kWideStage];
  float p_hi[kWideRows][kPRow];  // the stage's p, [row][source], split
  float p_lo[kWideRows][kPRow];
  float m[kWideRows];
  float sl[kWideRows];
  float l[kWideRows];
};

// Stage s0 + [0, kWideStage) of the sources into buffer buf: the block's
// cnt rows, score_r and features c0 + [0, kDP) of head h's v rows; zeros
// past n and head_dim.
template <int kDP>
__device__ __forceinline__ void wide_stage(WideSmem<kDP>& sm, int buf, int s0,
                                           int d0, int h, int c0,
                                           const Inputs& in, bool vec_v,
                                           bool vec_cnt) {
  constexpr int kThreads = WideSmem<kDP>::kThreads;
  const int n = in.n;
  if (vec_cnt) {
    constexpr int kQuads = kWideStage / 4;
    for (int i = threadIdx.x; i < kWideRows * kQuads; i += kThreads) {
      const int r = i / kQuads, c = 4 * (i % kQuads);
      const bool ok = d0 + r < n && s0 + c < n;
      bignn::cp_async16(
          &sm.cnt[buf][r][c],
          ok ? in.cnt + static_cast<int64_t>(d0 + r) * n + s0 + c : in.cnt,
          ok);
    }
  } else {
    for (int i = threadIdx.x; i < kWideRows * kWideStage; i += kThreads) {
      const int r = i / kWideStage, c = i % kWideStage;
      const bool ok = d0 + r < n && s0 + c < n;
      bignn::cp_async4(
          &sm.cnt[buf][r][c],
          ok ? in.cnt + static_cast<int64_t>(d0 + r) * n + s0 + c : in.cnt,
          ok);
    }
  }
  for (int j = threadIdx.x; j < kWideStage; j += kThreads) {
    const bool ok = s0 + j < n;
    bignn::cp_async4(&sm.sr[buf][j],
                     ok ? in.score_r + (s0 + j) * in.heads + h : in.score_r,
                     ok);
  }
  const int64_t cols = static_cast<int64_t>(in.heads) * in.head_dim;
  const float* vh = in.v + h * in.head_dim + c0;
  const int width = in.head_dim - c0;
  if (vec_v) {  // head_dim % 4 == 0: a quad of features is in or out whole
    constexpr int kQuads = kDP / 4;
    for (int i = threadIdx.x; i < kWideStage * kQuads; i += kThreads) {
      const int j = i / kQuads, q = 4 * (i % kQuads);
      const bool ok = s0 + j < n && q < width;
      bignn::cp_async16(&sm.v[buf][j][q],
                        ok ? vh + (s0 + j) * cols + q : in.v, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kWideStage * kDP; i += kThreads) {
      const int j = i / kDP, q = i % kDP;
      const bool ok = s0 + j < n && q < width;
      bignn::cp_async4(&sm.v[buf][j][q],
                       ok ? vh + (s0 + j) * cols + q : in.v, ok);
    }
  }
}

template <int kDP>
__global__ void __launch_bounds__(WideSmem<kDP>::kThreads,
                                  WideSmem<kDP>::kMinBlocks)
    flash_gat_fwd_wide(Inputs in, bool vec_v, bool vec_cnt,
                       float* __restrict__ out,   // [n, heads, head_dim]
                       float* __restrict__ lse) {  // [n, heads]
  using S = WideSmem<kDP>;
  constexpr int kWarps = S::kWarps, kRPW = S::kRowsPerWarp;
  extern __shared__ uint4 smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n = in.n, heads = in.heads;
  const int d0 = blockIdx.x * kWideRows, h = blockIdx.y;
  const int c0 = blockIdx.z * kDP;  // the strip's first feature
  const int stages = (n + kWideStage - 1) / kWideStage;
  // the warp's tile of p v: rows r0 + [0, kWarpRows) (kWideMTiles m16
  // tiles), features f0 + [0, kWideWarpCols)
  const int r0 = S::kWarpRows * (warp % S::kRowGroups);
  const int f0 = kWideWarpCols * (warp / S::kRowGroups);

  // the first stages' copies fly while the row max is taken
#pragma unroll
  for (int b = 0; b < kWideBuffers - 1; ++b) {
    if (b < stages) {
      wide_stage(sm, b, b * kWideStage, d0, h, c0, in, vec_v, vec_cnt);
    }
    bignn::cp_async_commit();
  }

  for (int r = warp; r < kWideRows; r += kWarps) {
    const int d = d0 + r;
    float mx[1], mn[1];
    row_bounds<kWideInFlight>(d, in, h, vec_cnt, lane, mx, mn);
    if (lane == 0) {
      const float sl = d < n ? in.score_l[d * heads + h] : 0.f;
      sm.m[r] = row_max(sl, mx[0], mn[0], in.slope);
      sm.sl[r] = sl;
    }
  }
  __syncthreads();

  // p's rows of this lane: warp + kWarps i; its source: lane
  float sl[kRPW], m[kRPW], l[kRPW];
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    sl[i] = sm.sl[warp + kWarps * i];
    m[i] = sm.m[warp + kWarps * i];
    l[i] = 0.f;
  }
  float acc[kWideMTiles][S::kTiles][4];
#pragma unroll
  for (int mt = 0; mt < kWideMTiles; ++mt)
#pragma unroll
    for (int t = 0; t < S::kTiles; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][t][r] = 0.f;

  for (int st = 0; st < stages; ++st) {
    const int buf = st % kWideBuffers;
    bignn::cp_async_wait<kWideBuffers - 2>();  // this stage's copies are in
    __syncthreads();  // ... for every thread; the last stage's p is used
    if (st + kWideBuffers - 1 < stages) {
      wide_stage(sm, (st + kWideBuffers - 1) % kWideBuffers,
                 (st + kWideBuffers - 1) * kWideStage, d0, h, c0, in, vec_v,
                 vec_cnt);
    }
    bignn::cp_async_commit();
    // the stage's p, once a block: the lane's source, the warp's rows; l
    // adds the stages in order
    const float sr = sm.sr[buf][lane];
#pragma unroll
    for (int i = 0; i < kRPW; ++i) {
      const int r = warp + kWarps * i;
      const float w = sm.cnt[buf][r][lane];
      const float e = leaky_relu(sl[i] + sr, in.slope);
      const float p = w > 0.f ? w * expf(e - m[i]) : 0.f;
      l[i] += p;
      uint32_t hi, lo;
      bignn::split_tf32_trunc(p, hi, lo);
      sm.p_hi[r][lane] = __uint_as_float(hi);
      sm.p_lo[r][lane] = __uint_as_float(lo);
    }
    __syncthreads();  // the stage's p is complete
#pragma unroll
    for (int k = 0; k < kWideStage; k += 8) {
      // a = {p[gid][k + tig], p[gid + 8][k + tig], p[gid][k + tig + 4],
      //      p[gid + 8][k + tig + 4]} of each of the warp's m16 tiles
      uint32_t a_hi[kWideMTiles][4], a_lo[kWideMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kWideMTiles; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + 16 * mt + gid + 8 * (q % 2);
          const int c = k + tig + 4 * (q / 2);
          a_hi[mt][q] = __float_as_uint(sm.p_hi[r][c]);
          a_lo[mt][q] = __float_as_uint(sm.p_lo[r][c]);
        }
#pragma unroll
      for (int t = 0; t < S::kTiles; ++t) {
        const int f = f0 + 8 * t + gid;
        uint32_t b_hi[2], b_lo[2];  // split once for the warp's m16 tiles
        bignn::split_tf32_trunc(sm.v[buf][k + tig][f], b_hi[0], b_lo[0]);
        bignn::split_tf32_trunc(sm.v[buf][k + tig + 4][f], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mt = 0; mt < kWideMTiles; ++mt)
          bignn::mma_3xtf32(acc[mt][t], a_hi[mt], a_lo[mt], b_hi, b_lo);
      }
    }
  }
  bignn::cp_async_wait<0>();

  // l: each row's lanes (its sources) added by shuffles, then stored
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    float x = l[i];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) sm.l[warp + kWarps * i] = x;
  }
  __syncthreads();

  const int width = in.head_dim - c0;
#pragma unroll
  for (int mt = 0; mt < kWideMTiles; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * mt + gid + 8 * i, d = d0 + r;
      if (d >= n) continue;
      const float s = fmaxf(sm.l[r], kFloor);
      float* o =
          out + (static_cast<int64_t>(d) * heads + h) * in.head_dim + c0;
#pragma unroll
      for (int t = 0; t < S::kTiles; ++t) {
        const int f = f0 + 8 * t + 2 * tig;
        if (f < width) o[f] = acc[mt][t][2 * i] / s;
        if (f + 1 < width) o[f + 1] = acc[mt][t][2 * i + 1] / s;
      }
    }
  if (blockIdx.z == 0 && tid < kWideRows && d0 + tid < n) {
    const float s = sm.l[tid];
    lse[(d0 + tid) * heads + h] =
        s > 0.f ? sm.m[tid] + logf(fmaxf(s, kFloor)) : kNeg;
  }
}

template <int kDP>
cudaError_t launch(const Inputs& in, bool vec_v, bool vec_cnt, float* out,
                   float* lse, cudaStream_t st) {
  using S = Smem<kDP>;
  constexpr int kBytes = sizeof(S);
  static int done[bignn::kMaxDevices] = {};
  const cudaError_t set = bignn::allow_smem(flash_gat_fwd<kDP>, kBytes, done);
  if (set != cudaSuccess) return set;
  const dim3 grid(bignn::cdiv(in.n, kRows), bignn::cdiv(in.heads, S::kHB));
  flash_gat_fwd<kDP><<<grid, S::kThreads, kBytes, st>>>(in, vec_v, vec_cnt,
                                                        out, lse);
  return cudaGetLastError();
}

template <int kDP>
cudaError_t launch_wide(const Inputs& in, bool vec_v, bool vec_cnt,
                        float* out, float* lse, cudaStream_t st) {
  using S = WideSmem<kDP>;
  constexpr int kBytes = sizeof(S);
  static int done[bignn::kMaxDevices] = {};
  const cudaError_t set =
      bignn::allow_smem(flash_gat_fwd_wide<kDP>, kBytes, done);
  if (set != cudaSuccess) return set;
  const dim3 grid(bignn::cdiv(in.n, kWideRows), in.heads,
                  bignn::cdiv(in.head_dim, kDP));
  flash_gat_fwd_wide<kDP><<<grid, S::kThreads, kBytes, st>>>(
      in, vec_v, vec_cnt, out, lse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// score_l/score_r [n, heads] f32, v [n, heads, head_dim] f32, cnt [n, n] f32;
// out [n, heads, head_dim] f32, lse [n, heads] f32; any head_dim >= 1.
// Returns cudaGetLastError().
int bignn_flash_gat_fwd_f32(const void* score_l, const void* score_r,
                            const void* v, const void* cnt, int n, int heads,
                            int head_dim, float slope, void* out, void* lse,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (heads <= 0 || head_dim <= 0 || heads > 65535) {  // grid's y axis
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{static_cast<const float*>(score_l),
                  static_cast<const float*>(score_r),
                  static_cast<const float*>(v),
                  static_cast<const float*>(cnt),
                  n, heads, head_dim, slope};
  const bool vec_v = head_dim % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const bool vec_cnt = n % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(cnt) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      head_dim <= 32    ? launch<32>(in, vec_v, vec_cnt, o, l, st)
      : head_dim <= 64  ? launch<64>(in, vec_v, vec_cnt, o, l, st)
      : head_dim <= 128 ? launch_wide<128>(in, vec_v, vec_cnt, o, l, st)
                        : launch_wide<256>(in, vec_v, vec_cnt, o, l, st);
  return static_cast<int>(err);
}

}  // extern "C"
