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
//
// Design: a block owns kRows = 16 destination rows (one m16 tile), kHB
// heads and a strip of kDP features of each (grid (N / 16, H / kHB,
// strips)); its warps are (head, part): kParts warps share a head's sweep
// over the sources. kDP is head_dim rounded up to 32, 64, 128 or 256, and
// kHB is tied to it (4 at 32 and 64, 2 at 128, 1 at 256), so that a
// stage's v rows and the parts' sums of p v take the same shared memory at
// every width (the sums would take 256 KB at 4 heads of 256, above the
// 227 KB a block may have). A head_dim above 256 is swept in strips of 256
// features, one a block (blockIdx.z): the row max, p and l depend on no
// feature, so every strip's block computes them with the same bits, and
// the first strip's block writes lse.
//   row max: m from one read of the block's cnt rows for all its heads.
//     fl(sl + x) is monotone in x, and LeakyReLU is monotone (slope >= 0)
//     or V-shaped (slope < 0), so over the sources s with cnt[d, s] > 0
//       m[d, h] = max(lrelu(sl + max_s sr[s, h]), lrelu(sl + min_s sr[s, h]))
//     bit for bit the direct max (tests/test_torch_softmax_flash.py holds
//     it against ops/flash_gat.py:flash_row_max_plain). Warps take the
//     block's rows in turn, lanes stride a row's sources, and the masked
//     max and min of score_r reduce by shuffles.
//   sweep: stages of kStage sources, the cnt tile, score_r and the heads'
//     v rows copied into shared memory by cp.async (16-byte copies where the
//     widths and pointers allow, else 4), kBuffers stages in flight. In a
//     stage each warp takes kSteps k-steps of 8 sources (half at head_dim
//     64, so that a stage holds the same bytes): its lanes compute p straight
//     into the m16n8k8 A-fragment layout (rows gid and gid + 8, sources tig
//     and tig + 4) from the staged cnt and score_r and the rows' score_l
//     and m in registers, split it into TF32 halves, and multiply it with
//     v's B fragments (split as they are loaded) in 3xTF32 (mma_3xtf32:
//     each k-step's product added to the sum in float32). The row sum l
//     adds the lane's own p in k-step order.
//   epilogue: l over a row's 4 lanes by shuffles, then the parts' partial
//     sums of l and of p v in part order through shared memory; out and lse
//     stored once.
// No float atomics and every sum in a fixed order, so a result repeats bit
// for bit (it is not the bits of the port's first kernel, whose sums ran
// in another order). The TF32 halves are cut by bit masks
// (split_tf32_trunc), not cvt.rna.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; device ms of a call from
// scripts/compare_kernel_trees.py): N 1,704, H 4, D 32 (config2) 0.0731
// (the port's first kernel, a block per 16 rows and head, two sweeps over
// the mask and p v on CUDA cores from shared memory, 0.2038): 14x the
// bound. scripts/probe_variants.py (kind fgf) chose 16 rows and 4 heads a
// block, 4 parts, 2 k-steps a stage and 3 buffers (0.0733): 2 buffers
// 0.0776, one head a block 0.0775. Wide: N 1,704, H 4, D 256 (one head a
// block, chip_smoke.py path O, queued behind a sleep) 0.3466, 9.4x its
// bound of 0.0367.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kRows = 16;          // destination rows a block owns
constexpr int kHeadsPerBlock = 4;  // heads a block owns at kDP 32 and 64
constexpr int kParts = 4;          // warps that share a head's sweep
constexpr int kSteps = 2;          // k-steps of 8 sources a warp takes a
                                   // stage at 128 staged features (half
                                   // at 256)
constexpr int kBuffers = 3;        // stages in shared memory (copies ahead)
constexpr int kMinBlocks = 1;      // blocks an SM holds (launch bounds)
constexpr int kMaxInFlight = 4;    // 16-byte cnt loads a lane has in flight
constexpr int kMaxStrip = 256;     // features a block owns at most
constexpr float kNeg = -1e30f;
constexpr float kFloor = 1e-30f;

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

// The heads a block owns at kDP features a head: 4 up to 64, then as many
// as fill 256 staged features.
constexpr int heads_per_block(int dp) {
  return dp <= 64 ? kHeadsPerBlock : kMaxStrip / dp;
}

// kDP: head_dim rounded up to 32, 64, 128 or 256 (the strip's width above
// 256); kHB = heads_per_block(kDP).
template <int kDP>
struct Smem {
  static constexpr int kHB = heads_per_block(kDP);
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
// rows, score_r and features c0 + [0, kDP) of the v rows of its heads;
// zeros past n, the heads and head_dim (p is 0 there, and 0 times a zero
// row adds nothing).
template <int kDP>
__device__ __forceinline__ void stage(Smem<kDP>& sm, int buf, int s0, int d0,
                                      int h0, int c0, const Inputs& in,
                                      bool vec_v, bool vec_cnt) {
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
      const int hb = q / kDP, c = c0 + q % kDP;
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
      const int hb = q / kDP, c = c0 + q % kDP;
      const bool ok = s0 + j < n && h0 + hb < in.heads && c < in.head_dim;
      bignn::cp_async4(&sm.v[buf][j][q],
                       ok ? in.v + (s0 + j) * cols + (h0 + hb) * in.head_dim
                                + c
                          : in.v,
                       ok);
    }
  }
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
  // the strip's first feature (a head is one strip up to kDP 64: 0)
  const int c0 = kDP > 64 ? static_cast<int>(blockIdx.z) * kDP : 0;
  const int stages = (n + S::kStage - 1) / S::kStage;

  // the first stages' copies fly while the row max is taken
#pragma unroll
  for (int b = 0; b < kBuffers - 1; ++b) {
    if (b < stages) {
      stage<kDP>(sm, b, b * S::kStage, d0, h0, c0, in, vec_v, vec_cnt);
    }
    bignn::cp_async_commit();
  }

  // the row max: the masked max and min of score_r over each row's sources
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int d = d0 + r;
    float mx[kHB], mn[kHB];
#pragma unroll
    for (int hb = 0; hb < kHB; ++hb) {
      mx[hb] = -INFINITY;
      mn[hb] = INFINITY;
    }
    if (d < n) {
      const float* row = in.cnt + static_cast<int64_t>(d) * n;
      if (vec_cnt) {  // 4 sources a load, kMaxInFlight loads at once
        for (int s0 = 4 * lane; s0 < n; s0 += 128 * kMaxInFlight) {
          float4 w[kMaxInFlight];
#pragma unroll
          for (int u = 0; u < kMaxInFlight; ++u) {
            const int s = s0 + 128 * u;
            w[u] = s < n ? __ldg(reinterpret_cast<const float4*>(row + s))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kMaxInFlight; ++u) {
            const int s = s0 + 128 * u;
            take_bounds(w[u].x, s, in, h0, mx, mn);
            take_bounds(w[u].y, s + 1, in, h0, mx, mn);
            take_bounds(w[u].z, s + 2, in, h0, mx, mn);
            take_bounds(w[u].w, s + 3, in, h0, mx, mn);
          }
        }
      } else {
        for (int s0 = lane; s0 < n; s0 += 32 * kMaxInFlight) {
          float w[kMaxInFlight];
#pragma unroll
          for (int u = 0; u < kMaxInFlight; ++u) {
            const int s = s0 + 32 * u;
            w[u] = s < n ? __ldg(row + s) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kMaxInFlight; ++u)
            take_bounds(w[u], s0 + 32 * u, in, h0, mx, mn);
        }
      }
    }
#pragma unroll
    for (int hb = 0; hb < kHB; ++hb) {
      mx[hb] = bignn::warp_max(mx[hb]);
      mn[hb] = warp_min(mn[hb]);
    }
    if (lane == 0) {
#pragma unroll
      for (int hb = 0; hb < kHB; ++hb) {
        const bool ok = d < n && h0 + hb < heads;
        const float sl = ok ? in.score_l[d * heads + h0 + hb] : 0.f;
        float m = kNeg;  // no edges: the plain version's clamp to NEG
        if (mn[hb] <= mx[hb]) {
          m = fmaxf(fmaxf(leaky_relu(sl + mx[hb], in.slope),
                          leaky_relu(sl + mn[hb], in.slope)),
                    kNeg);
        }
        sm.m[r][hb] = m;
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
                 (st + kBuffers - 1) * S::kStage, d0, h0, c0, in, vec_v,
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
    if (d >= n || h >= heads || c0 + col >= in.head_dim) continue;
    float a = 0.f, s = 0.f;
    for (int q = 0; q < kParts; ++q) {
      const int at = (q * kHB + hb) * kRows + row;
      a += red[at * kDP + col];
      s += lred[at];
    }
    out[(static_cast<int64_t>(d) * heads + h) * in.head_dim + c0 + col] =
        a / fmaxf(s, kFloor);
    if (c0 + col == 0) {
      lse[d * heads + h] = s > 0.f ? sm.m[row][hb] + logf(fmaxf(s, kFloor))
                                   : kNeg;
    }
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
  const dim3 grid(bignn::cdiv(in.n, kRows), bignn::cdiv(in.heads, S::kHB),
                  bignn::cdiv(in.head_dim, kDP));
  flash_gat_fwd<kDP><<<grid, S::kThreads, kBytes, st>>>(in, vec_v, vec_cnt,
                                                        out, lse);
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
      : head_dim <= 128 ? launch<128>(in, vec_v, vec_cnt, o, l, st)
                        : launch<256>(in, vec_v, vec_cnt, o, l, st);
  return static_cast<int>(err);
}

}  // extern "C"
