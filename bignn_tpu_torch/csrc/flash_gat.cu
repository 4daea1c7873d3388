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
// Design: a thread block owns kRows destination rows of one head (grid
// (N / kRows, H)), and makes two sweeps over the sources in chunks of
// kChunk, staging the cnt tile, score_r and (second sweep) v in shared
// memory:
//   sweep 1: the masked row max m[r];
//   sweep 2: every thread computes p for kChunk / 8 sources of one row into
//            shared memory and keeps a partial row sum; then each warp adds
//            p * v into the outputs of its 4 rows, one column per lane,
//            held in registers.
// Partial maxima and sums are combined in a fixed order, so a result is the
// same from run to run. The outer graph takes the dense path only up to
// 4096 drugs, so two sweeps over a cnt row cost little and no online
// rescaling is needed.
//
// What bounds it on the H100: at N=1704, H=4, D=32 it is latency: 2 *
// N^2 * H * D = 0.74 GFLOP of FMAs and about 200 MB of L2 reads (each block
// reads its head's v and its cnt rows) spread over 428 blocks of 4 warps
// with a barrier every kChunk sources. Splitting by head keeps every block
// busy on exps and FMAs, with no thread idle while others compute p.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 16;     // destination rows per block
constexpr int kChunk = 64;    // sources per shared-memory stage
constexpr int kThreads = 128;
constexpr int kPartsPerRow = kThreads / kRows;        // 8 threads per row
constexpr int kSrcPerThread = kChunk / kPartsPerRow;  // 8 sources each
constexpr int kRowsPerWarp = kRows / (kThreads / 32);  // 4
constexpr int kMaxHeadDim = 64;
constexpr int kColsPerLane = kMaxHeadDim / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float leaky_relu(float z, float slope) {
  return z > 0.f ? z : slope * z;
}

__global__ void __launch_bounds__(kThreads)
    flash_gat_fwd(const float* __restrict__ score_l,  // [n, heads]
                  const float* __restrict__ score_r,  // [n, heads]
                  const float* __restrict__ v,        // [n, heads, head_dim]
                  const float* __restrict__ cnt,      // [n, n]
                  int n, int heads, int head_dim, float slope,
                  float* __restrict__ out,            // [n, heads, head_dim]
                  float* __restrict__ lse) {          // [n, heads]
  __shared__ float s_cnt[kRows][kChunk];
  __shared__ float s_sr[kChunk];
  __shared__ float s_v[kChunk][kMaxHeadDim];
  __shared__ float s_p[kRows][kChunk];
  __shared__ float s_sl[kRows];
  __shared__ float s_m[kRows];
  __shared__ float s_l[kRows];
  __shared__ float s_part[kRows][kPartsPerRow];

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int cols = heads * head_dim;
  // this thread's row and sources for the softmax statistics
  const int pr = tid / kPartsPerRow;
  const int pj = (tid % kPartsPerRow) * kSrcPerThread;

  if (tid < kRows) {
    s_sl[tid] = d0 + tid < n ? score_l[(d0 + tid) * heads + h] : 0.f;
  }
  auto stage_mask = [&](int s0) {
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i % kChunk;
      const int d = d0 + r, s = s0 + j;
      s_cnt[r][j] =
          (d < n && s < n) ? cnt[static_cast<int64_t>(d) * n + s] : 0.f;
    }
    for (int j = tid; j < kChunk; j += kThreads) {
      s_sr[j] = s0 + j < n ? score_r[(s0 + j) * heads + h] : 0.f;
    }
  };

  // sweep 1: masked row max
  float part = kNeg;
  for (int s0 = 0; s0 < n; s0 += kChunk) {
    stage_mask(s0);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kSrcPerThread; ++q) {
      const int j = pj + q;
      if (s_cnt[pr][j] > 0.f) {
        part = fmaxf(part, leaky_relu(s_sl[pr] + s_sr[j], slope));
      }
    }
    __syncthreads();
  }
  s_part[pr][tid % kPartsPerRow] = part;
  __syncthreads();
  if (tid < kRows) {
    float m = kNeg;
    for (int q = 0; q < kPartsPerRow; ++q) m = fmaxf(m, s_part[tid][q]);
    s_m[tid] = m;
  }
  __syncthreads();

  // sweep 2: weights, their sum, and the weighted sum of v
  const int warp = tid / 32, lane = tid % 32;
  const float m = s_m[pr];
  float lsum = 0.f;
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) acc[r][k] = 0.f;

  for (int s0 = 0; s0 < n; s0 += kChunk) {
    stage_mask(s0);
    for (int i = tid; i < kChunk * head_dim; i += kThreads) {
      const int j = i / head_dim, c = i % head_dim;
      s_v[j][c] = s0 + j < n
          ? v[static_cast<int64_t>(s0 + j) * cols + h * head_dim + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kSrcPerThread; ++q) {
      const int j = pj + q;
      const float c = s_cnt[pr][j];
      const float p =
          c > 0.f ? c * expf(leaky_relu(s_sl[pr] + s_sr[j], slope) - m) : 0.f;
      s_p[pr][j] = p;
      lsum += p;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < head_dim) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int row = warp * kRowsPerWarp + r;
          float a = acc[r][k];
#pragma unroll 16
          for (int j = 0; j < kChunk; ++j) a += s_p[row][j] * s_v[j][c];
          acc[r][k] = a;
        }
      }
    }
    __syncthreads();
  }

  s_part[pr][tid % kPartsPerRow] = lsum;
  __syncthreads();
  if (tid < kRows) {
    float l = 0.f;
    for (int q = 0; q < kPartsPerRow; ++q) l += s_part[tid][q];
    s_l[tid] = l;
    if (d0 + tid < n) {
      lse[(d0 + tid) * heads + h] =
          l > 0.f ? s_m[tid] + logf(fmaxf(l, 1e-30f)) : kNeg;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < head_dim) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r;
        if (d0 + row < n) {
          out[static_cast<int64_t>(d0 + row) * cols + h * head_dim + c] =
              acc[r][k] / fmaxf(s_l[row], 1e-30f);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// score_l/score_r [n, heads] f32, v [n, heads, head_dim] f32, cnt [n, n] f32;
// out [n, heads, head_dim] f32, lse [n, heads] f32; head_dim <= 64
// (bignn_tpu_torch/ops/flash_gat.py checks it). Returns cudaGetLastError().
int bignn_flash_gat_fwd_f32(const void* score_l, const void* score_r,
                            const void* v, const void* cnt, int n, int heads,
                            int head_dim, float slope, void* out, void* lse,
                            void* stream) {
  if (n > 0 && heads > 0 && head_dim > 0 && head_dim <= kMaxHeadDim) {
    const dim3 grid((n + kRows - 1) / kRows, heads);
    flash_gat_fwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(score_l), static_cast<const float*>(score_r),
        static_cast<const float*>(v), static_cast<const float*>(cnt), n, heads,
        head_dim, slope, static_cast<float*>(out), static_cast<float*>(lse));
  } else if (n > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
