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
//
// Design: the TPU kernel walks source blocks in order and keeps dsl
// resident in VMEM across its sequential grid, which blocks running in
// parallel cannot do. Here two kernels, launched one after the other by one
// entry point, each own what they write, so no float atomics are needed
// and a result repeats bit for bit:
//   rows:    a block owns kTile destination rows of one head (grid
//            (N / kTile, H), the forward's layout) and sweeps every source
//            in chunks of kChunk, staging the cnt tile, score_r and v in
//            shared memory; it writes dsl.
//   columns: a block owns kTile source columns of one head and sweeps every
//            destination in chunks of kChunk, staging the cnt tile, g,
//            score_l, lse and delta; it writes dsr and dv (alpha goes
//            through shared memory to the alpha^T g product).
// Each thread of a block handles kPerThread pairs of one owned row (or
// column) per chunk, strided by kParts so that a warp reads consecutive g/v
// rows; g and v tiles are padded to kPad floats a row against bank
// conflicts. Partial sums are combined in a fixed order.
//
// What bounds it on the H100: both kernels recompute g . v, so at N=1704,
// H=4, D=32 each does N^2 * H * D = 0.37 G FMAs (the column kernel twice
// that, with alpha^T g) out of shared memory, plus N^2 * H exps: 428 blocks
// of 4 warps, latency of the staged loads and of two barriers a chunk. The
// price of holding no [N, N, H] tensor, as on the TPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;     // rows (or columns) a block owns
constexpr int kChunk = 64;    // sources (or destinations) per stage
constexpr int kThreads = 128;
constexpr int kParts = kThreads / kTile;           // 8 threads per owned row
constexpr int kPerThread = kChunk / kParts;        // 8 pairs each per chunk
constexpr int kOwnedPerWarp = kTile / (kThreads / 32);  // 4
constexpr int kMaxHeadDim = 64;
constexpr int kPad = kMaxHeadDim + 1;
// row strides of the cnt / alpha tiles: a warp's 8 parts x 4 owned rows (or
// columns) then fall on 32 different banks
constexpr int kRowStride = kChunk + 8;
constexpr int kColStride = kTile + 4;
constexpr int kColsPerLane = kMaxHeadDim / 32;
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

// alpha and d_z of one (d, s) pair, as _bwd_kernel computes them
__device__ __forceinline__ float pair_dz(float c, float sl, float sr,
                                         float lse, float delta, float dot,
                                         float slope, float* alpha) {
  const float z = sl + sr;
  const float e = c > 0.f ? (z > 0.f ? z : slope * z) : kNeg;
  const float a = c * expf(fminf(e - lse, 0.f));
  const float de = a * (dot - delta);
  *alpha = a;
  return z > 0.f ? de : slope * de;
}

// rows [r0, r0 + count) of x[:, h, :] into tile[count][kPad], zero past n
__device__ __forceinline__ void stage_rows(float (*tile)[kPad],
                                           const float* __restrict__ x,
                                           int r0, int count,
                                           const Inputs& in, int h) {
  const int cols = in.heads * in.head_dim;
  for (int i = threadIdx.x; i < count * in.head_dim; i += kThreads) {
    const int r = i / in.head_dim, c = i % in.head_dim;
    tile[r][c] = r0 + r < in.n
        ? x[static_cast<int64_t>(r0 + r) * cols + h * in.head_dim + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_gat_bwd_rows(Inputs in, float* __restrict__ dsl) {
  __shared__ float s_cnt[kTile][kRowStride];
  __shared__ float s_sr[kChunk];
  __shared__ float s_v[kChunk][kPad];
  __shared__ float s_g[kTile][kPad];
  __shared__ float s_part[kTile][kParts];

  const int tid = threadIdx.x, h = blockIdx.y;
  const int d0 = blockIdx.x * kTile;
  const int r = tid / kParts, part = tid % kParts;
  const int d = d0 + r;
  const bool live = d < in.n;
  const float sl = live ? in.score_l[d * in.heads + h] : 0.f;
  const float lse = live ? in.lse[d * in.heads + h] : kNeg;
  const float delta = live ? in.delta[d * in.heads + h] : 0.f;
  stage_rows(s_g, in.g, d0, kTile, in, h);

  float acc = 0.f;
  for (int s0 = 0; s0 < in.n; s0 += kChunk) {
    for (int i = tid; i < kTile * kChunk; i += kThreads) {
      const int rr = i / kChunk, j = i % kChunk;
      s_cnt[rr][j] = (d0 + rr < in.n && s0 + j < in.n)
          ? in.cnt[static_cast<int64_t>(d0 + rr) * in.n + s0 + j] : 0.f;
    }
    for (int j = tid; j < kChunk; j += kThreads) {
      s_sr[j] = s0 + j < in.n ? in.score_r[(s0 + j) * in.heads + h] : 0.f;
    }
    stage_rows(s_v, in.v, s0, kChunk, in, h);
    __syncthreads();
    float dot[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) dot[q] = 0.f;
    for (int k = 0; k < in.head_dim; ++k) {
      const float gk = s_g[r][k];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        dot[q] += gk * s_v[part + kParts * q][k];
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int j = part + kParts * q;
      float alpha;
      acc += pair_dz(s_cnt[r][j], sl, s_sr[j], lse, delta, dot[q], in.slope,
                     &alpha);
    }
    __syncthreads();
  }

  s_part[r][part] = acc;
  __syncthreads();
  if (tid < kTile && d0 + tid < in.n) {
    float sum = 0.f;
    for (int p = 0; p < kParts; ++p) sum += s_part[tid][p];
    dsl[(d0 + tid) * in.heads + h] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_gat_bwd_cols(Inputs in, float* __restrict__ dsr,
                       float* __restrict__ dv) {
  __shared__ float s_cnt[kChunk][kColStride];
  __shared__ float s_alpha[kChunk][kColStride];
  __shared__ float s_g[kChunk][kPad];
  __shared__ float s_sl[kChunk];
  __shared__ float s_lse[kChunk];
  __shared__ float s_delta[kChunk];
  __shared__ float s_v[kTile][kPad];
  __shared__ float s_part[kTile][kParts];

  const int tid = threadIdx.x, h = blockIdx.y;
  const int s0 = blockIdx.x * kTile;
  const int c = tid / kParts, part = tid % kParts;
  const int s = s0 + c;
  const float sr = s < in.n ? in.score_r[s * in.heads + h] : 0.f;
  const int warp = tid / 32, lane = tid % 32;
  stage_rows(s_v, in.v, s0, kTile, in, h);

  float acc = 0.f;
  float acc_v[kOwnedPerWarp][kColsPerLane];
#pragma unroll
  for (int w = 0; w < kOwnedPerWarp; ++w)
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) acc_v[w][k] = 0.f;

  for (int d0 = 0; d0 < in.n; d0 += kChunk) {
    for (int i = tid; i < kChunk * kTile; i += kThreads) {
      const int ii = i / kTile, j = i % kTile;
      s_cnt[ii][j] = (d0 + ii < in.n && s0 + j < in.n)
          ? in.cnt[static_cast<int64_t>(d0 + ii) * in.n + s0 + j] : 0.f;
    }
    for (int i = tid; i < kChunk; i += kThreads) {
      const bool ok = d0 + i < in.n;
      const int at = (d0 + i) * in.heads + h;
      s_sl[i] = ok ? in.score_l[at] : 0.f;
      s_lse[i] = ok ? in.lse[at] : kNeg;
      s_delta[i] = ok ? in.delta[at] : 0.f;
    }
    stage_rows(s_g, in.g, d0, kChunk, in, h);
    __syncthreads();
    float dot[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) dot[q] = 0.f;
    for (int k = 0; k < in.head_dim; ++k) {
      const float vk = s_v[c][k];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        dot[q] += s_g[part + kParts * q][k] * vk;
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = part + kParts * q;
      float alpha;
      acc += pair_dz(s_cnt[i][c], s_sl[i], sr, s_lse[i], s_delta[i], dot[q],
                     in.slope, &alpha);
      s_alpha[i][c] = alpha;
    }
    __syncthreads();
    // dv[s, :] += sum_d alpha[d, s] g[d, :]: a warp owns 4 columns, a lane
    // one or two of the head's features
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int f = lane + 32 * k;
      if (f < in.head_dim) {
#pragma unroll
        for (int w = 0; w < kOwnedPerWarp; ++w) {
          const int col = warp * kOwnedPerWarp + w;
          float a = acc_v[w][k];
#pragma unroll 16
          for (int i = 0; i < kChunk; ++i) a += s_alpha[i][col] * s_g[i][f];
          acc_v[w][k] = a;
        }
      }
    }
    __syncthreads();
  }

  s_part[c][part] = acc;
  __syncthreads();
  if (tid < kTile && s0 + tid < in.n) {
    float sum = 0.f;
    for (int p = 0; p < kParts; ++p) sum += s_part[tid][p];
    dsr[(s0 + tid) * in.heads + h] = sum;
  }
  const int cols = in.heads * in.head_dim;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int f = lane + 32 * k;
    if (f < in.head_dim) {
#pragma unroll
      for (int w = 0; w < kOwnedPerWarp; ++w) {
        const int col = s0 + warp * kOwnedPerWarp + w;
        if (col < in.n) {
          dv[static_cast<int64_t>(col) * cols + h * in.head_dim + f] =
              acc_v[w][k];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// score_l/score_r/lse/delta [n, heads] f32, v/g [n, heads, head_dim] f32,
// cnt [n, n] f32; dsl/dsr [n, heads] f32, dv [n, heads, head_dim] f32;
// head_dim <= 64 (bignn_tpu_torch/ops/flash_gat.py checks it). Launches the
// row and the column kernel on the stream; returns cudaGetLastError().
int bignn_flash_gat_bwd_f32(const void* score_l, const void* score_r,
                            const void* v, const void* cnt, const void* lse,
                            const void* delta, const void* g, int n,
                            int heads, int head_dim, float slope, void* dsl,
                            void* dsr, void* dv, void* stream) {
  if (n > 0 && heads > 0 && head_dim > 0 && head_dim <= kMaxHeadDim) {
    const Inputs in{static_cast<const float*>(score_l),
                    static_cast<const float*>(score_r),
                    static_cast<const float*>(v),
                    static_cast<const float*>(cnt),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<const float*>(g),
                    n, heads, head_dim, slope};
    const dim3 grid((n + kTile - 1) / kTile, heads);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    flash_gat_bwd_rows<<<grid, kThreads, 0, st>>>(in,
                                                  static_cast<float*>(dsl));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_gat_bwd_cols<<<grid, kThreads, 0, st>>>(
        in, static_cast<float*>(dsr), static_cast<float*>(dv));
  } else if (n > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
