// Block-local SpMM, for float32 or bf16 rows (float32 weights, float32 sums,
// one rounding at the store): in the block-local layout every molecule lies
// inside one 128-row block, so the aggregation of block b reads only block
// b's rows of x:
//   y[128 b + d, :] = sum_{e in [starts[b], starts[b+1]): dst_e = 128 b + d,
//                     src_e in [128 b, 128 b + 128)} w_e x[src_e, :]
// with w_e = 1 when no weights are given. An edge whose source or destination
// lies outside its block is dropped, as the one-hot masks of the TPU kernel
// drop it; padding edges (dst == N) lie outside every block.
//
// Replaces bignn_tpu/ops/pallas/block_spmm.py:_block_spmm_kernel
// (block_spmm, _block_spmm_impl), forward and backward: the VJP is this same
// kernel on the transposed (source-sorted) plan (tsrc, tdst, tweight,
// tstarts), as there. The TPU kernel multiplies one-hot matrices on the MXU
// over programs of 512 rows and pads F to 128; none of that carries over: a
// block holds a few hundred edges, and a warp can sum them directly.
// bf16 rounding as the TPU kernel's (block_spmm.py:142-144): the weight is
// rounded to bf16 and so is each weighted message w_e x[s], before the
// float32 sum (:154-162); unweighted messages are the bf16 rows themselves.
// For float32 both roundings are the identity.
//
// Design: one CTA (8 warps) per 128-row block.
//   1. The CTA stages x's 128 rows of the block in shared memory, widened to
//      float32 (128 * F * 4 bytes: 64 KiB at F = 128, so the kernel opts in
//      to more than 48 KiB of dynamic shared memory), and sets each row's
//      edge bounds to empty. Rows are read 16 bytes at a time (4 floats or 8
//      bf16) where F and x's alignment allow it.
//   2. Its threads walk the block's edge range once and bound each
//      destination row's edges by integer atomicMin / atomicMax in shared
//      memory (exact, so independent of their order).
//   3. One warp per destination row walks [first, last] in edge order,
//      skipping other rows' edges, and sums w_e * x_smem[src_e - 128 b] in
//      registers, lanes across F (a lane holds columns lane + 32 k, so the
//      lanes read consecutive shared-memory words, free of bank conflicts).
//      The row is stored once. No float atomics: a result repeats bit for
//      bit.
//
// What bounds it on the H100: device-memory bytes. x is read once (each block
// stages its own rows), the edge list once (plus once more for the bounds
// pass, from L2), y written once: N * F * 2 * sizeof(T) + E * 12 bytes. The
// gathers of x rows, which the edge-list form makes from device memory, come
// from shared memory here.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "elem.cuh"

namespace {

constexpr int kBlockRows = 128;
constexpr int kWarps = 8;
constexpr int kMaxFeat = 256;
constexpr int kColsPerLane = kMaxFeat / 32;
constexpr int kBoundsBytes = 2 * kBlockRows * 4;
constexpr unsigned kFull = 0xffffffffu;

// VEC: values of x a thread stages per load (16 bytes: 4 floats or 8 bf16;
// 1 where F or x's alignment does not allow it).
template <class T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    block_spmm(const T* __restrict__ x, const int* __restrict__ src,
               const int* __restrict__ dst, const float* __restrict__ weight,
               const int* __restrict__ starts, int num_edges, int feat,
               T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // [128, feat]
  int* first = reinterpret_cast<int*>(smem + kBlockRows * feat);  // [128]
  int* last = first + kBlockRows;                                  // [128]
  const int b = blockIdx.x;
  const int row0 = b * kBlockRows;
  const int tid = threadIdx.x;

  // 1. stage the block's rows of x, widened; empty bounds
  const T* xb = x + static_cast<int64_t>(row0) * feat;
  const int count = kBlockRows * feat;
  for (int i = tid * VEC; i < count; i += blockDim.x * VEC)
    bignn::load_vec<VEC>(xb + i, xs + i);
  for (int d = tid; d < kBlockRows; d += blockDim.x) {
    first[d] = INT_MAX;
    last[d] = -1;
  }
  __syncthreads();

  // 2. each destination row's edge bounds within the block's range
  const int e0 = max(0, min(starts[b], num_edges));
  const int e1 = max(e0, min(starts[b + 1], num_edges));
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    const int d = __ldg(dst + e) - row0;
    if (d >= 0 && d < kBlockRows) {
      atomicMin(first + d, e);
      atomicMax(last + d, e);
    }
  }
  __syncthreads();

  // 3. one warp per destination row
  const int lane = tid % 32;
  for (int d = tid / 32; d < kBlockRows; d += kWarps) {
    float acc[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
    const int i0 = first[d];
    const int i1 = last[d];
    for (int base = i0; base <= i1; base += 32) {
      const int e = base + lane;
      int s = -1;
      float w = 0.f;
      if (e <= i1 && __ldg(dst + e) - row0 == d) {
        const int sl = __ldg(src + e) - row0;
        if (sl >= 0 && sl < kBlockRows) {  // an out-of-block source drops
          s = sl;
          w = weight == nullptr ? 1.f : bignn::round_to<T>(__ldg(weight + e));
        }
      }
      const int n = min(32, i1 - base + 1);
      for (int j = 0; j < n; ++j) {
        const int sj = __shfl_sync(kFull, s, j);
        const float wj = __shfl_sync(kFull, w, j);
        if (sj < 0) continue;
        const float* xr = xs + sj * feat;
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = lane + 32 * k;
          if (c < feat) acc[k] += bignn::round_to<T>(wj * xr[c]);
        }
      }
    }
    T* o = out + static_cast<int64_t>(row0 + d) * feat;
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < feat) o[c] = bignn::from_f32<T>(acc[k]);
    }
  }
}

template <class T, int VEC>
int launch(const void* x, const void* src, const void* dst,
           const void* weight, const void* starts, int num_edges,
           int num_blocks, int feat, void* out, cudaStream_t st) {
  const int smem = kBlockRows * feat * 4 + kBoundsBytes;
  // above 48 KiB needs an opt-in, per device: set it on every call
  const cudaError_t err = cudaFuncSetAttribute(
      block_spmm<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_spmm<T, VEC><<<num_blocks, kWarps * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const float*>(weight),
      static_cast<const int*>(starts), num_edges, feat, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int block_spmm_rows(const void* x, const void* src, const void* dst,
                    const void* weight, const void* starts, int num_edges,
                    int num_blocks, int feat, void* out, void* stream) {
  if (num_edges < 0 || num_blocks < 0 || feat < 0 || feat > kMaxFeat)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_blocks == 0 || feat == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads: a block's rows start 128 * F values after x, so they are
  // aligned when x is and F is a multiple of kWide
  constexpr int kWide = 16 / sizeof(T);
  if (feat % kWide == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<T, kWide>(x, src, dst, weight, starts, num_edges,
                            num_blocks, feat, out, st);
  return launch<T, 1>(x, src, dst, weight, starts, num_edges, num_blocks,
                      feat, out, st);
}

}  // namespace

extern "C" {

// x [num_blocks * 128, feat] f32 or bf16 (feat <= 256), src/dst [num_edges]
// int32 (dst-sorted, block-local), weight [num_edges] f32 or null, starts
// [num_blocks + 1] int32 (block b's edges are [starts[b], starts[b+1])), out
// like x. The backward passes the cotangent as x and the transposed plan.
// Returns cudaGetLastError().
int bignn_block_spmm_f32(const void* x, const void* src, const void* dst,
                         const void* weight, const void* starts,
                         int num_edges, int num_blocks, int feat, void* out,
                         void* stream) {
  return block_spmm_rows<float>(x, src, dst, weight, starts, num_edges,
                                num_blocks, feat, out, stream);
}

int bignn_block_spmm_bf16(const void* x, const void* src, const void* dst,
                          const void* weight, const void* starts,
                          int num_edges, int num_blocks, int feat, void* out,
                          void* stream) {
  return block_spmm_rows<__nv_bfloat16>(x, src, dst, weight, starts,
                                        num_edges, num_blocks, feat, out,
                                        stream);
}

}  // extern "C"
