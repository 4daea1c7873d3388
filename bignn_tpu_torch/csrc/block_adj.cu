// Block-diagonal adjacency of a block-local edge list:
//   A[b, d, s] = sum_e w_e * [dst_e == 128 b + d] * [src_e == 128 b + s],
// or the edge multiplicity when no weights are given, stored as float32,
// bf16, int8 or int16.
//
// Replaces bignn_tpu/ops/pallas/block_adj.py:_block_adj_kernel
// (build_block_adj). On the TPU each 128-row block is a one-hot matmul
// OH_dst @ OH_src^T on the MXU, accumulated in float32 and cast to the
// output type; here nothing needs a matrix unit, because a block holds only
// a few hundred edges. As there, counts are exact (integers), and a weighted
// bf16 build rounds each weight to bf16 before the float32 sum
// (block_adj.py:187-189), then rounds the sum once.
//
// Design: one thread block per 128-row block b, one thread per destination
// row d. The block accumulates its 128 x 128 tile in shared memory (float32
// for weights, int32 for counts; rows padded to 129 words, so the threads'
// rows fall in different banks), every thread walking the block's edge
// range [estarts[b], estarts[b+1]) and adding the edges whose destination
// is its own row. A row has one owner, so there are no atomics, and the
// sum runs in edge order: a result is the same from run to run. The edge
// reads are the same address across the block, which the hardware
// broadcasts. Then the block stores the tile in the output type with
// coalesced stores.
//
// What bounds it on the H100: the tile stores, nblk * 16384 * sizeof(out)
// bytes (64 KiB a block in float32, 16 KiB in int8: config4's int8 count
// adjacency is 3,504 blocks, 57 MB); the edge list is a few KiB per block.
// Padding edges (dst == num_nodes) and edges whose source lies outside the
// block add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockRows = 128;
constexpr int kStride = kBlockRows + 1;  // shared-memory row, in words
constexpr int kSmemBytes = kBlockRows * kStride * 4;

template <class Out, class Acc>
__device__ __forceinline__ Out narrow(Acc v) {
  return static_cast<Out>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

// Acc: float (weights, or counts stored as a float type) or int (counts
// stored as int8/int16). bf16_weights: round each weight to bf16 first.
template <class Acc, class Out>
__global__ void __launch_bounds__(kBlockRows)
    block_adj(const int* __restrict__ src, const int* __restrict__ dst,
              const float* __restrict__ weight,
              const int* __restrict__ estarts, int num_edges,
              bool bf16_weights, Out* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* tile = reinterpret_cast<Acc*>(smem);
  const int b = blockIdx.x;
  const int d = threadIdx.x;
  Acc* row = tile + d * kStride;
  for (int s = 0; s < kBlockRows; ++s) row[s] = Acc(0);

  const int row0 = b * kBlockRows;
  const int e0 = max(0, min(estarts[b], num_edges));
  const int e1 = max(e0, min(estarts[b + 1], num_edges));
  for (int e = e0; e < e1; ++e) {
    if (__ldg(dst + e) - row0 != d) continue;
    const int s = __ldg(src + e) - row0;
    if (s < 0 || s >= kBlockRows) continue;
    if (weight == nullptr) {
      row[s] += Acc(1);
    } else {
      const float w = __ldg(weight + e);
      row[s] += bf16_weights ? __bfloat162float(__float2bfloat16_rn(w)) : w;
    }
  }
  __syncthreads();  // every row is complete before any is stored

  Out* o = out + static_cast<int64_t>(b) * kBlockRows * kBlockRows;
  for (int r = 0; r < kBlockRows; ++r)
    o[r * kBlockRows + d] = narrow<Out>(tile[r * kStride + d]);
}

template <class Acc, class Out>
int launch(const void* src, const void* dst, const void* weight,
           const void* estarts, int num_edges, int num_blocks,
           bool bf16_weights, void* out, void* stream) {
  if (num_blocks <= 0) return static_cast<int>(cudaGetLastError());
  static bool attribute_set = false;  // above 48 KiB needs an opt-in
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_adj<Acc, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  block_adj<Acc, Out><<<num_blocks, kBlockRows, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const float*>(weight), static_cast<const int*>(estarts),
      num_edges, bf16_weights, static_cast<Out*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src/dst [num_edges] int32 (dst-sorted, block-local), weight [num_edges] f32
// or null, estarts [num_blocks + 1] int32, out [num_blocks, 128, 128] of the
// entry point's type. Returns cudaGetLastError().
int bignn_block_adj_f32(const void* src, const void* dst, const void* weight,
                        const void* estarts, int num_edges, int num_blocks,
                        void* out, void* stream) {
  return launch<float, float>(src, dst, weight, estarts, num_edges,
                              num_blocks, false, out, stream);
}

// bf16 output; weights rounded to bf16 before the float32 sum.
int bignn_block_adj_bf16(const void* src, const void* dst, const void* weight,
                         const void* estarts, int num_edges, int num_blocks,
                         void* out, void* stream) {
  return launch<float, __nv_bfloat16>(src, dst, weight, estarts, num_edges,
                                      num_blocks, true, out, stream);
}

// Counts only (weight must be null), int32 sums stored as int8 / int16: the
// caller keeps every multiplicity in range (config4: at most r_node^2 = 16).
int bignn_block_adj_int8(const void* src, const void* dst, const void* weight,
                         const void* estarts, int num_edges, int num_blocks,
                         void* out, void* stream) {
  if (weight != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int, int8_t>(src, dst, nullptr, estarts, num_edges,
                             num_blocks, false, out, stream);
}

int bignn_block_adj_int16(const void* src, const void* dst,
                          const void* weight, const void* estarts,
                          int num_edges, int num_blocks, void* out,
                          void* stream) {
  if (weight != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int, int16_t>(src, dst, nullptr, estarts, num_edges,
                              num_blocks, false, out, stream);
}

}  // extern "C"
