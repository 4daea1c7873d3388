// Block-diagonal adjacency of a block-local edge list:
//   A[b, d, s] = sum_e w_e * [dst_e == 128 b + d] * [src_e == 128 b + s],
// or the edge multiplicity when no weights are given.
//
// Replaces bignn_tpu/ops/pallas/block_adj.py:_block_adj_kernel
// (build_block_adj). On the TPU each 128-row block is a one-hot matmul
// OH_dst @ OH_src^T on the MXU; here nothing needs a matrix unit, because a
// block holds only a few hundred edges.
//
// Design: one thread block per 128-row block b, one thread per destination
// row d. The block first zeroes its 128 x 128 tile with coalesced stores,
// then every thread walks the block's edge range [estarts[b], estarts[b+1])
// and adds the edges whose destination is its own row. A row has one
// owner, so there are no atomics, and the sum runs in edge order: the
// weighted form is the same from run to run. The edge reads are the same
// address across the block, which the hardware broadcasts.
//
// What bounds it on the H100: the tile stores, 64 KiB per block in f32
// (nblk * 64 KiB in all); the edge list is a few KiB per block. Padding
// edges (dst == num_nodes) and edges whose source lies outside the block
// add nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockRows = 128;

__global__ void __launch_bounds__(kBlockRows)
    block_adj(const int* __restrict__ src, const int* __restrict__ dst,
              const float* __restrict__ weight, const int* __restrict__ estarts,
              int num_edges, float* __restrict__ out) {
  const int b = blockIdx.x;
  const int d = threadIdx.x;
  float* tile = out + static_cast<int64_t>(b) * kBlockRows * kBlockRows;
  for (int r = 0; r < kBlockRows; ++r) tile[r * kBlockRows + d] = 0.f;
  __syncthreads();  // the zeroed tile is visible to every row owner

  const int row0 = b * kBlockRows;
  const int e0 = max(0, min(estarts[b], num_edges));
  const int e1 = max(e0, min(estarts[b + 1], num_edges));
  float* row = tile + d * kBlockRows;
  for (int e = e0; e < e1; ++e) {
    if (__ldg(dst + e) - row0 != d) continue;
    const int s = __ldg(src + e) - row0;
    if (s < 0 || s >= kBlockRows) continue;
    row[s] += weight != nullptr ? __ldg(weight + e) : 1.f;
  }
}

}  // namespace

extern "C" {

// src/dst [num_edges] int32 (dst-sorted, block-local), weight [num_edges] f32
// or null, estarts [num_blocks + 1] int32, out [num_blocks, 128, 128] f32.
// Returns cudaGetLastError().
int bignn_block_adj_f32(const void* src, const void* dst, const void* weight,
                        const void* estarts, int num_edges, int num_blocks,
                        void* out, void* stream) {
  if (num_blocks > 0) {
    block_adj<<<num_blocks, kBlockRows, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(src), static_cast<const int*>(dst),
        static_cast<const float*>(weight), static_cast<const int*>(estarts),
        num_edges, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
