// Block-diagonal adjacency of a block-local edge list:
//   A[b, d, s] = sum_e w_e * [dst_e == 128 b + d] * [src_e == 128 b + s],
// or the edge multiplicity when no weights are given, stored as float32,
// bf16, int8 or int16.
//
// Replaces bignn_tpu/ops/pallas/block_adj.py:_block_adj_kernel
// (build_block_adj). On the TPU each 128-row block is a one-hot matmul
// OH_dst @ OH_src^T on the MXU, accumulated in float32 and cast to the
// output type; here nothing needs a matrix unit, because a block holds only
// a few thousand edges. As there, counts are exact (integers), and a
// weighted bf16 build rounds each weight to bf16 before the float32 sum
// (block_adj.py:187-189), then rounds the sum once.
//
// What bounds it on the H100: the tile stores, nblk * 16384 * sizeof(out)
// bytes (config4's int8 count adjacency is 3,504 blocks, 57 MB: 0.017 ms
// at 3.35 TB/s), and one read of the edge list (config4's batch: an
// edge_cap of 1,659,904 edges with their padding, 13 MB, about 474 edges a
// block and 4 a row). Padding edges (dst == num_nodes, which lie inside a
// block's range between molecules: ROADMAP F1) and edges whose source lies
// outside the block add nothing.
//
// Design: one thread block of kThreads per 128-row block b; its tile lives
// in shared memory laid out as the output block, and goes out in 16-byte
// stores. The block's threads stride over its edge range [estarts[b],
// estarts[b+1]) once, an edge a thread (the port's first kernel had every
// one of 128 threads walk the whole range to pick out its own row's ~9
// edges, 128 times the loads and 66 KB of shared memory a block).
//   counts: each in-block edge adds 1 to its cell with a shared-memory
//     integer atomicAdd, exact in any order. The tile holds the narrowest
//     type that holds the sums: int8 cells packed four to a 32-bit word and
//     int16 two (16 KB and 32 KB a block), int32 for a float output (64
//     KB). The caller keeps every count in range (config4's at most
//     r_node^2 <= 127): a cell past 255 (int8) or 65,535 (int16) carries
//     into its neighbour in the word, and corrupts that cell too.
//   weights: a float sum must keep its order. A first pass takes each local
//     destination's first and last edge with shared-memory integer
//     atomicMin / atomicMax, only where a run of equal destinations begins
//     or ends (the device-memory pass of segment_bounds.cuh, on the block's
//     range); then the thread of row d walks [first[d], last[d]] in edge
//     order, skipping the edges of other rows (holes), and adds into its
//     float32 row. Each cell then sums its edges in the order the port's
//     first kernel did, so a result has its bits, run after run.
// No float atomics anywhere.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; device ms of a call from
// scripts/compare_kernel_trees.py, the port's first kernel in brackets):
// int8 counts at config4's batch (3,504 blocks) 0.0292 (0.389; bound
// 0.0211 by bytes), int16 0.0483 (0.393; 0.0382), bf16 weights 0.080
// (0.451; 0.0402), float32 counts over config2's 4 buckets 0.020-0.023 for
// the 4 calls (0.149-0.156; 0.0087). Both weighted forms keep the first
// kernel's bits. scripts/probe_variants.py (kind adj): 128, 256 and 512
// threads a block time int8 0.0283, 0.0291, 0.0292 and bf16 weights 0.088,
// 0.080, 0.079.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int kBlockRows = 128;
constexpr int kCells = kBlockRows * kBlockRows;
constexpr int kThreads = 256;

template <class Out>
__device__ __forceinline__ Out narrow(float v) {
  return static_cast<Out>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void zero_words(uint4* tile, int words) {
  for (int i = threadIdx.x; i < words; i += kThreads)
    tile[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Block b's tile [128 x 128] of Acc (int counts or float sums) to its output
// block in Out, 16 bytes a store.
template <class Out, class Acc>
__device__ __forceinline__ void store_converted(const Acc* __restrict__ tile,
                                                Out* __restrict__ o) {
  constexpr int kPerWord = 16 / sizeof(Out);
  constexpr int kLoads = kPerWord * sizeof(Acc) / 16;
  const uint4* t4 = reinterpret_cast<const uint4*>(tile);
  uint4* o4 = reinterpret_cast<uint4*>(o);
  for (int i = threadIdx.x; i < kCells / kPerWord; i += kThreads) {
    uint4 in[kLoads];
#pragma unroll
    for (int c = 0; c < kLoads; ++c) in[c] = t4[i * kLoads + c];
    const Acc* a = reinterpret_cast<const Acc*>(in);
    __align__(16) Out v[kPerWord];
#pragma unroll
    for (int j = 0; j < kPerWord; ++j) v[j] = narrow<Out>(float(a[j]));
    o4[i] = *reinterpret_cast<const uint4*>(v);
  }
}

// The clamped edge range of block b.
__device__ __forceinline__ int2 edge_range(const int* __restrict__ estarts,
                                           int num_edges) {
  const int b = blockIdx.x;
  const int e0 = max(0, min(estarts[b], num_edges));
  const int e1 = max(e0, min(estarts[b + 1], num_edges));
  return make_int2(e0, e1);
}

// Count cells sharing a 32-bit word of the shared tile: 4 for int8, 2 for
// int16, 1 (int32) for a float output.
template <class Out>
constexpr int kPackOf = std::is_integral_v<Out> ? 4 / sizeof(Out) : 1;

template <class Out>
__global__ void __launch_bounds__(kThreads)
    block_counts(const int* __restrict__ src, const int* __restrict__ dst,
                 const int* __restrict__ estarts, int num_edges,
                 Out* __restrict__ out) {
  constexpr int kPack = kPackOf<Out>;
  constexpr int kBits = 32 / kPack;
  extern __shared__ uint4 smem[];
  unsigned* tile = reinterpret_cast<unsigned*>(smem);
  zero_words(smem, kCells / kPack / 4);
  __syncthreads();

  const int row0 = blockIdx.x * kBlockRows;
  const int2 r = edge_range(estarts, num_edges);
  for (int e = r.x + threadIdx.x; e < r.y; e += kThreads) {
    const unsigned d = static_cast<unsigned>(__ldg(dst + e) - row0);
    const unsigned s = static_cast<unsigned>(__ldg(src + e) - row0);
    if (d < kBlockRows && s < kBlockRows) {
      const unsigned cell = d * kBlockRows + s;
      atomicAdd(tile + cell / kPack, 1u << (kBits * (cell % kPack)));
    }
  }
  __syncthreads();  // every count is in before any is stored

  Out* o = out + static_cast<int64_t>(blockIdx.x) * kCells;
  if constexpr (kPack > 1) {
    // the packed words are the output's bytes, in order (little-endian)
    const uint4* t4 = smem;
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int i = threadIdx.x; i < kCells / kPack / 4; i += kThreads)
      o4[i] = t4[i];
  } else {
    store_converted<Out>(reinterpret_cast<const int*>(tile), o);
  }
}

// Weighted sums, each cell in edge order. bf16_weights: round each weight
// to bf16 first.
template <class Out, bool bf16_weights>
__global__ void __launch_bounds__(kThreads)
    block_weights(const int* __restrict__ src, const int* __restrict__ dst,
                  const float* __restrict__ weight,
                  const int* __restrict__ estarts, int num_edges,
                  Out* __restrict__ out) {
  extern __shared__ uint4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  int* first = reinterpret_cast<int*>(tile + kCells);
  int* last = first + kBlockRows;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBlockRows;
  const int2 r = edge_range(estarts, num_edges);
  zero_words(smem, kCells / 4);
  for (int d = tid; d < kBlockRows; d += kThreads) {
    first[d] = INT_MAX;
    last[d] = -1;
  }
  __syncthreads();

  // each local destination's first and last edge; atomics only at the ends
  // of runs (the whole block's trip count is the same: whole warps shuffle)
  const int lane = tid % 32;
  for (int base = r.x; base < r.y; base += kThreads) {
    const int e = base + tid;
    const int d = e < r.y ? __ldg(dst + e) - row0 : -1;
    int prev = __shfl_up_sync(0xffffffffu, d, 1);
    int next = __shfl_down_sync(0xffffffffu, d, 1);
    if (e < r.y && static_cast<unsigned>(d) < kBlockRows) {
      if (lane == 0 && e > r.x) prev = __ldg(dst + e - 1) - row0;
      if (lane == 31 && e + 1 < r.y) next = __ldg(dst + e + 1) - row0;
      if (e == r.x || prev != d) atomicMin(first + d, e);
      if (e == r.y - 1 || next != d) atomicMax(last + d, e);
    }
  }
  __syncthreads();

  for (int d = tid; d < kBlockRows; d += kThreads) {
    float* row = tile + d * kBlockRows;
    const int e_end = last[d];
    for (int e = first[d]; e <= e_end; ++e) {
      if (__ldg(dst + e) - row0 != d) continue;  // a hole: another row's edge
      const int s = __ldg(src + e) - row0;
      if (static_cast<unsigned>(s) >= kBlockRows) continue;
      const float w = __ldg(weight + e);
      row[s] += bf16_weights ? __bfloat162float(__float2bfloat16_rn(w)) : w;
    }
  }
  __syncthreads();  // every row is complete before any is stored

  store_converted<Out>(tile, out + static_cast<int64_t>(blockIdx.x) * kCells);
}

template <class Out, bool bf16_weights>
int launch(const void* src, const void* dst, const void* weight,
           const void* estarts, int num_edges, int num_blocks, void* out,
           void* stream) {
  if (std::is_integral_v<Out> && weight != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);  // int8/int16: counts
  }
  if (num_blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // 16-byte stores
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const int* es = static_cast<const int*>(estarts);
  Out* o = static_cast<Out*>(out);
  if (weight == nullptr) {
    constexpr int kBytes = kCells * 4 / kPackOf<Out>;
    static int done[bignn::kMaxDevices] = {};
    const cudaError_t set = bignn::allow_smem(block_counts<Out>, kBytes, done);
    if (set != cudaSuccess) return static_cast<int>(set);
    block_counts<Out><<<num_blocks, kThreads, kBytes, st>>>(s, d, es,
                                                            num_edges, o);
  } else if constexpr (!std::is_integral_v<Out>) {
    constexpr int kBytes = kCells * 4 + 2 * kBlockRows * 4;
    static int done[bignn::kMaxDevices] = {};
    const cudaError_t set =
        bignn::allow_smem(block_weights<Out, bf16_weights>, kBytes, done);
    if (set != cudaSuccess) return static_cast<int>(set);
    block_weights<Out, bf16_weights><<<num_blocks, kThreads, kBytes, st>>>(
        s, d, static_cast<const float*>(weight), es, num_edges, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src/dst [num_edges] int32 (dst-sorted, block-local), weight [num_edges] f32
// or null, estarts [num_blocks + 1] int32, out [num_blocks, 128, 128] of the
// entry point's type, 16-byte aligned. Returns cudaGetLastError().
int bignn_block_adj_f32(const void* src, const void* dst, const void* weight,
                        const void* estarts, int num_edges, int num_blocks,
                        void* out, void* stream) {
  return launch<float, false>(src, dst, weight, estarts, num_edges,
                              num_blocks, out, stream);
}

// bf16 output; weights rounded to bf16 before the float32 sum.
int bignn_block_adj_bf16(const void* src, const void* dst, const void* weight,
                         const void* estarts, int num_edges, int num_blocks,
                         void* out, void* stream) {
  return launch<__nv_bfloat16, true>(src, dst, weight, estarts, num_edges,
                                     num_blocks, out, stream);
}

// Counts only (weight must be null), stored as int8 / int16: the caller
// keeps every multiplicity in range (config4: at most r_node^2 = 16). The
// kernel does not check it: int8 and int16 cells share 32-bit words, so a
// count past 255 / 65,535 carries into the next cell of its word.
int bignn_block_adj_int8(const void* src, const void* dst, const void* weight,
                         const void* estarts, int num_edges, int num_blocks,
                         void* out, void* stream) {
  return launch<int8_t, false>(src, dst, weight, estarts, num_edges,
                               num_blocks, out, stream);
}

int bignn_block_adj_int16(const void* src, const void* dst,
                          const void* weight, const void* estarts,
                          int num_edges, int num_blocks, void* out,
                          void* stream) {
  return launch<int16_t, false>(src, dst, weight, estarts, num_edges,
                                num_blocks, out, stream);
}

}  // extern "C"
