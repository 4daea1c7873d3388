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
// (OH_src @ x, then OH_dst @ msgs, bf16 with float32 sums) over programs of
// 512 rows with F padded to 128. Two routes here, by type and weight:
//
// bf16, unweighted: the block product on the tensor cores, one CTA (8
// warps) per 128-row block, 3 CTAs an SM at F 128.
//   1. The CTA first loads the block's edge range and each thread's first
//      two edges, then stages X_b [128, F] in bf16 with 16-byte cp.async
//      copies (single values where F is not a multiple of 8 or x is off 16
//      bytes), F padded to fp, a multiple of 16, with zeros. While the rows
//      land, it zeroes A_b and adds 1 at A_b[d, s] for each edge of the
//      block with bf16 shared-memory atomics: a count is an integer, exact
//      in bf16 up to 256, so the sum does not depend on the order of the
//      atomics. An edge whose source or destination lies outside the block
//      is dropped.
//   2. Its 8 warps multiply A_b by X_b with mma.sync m16n8k16 in tiles of
//      32 rows by 32 columns (4 x 2 over a chunk of 64 columns; ldmatrix
//      from shared memory, each smem row padded by 16 bytes so ldmatrix is
//      free of bank conflicts), float32 accumulators. Each warp skips the
//      16-source slabs of its 32-row band that hold no edge: a molecule's
//      edges stay inside its rows, so a band's edges lie in a few slabs.
//   3. After each chunk the warps round their tiles once to bf16, lay them
//      in X_b's bytes of that chunk (no longer read) and store them 16
//      bytes a lane.
//   - This is JAX's arithmetic: its unweighted bf16 product sums the exact
//     bf16 rows in float32 (one-hot masks are exact in bf16); a count times
//     a bf16 value is exact in float32, so A_b X_b gives the same products
//     in another summation order.
//   - A count above 256 is not exact in bf16. A block where an atomic finds
//     256 already there recounts exactly: 16-bit halves of a word by
//     integer atomics, 65,535 edges a pass (so a half never carries),
//     converted in place to c mod 256, and, in a block with a count of 256
//     or more, a second product of 256 (c div 256) into the same
//     accumulators.
//   - The rows of the slabs a warp multiplies are read whole, so a NaN or
//     Inf in a row that no edge references may reach its block's outputs,
//     as it does in JAX's one-hot product and torch.bmm; the port's layouts
//     pad with zero rows.
//   - Exact atomics and a fixed mma order: a result repeats bit for bit.
//   - Shared memory at F 128: A_b (and the 16-bit counts in its bytes) 34
//     KiB, X_b 34 KiB, and at most 80 registers a thread, so 3 CTAs an SM
//     (2 at F 256).
//   - Measured by scripts/compare_kernel_trees.py and
//     scripts/probe_block_spmm_tc.py (device time of calls queued back to
//     back; NVIDIA H100 80GB HBM3, 700 W) on the 301,312-row bucket of
//     synthetic-large at 16,384 drugs, F 128: 0.065 ms forward and
//     backward, against the walk this route replaced 0.181 ms and
//     torch.bmm over the dense blocks 0.082 ms. Taking out the products
//     leaves 0.060 ms, the counting 0.062: with the edges loaded ahead of
//     the rows, both hide behind the bytes. Earlier forms of this kernel,
//     timed by the same probe: 2 CTAs an SM 0.109 ms, 3 CTAs 0.095;
//     counting in bf16 in place of the 16-bit counts and their conversion
//     0.084; the edges loaded ahead of the rows 0.065.
//
// float32, and weighted bf16: the walk. JAX rounds each weighted bf16
// message w x[s] to bf16 before its sum (block_spmm.py:142-144), which a
// tensor-core product cannot; float32 through TF32 would change its numbers.
// For float32 both roundings are the identity. What held the walk back
// before: rows staged widened to float32 (64 KiB a CTA at F 128, 2-3 CTAs
// an SM, whatever the type), a barrier between the staging and the sums
// with nothing in flight across it, and one edge at a time a warp, handed
// round by two shuffles.
//   1. One CTA (8 warps) per 128-row block. The block's edges land in
//      shared memory by 4-byte cp.async (src, dst, weight; up to kEdgeStage
//      of them, else the walk reads the edge list), and each destination
//      row's edge bounds are found by integer atomicMin / atomicMax in
//      shared memory (exact, so independent of their order; padding edges
//      inside the range are skipped by their dst, F1). 8.5 KiB of shared
//      memory and at most 32 (bf16) or 40 (float32) registers: 8 and 6
//      CTAs an SM.
//   2. Row slots: a destination row takes G lanes, its 16-byte words
//      rounded up to a power of two (bf16 F 128: 16 lanes, 2 rows a warp;
//      float32 F 128: a warp). Each lane reads its row's edges from shared
//      memory itself (no shuffles) and its word of each edge's source row
//      straight from device memory through L1 (a block's rows are read
//      from HBM about once; the other reads of them hit L1 or L2), two
//      edges at once in bf16 and four in float32, and adds the messages in
//      edge order, the weight and each message rounded to T as before, so
//      each form keeps the bits of the walk it replaces (the bf16 products
//      two at a time, elem.cuh add_messages). The row is stored once, 16
//      bytes a lane. No float atomics: a result repeats bit for bit.
//   - Measured by scripts/compare_kernel_trees.py (device time of calls
//     queued back to back; the redesign's chip call 12, PERF.md section
//     6, A B B A against the walk it replaces; NVIDIA H100 80GB HBM3,
//     700.00 W) on the 301,312-row bucket of synthetic-large at 16,384
//     drugs, F 128: bf16 weighted 0.0724 ms forward, 0.0736 backward
//     (before 0.2031, 0.2028; torch.bmm over the dense blocks 0.0815;
//     bound 0.0461), float32 0.1113, 0.1110 (0.1988, 0.1992; bound
//     0.0880), float32 weighted 0.1125, 0.1122 (0.2175, 0.2177); each
//     form with the bits of the walk it replaces.
//   - scripts/probe_variants.py (kind bsw; the redesign's calls 6-12)
//     also timed the block's rows staged in shared memory in their own
//     type by 16-byte cp.async (5 CTAs an SM): 0.081 ms bf16 weighted,
//     0.125 float32; and persistent CTAs loading the next block while
//     summing this one (a two-stage ring, 1-2 CTAs an SM): 0.131, 0.217.
//     The walk's latency needs the warps that staging's shared memory
//     takes away.
//
// Rows wider than 256 (the kTiled forms; F <= 256 keeps the forms above,
// compiled without tiles). Words there are the widest that divide F and on
// which x and out lie (elem.cuh word_values: bf16 F 300 reads 8-byte words,
// 4 values, where a 16-byte word would cross the end of a 600-byte row,
// F6); the tensor-core route stages and stores them by cp.async and plain
// stores of that size.
//   - The walk (float32, weighted bf16): column tiles of at most 256, one a
//     grid row (blockIdx.y), each a CTA of the walk above over its columns,
//     re-reading the block's edges.
//   - The tensor-core product (bf16): one CTA a block counts A_b once and
//     sweeps the row's tiles of kTiledCols (256) columns, each staged whole
//     into one buffer and multiplied in chunks of 64 columns in the same
//     mma.sync order as the untiled form (so a tile's bits are those of a
//     CTA a tile, as before). With A_b that is 100 KiB, 2 CTAs an SM.
//   - F 300 at the 301,312-row bucket (NVIDIA H100 80GB HBM3, 700 W;
//     scripts/compare_kernel_trees.py, queued): a CTA a tile, each counting
//     A_b again, took 0.264 ms (torch.bmm 0.238); A_b once and tiles of 64
//     columns double-buffered 0.263, so the count was not what held it
//     back; the tiles' bytes in flight were (kTiledCols above). The float32
//     walk at F 300 took 0.364 ms (torch.bmm 0.661); bounds 0.1027, 0.2032.
// What bounds it on the H100: device-memory bytes. x is read once (each block
// reads its own rows), the edge list once, y written once: N * F * 2 *
// sizeof(T) + E * 12 bytes (bf16 at 301,312 rows and 908,411 edges, F 128:
// 0.0451 ms at 3.35 TB/s unweighted, 0.0461 weighted; float32 0.0880,
// 0.0890). The block products, 2 * 128 * 128 * F operations a block (~10
// GFLOP for that bucket, ~10 us at the dense bf16 rate), lie below that
// line, and the slabs skipped cut them further.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "elem.cuh"

namespace {

constexpr int kBlockRows = 128;
constexpr int kMaxFeat = 256;  // columns a CTA covers (a tile of wider rows)
constexpr int kWalkWarps = 8;
constexpr int kWalkThreads = kWalkWarps * 32;
// edges of a block staged in shared memory (src, dst, weight: 12 bytes
// each); a block with more walks them from device memory
constexpr int kEdgeStage = 640;
// edges a lane reads at once, and CTAs an SM must hold (the launch bounds),
// by the type of x (scripts/probe_variants.py, kind bsw): bf16 two edges
// and 8 CTAs (32 registers), float32 four and 6
constexpr int kInFlightBf16 = 2;
constexpr int kInFlightF32 = 4;
constexpr int kMinBlocksBf16 = 8;
constexpr int kMinBlocksF32 = 6;

template <class T>
__host__ __device__ constexpr int walk_in_flight() {
  return sizeof(T) == 2 ? kInFlightBf16 : kInFlightF32;
}
template <class T>
__host__ __device__ constexpr int walk_min_blocks() {
  return sizeof(T) == 2 ? kMinBlocksBf16 : kMinBlocksF32;
}

// Shared memory of the walk: the block's edges and each row's bounds.
constexpr int kWalkSmem = kEdgeStage * 12 + 2 * kBlockRows * 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The walk of one destination row d of the block (its rows of x from xs,
// row r0 of x): each lane of the row's slot adds its word (NV values
// from column word `col`) of w_e x[src_e] over the row's edges i0 .. i1
// (positions in the block's range; esrc, edst, ew the block's edges,
// staged or in device memory; ew null: weight 1), kInFlight edges read at
// once, added in edge order, the weight and each message rounded to T.
template <class T, int NV>
__device__ __forceinline__ void walk_row(const T* __restrict__ xs, int feat,
                                         const int* esrc, const int* edst,
                                         const float* ew, int i0, int i1,
                                         int d, int r0, int col, bool mine,
                                         float (&acc)[NV]) {
  using W = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;
  constexpr int kInFlight = walk_in_flight<T>();
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  for (int i = i0; i <= i1; i += kInFlight) {
    int s[kInFlight];
    float w[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = i + u;
      s[u] = -1;
      w[u] = 1.f;
      if (e <= i1 && edst[e] - r0 == d) {
        const int sl = esrc[e] - r0;
        if (sl >= 0 && sl < kBlockRows) {  // an out-of-block source drops
          s[u] = sl;
          if (ew != nullptr) w[u] = bignn::round_to<T>(ew[e]);
        }
      }
    }
    W v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      v[u] = s[u] >= 0 && mine
                 ? __ldg(reinterpret_cast<const W*>(xs + s[u] * feat +
                                                    col * NV))
                 : W{};
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (s[u] >= 0) bignn::add_messages<T, NV>(v[u], w[u], acc);
  }
}

// NV: values of x a word holds (16 bytes: 4 floats or 8 bf16, where F and
// the pointers allow it; else 1; tiled, the widest word_values allows).
// One CTA per 128-row block (and tile of columns: kTiled, blockIdx.y).
template <class T, int NV, bool kTiled>
__global__ void __launch_bounds__(kWalkThreads, walk_min_blocks<T>())
    block_walk(const T* __restrict__ x, const int* __restrict__ src,
               const int* __restrict__ dst, const float* __restrict__ weight,
               const int* __restrict__ starts, int num_edges, int feat,
               T* __restrict__ out) {
  using W = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;
  extern __shared__ __align__(16) unsigned char walk_smem[];
  int* ssrc = reinterpret_cast<int*>(walk_smem);  // [kEdgeStage]
  int* sdst = ssrc + kEdgeStage;                   // [kEdgeStage]
  float* sw = reinterpret_cast<float*>(sdst + kEdgeStage);
  int* first = reinterpret_cast<int*>(sw + kEdgeStage);  // [128]
  int* last = first + kBlockRows;                          // [128]
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int r0 = b * kBlockRows;

  // 1. the block's edges land in shared memory (4-byte cp.async) where
  //    they fit; every row's bounds start empty
  const int e0 = max(0, min(starts[b], num_edges));
  const int e1 = max(e0, min(starts[b + 1], num_edges));
  const bool staged = e1 - e0 <= kEdgeStage;
  for (int e = e0 + tid; staged && e < e1; e += kWalkThreads) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(ssrc + e - e0)), "l"(src + e)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(sdst + e - e0)), "l"(dst + e)
                 : "memory");
    if (weight != nullptr)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(sw + e - e0)), "l"(weight + e)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int d = tid; d < kBlockRows; d += kWalkThreads) {
    first[d] = INT_MAX;
    last[d] = -1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. each destination row's edge bounds by integer atomicMin /
  //    atomicMax in shared memory (exact, so independent of their order;
  //    padding edges inside the range are skipped by their dst)
  const int* esrc = staged ? ssrc : src + e0;
  const int* edst = staged ? sdst : dst + e0;
  const float* ew = weight == nullptr ? nullptr : staged ? sw : weight + e0;
  for (int e = tid; e < e1 - e0; e += kWalkThreads) {
    const int d = edst[e] - r0;
    if (d >= 0 && d < kBlockRows) {
      atomicMin(first + d, e);
      atomicMax(last + d, e);
    }
  }
  __syncthreads();

  // 3. row slots: a destination row takes G lanes, its words rounded up to
  //    a power of two (at most 32; wider rows take more sweeps), so a warp
  //    sums 32 / G rows; each lane reads its edges itself, and its word of
  //    each source row from device memory through L1
  const int t0 = kTiled ? blockIdx.y * kMaxFeat : 0;  // the tile's columns
  const int width = kTiled ? min(kMaxFeat, feat - t0) : feat;
  const T* xs = x + static_cast<int64_t>(r0) * feat + t0;
  const int row_words = width / NV;
  const int lg = bignn::slot_log2(min(row_words, 32));
  const int slots = kWalkWarps * (32 >> lg);
  const int q = tid >> lg;
  const int c = tid & ((1 << lg) - 1);
  for (int d = q; d < kBlockRows; d += slots) {
    const int i0 = first[d];
    const int i1 = last[d];  // i1 < i0 for a row without edges
    T* o = out + static_cast<int64_t>(r0 + d) * feat + t0;
    for (int c0 = 0; c0 < row_words; c0 += 32) {
      const int col = c0 + c;
      const bool mine = col < row_words;
      float acc[NV];
      walk_row<T, NV>(xs, feat, esrc, edst, ew, i0, i1, d, r0, col, mine,
                      acc);
      if (mine)
        *reinterpret_cast<W*>(o + col * NV) = bignn::pack_word<T, NV, W>(acc);
    }
  }
}

// bf16, unweighted: Y_b = A_b X_b on the tensor cores. Shared memory
// (bytes): A_b in bf16 [128][kARow] (kABytes), whose first kCountBytes
// hold the block's 16-bit counts [128][128] until they are converted in
// place, and X_b in bf16 [128][fp + 8], fp = F rounded up to 16. Each smem
// row is padded by 16 bytes so that the 8 rows an ldmatrix reads fall on
// distinct banks.
constexpr int kARow = kBlockRows + 8;
constexpr int kCountBytes = kBlockRows * kBlockRows * 2;
constexpr int kABytes = kBlockRows * kARow * 2;
constexpr int kChunk = 64;    // output columns one pass of products covers
constexpr int kPass = 65535;  // edges counted at once: a count fits 16 bits
constexpr int kTcWarps = 8;   // warps of a CTA: 4 row bands x 2 column bands
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTileCols = kChunk / (kTcWarps / 4);  // columns of a tile
constexpr int kPre = 2;  // edges a thread loads before x's rows

__host__ __device__ inline int padded_feat(int feat) {
  return (feat + 15) & ~15;
}

__host__ __device__ inline int tc_smem_bytes(int feat) {
  return kABytes + kBlockRows * (padded_feat(feat) + 8) * 2;
}

// The tiled form (F above 256): x's columns staged kTiledCols at a time (a
// multiple of kChunk) into one buffer ([128][kTiledCols + 8] bf16: with
// A_b 100 KiB, 2 CTAs an SM, so one CTA's tile lands while the other's is
// multiplied); its 8-, 4- and 2-byte copies ask L2 for 128-byte lines
// (rows of F 300 are 600 bytes, off 128-byte lines).
// scripts/probe_variants.py (kind bst, with the ring and the hint as
// constants then) timed, bf16 F 300 at the 301,312-row bucket (NVIDIA H100
// 80GB HBM3, 700 W): tiles of 64 columns in a ring of 2, 3 or 4 buffers
// 0.267, 0.227 (the hint), 0.241 ms; of 128 in 2 buffers 0.235; of 256 in
// one 0.219 (the hint took 1-3 % off each form tried with it): the bytes
// a CTA has in flight at once matter more than the overlap inside it.
constexpr int kTiledCols = 256;
constexpr int kBufRow = kTiledCols + 8;
constexpr int kTiledSmem = kABytes + kBlockRows * kBufRow * 2;
static_assert(kTiledCols % kChunk == 0, "a buffer holds whole chunks");

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p,
                                            bool trans) {
  if (trans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  }
}

// c += a b for one m16n8k16 tile: bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A_b from the counts in the same bytes: each count c as c mod 256 (hi
// false) or as 256 (c div 256) (hi true), both exact in bf16 for
// c < 65536; sets *flag when some count is 256 or more, and in *slabs bit
// 8 (d / 32) + s / 16 for each 32-row band and 16-source slab that holds a
// count. A row of A lies past the count rows of the same index from row 2
// on, so rows 64-127 are converted first, each half read whole before any
// of it is written.
__device__ __forceinline__ void convert_counts(unsigned char* region,
                                               bool hi, int* flag,
                                               unsigned* slabs) {
  constexpr int kHalf = kBlockRows * kBlockRows / 16;  // uint4 of counts
  const uint4* cnt = reinterpret_cast<const uint4*>(region);
  __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(region);
  for (int half = 1; half >= 0; --half) {
    uint4 w[kHalf / kTcThreads];
#pragma unroll
    for (int r = 0; r < kHalf / kTcThreads; ++r)
      w[r] = cnt[half * kHalf + threadIdx.x + r * kTcThreads];
    __syncthreads();
    bool big = false;
    unsigned bits = 0;
#pragma unroll
    for (int r = 0; r < kHalf / kTcThreads; ++r) {
      const int i = half * kHalf + threadIdx.x + r * kTcThreads;
      const unsigned ws[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
      if (ws[0] | ws[1] | ws[2] | ws[3])
        bits |= 1u << ((i / 16) / 32 * 8 + (i % 16) / 2);
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned c0 = ws[j] & 0xffffu;
        const unsigned c1 = ws[j] >> 16;
        big |= (c0 | c1) >= 256u;
        o[j] = __floats2bfloat162_rn(
            static_cast<float>(hi ? c0 & ~255u : c0 & 255u),
            static_cast<float>(hi ? c1 & ~255u : c1 & 255u));
      }
      // 8 counts of row i / 16 from column (i % 16) * 8
      *reinterpret_cast<uint4*>(a + (i / 16) * kARow + (i % 16) * 8) = out;
    }
    if (big) *flag = 1;
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (threadIdx.x % 32 == 0 && bits) atomicOr(slabs, bits);
  }
}

// The warps tile the block's [128, nc] product in 4 row bands: warp w
// takes rows 32 (w % 4) .. + 32 and columns kTileCols (w / 4) .. +
// kTileCols of the chunk, so that per k-step it reads 2 A fragments and
// kTileCols / 16 B fragments (ldmatrix x4) for kTileCols / 4 products.
__device__ __forceinline__ int tile_row(int warp) { return 32 * (warp % 4); }
__device__ __forceinline__ int tile_col(int warp) {
  return kTileCols * (warp / 4);
}

// acc += A_b[m0 .. m0 + 32, :] X_b[:, c0 + n0 .. + kTileCols) for
// this warp's tile, nc a multiple of 16: 8 k-steps of 16 sources, of
// which those whose slab of the band holds no count (slabs) are skipped:
// a molecule's edges stay inside its rows, so a band's counts lie in a
// few slabs.
__device__ __forceinline__ void block_products(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ x,
    int xs, int c0, int nc, int warp, int lane, unsigned slabs,
    float (&acc)[2][kTileCols / 8][4]) {
  const int m0 = tile_row(warp);
  const int n0 = tile_col(warp);
  const unsigned band = slabs >> (m0 / 32 * 8);
#pragma unroll
  for (int k0 = 0; k0 < kBlockRows; k0 += 16) {
    if (((band >> (k0 / 16)) & 1u) == 0) continue;
    unsigned af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_x4(af[i],
                  a + (m0 + 16 * i + (lane & 15)) * kARow + k0 +
                      (lane >> 4) * 8,
                  false);
#pragma unroll
    for (int t = 0; t < kTileCols / 16; ++t) {
      if (n0 + 16 * t < nc) {
        unsigned bf[4];
        ldmatrix_x4(bf, x + (k0 + (lane & 15)) * xs + c0 + n0 + 16 * t +
                            (lane >> 4) * 8,
                    true);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * t], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * t + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
}

// Stage block b's rows of x (columns t0 + [0, width) of rows of feat
// values) into xsm (bf16 [128][xs]), the padding columns [width, fp) zero:
// VEC 8, 4 or 2 by cp.async copies of 2 VEC bytes (width, feat and t0
// multiples of VEC, x on 2 VEC bytes), VEC 1 one value at a time.
template <int VEC>
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        int b, int feat, int t0, int width,
                                        int fp, int xs, __nv_bfloat16* xsm) {
  using W = typename bignn::Word<2 * VEC>::type;
  const __nv_bfloat16* xb =
      x + static_cast<int64_t>(b) * kBlockRows * feat + t0;
  if constexpr (VEC >= 2) {
    // word w of row r, stepping blockDim.x words with a carry: no division
    // in the loop
    const int words = fp / VEC;
    const int rstep = blockDim.x / words;
    const int wstep = blockDim.x % words;
    int r = threadIdx.x / words;
    int w = threadIdx.x % words;
    for (; r < kBlockRows; r += rstep, w += wstep) {
      if (w >= words) {
        w -= words;
        ++r;
        if (r >= kBlockRows) break;
      }
      const int col = VEC * w;
      __nv_bfloat16* to = xsm + r * xs + col;
      if (col < width) {
        const __nv_bfloat16* from = xb + static_cast<int64_t>(r) * feat + col;
        if constexpr (VEC == 8) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           smem_addr(to)),
                       "l"(from)
                       : "memory");
        } else if constexpr (VEC == 4) {
          asm volatile(
              "cp.async.ca.shared.global.L2::128B [%0], [%1], 8;\n" ::"r"(
                  smem_addr(to)),
              "l"(from)
              : "memory");
        } else {
          asm volatile(
              "cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n" ::"r"(
                  smem_addr(to)),
              "l"(from)
              : "memory");
        }
      } else {
        *reinterpret_cast<W*>(to) = W{};
      }
    }
  } else {
    for (int i = threadIdx.x; i < kBlockRows * fp; i += blockDim.x) {
      const int r = i / fp;
      const int col = i % fp;
      xsm[r * xs + col] = col < width
                              ? xb[static_cast<int64_t>(r) * feat + col]
                              : __float2bfloat16_rn(0.f);
    }
  }
}

// One CTA per block, 3 an SM at F 128. The rows of x land (cp.async) while
// the edges are counted; A_b serves every column chunk unless the block
// needs more than one pass or holds a count of 256 or more. kTiled (F above
// 256): A_b is counted once and the CTA sweeps every tile of kTiledCols
// columns of the row, x's tiles staged in turn into one buffer (tile 0
// lands while the edges are counted, tile t + 1 by cp.async once tile t is
// multiplied and stored), so a narrow last tile (F 300: 44 columns) costs
// its own columns alone.
template <int VEC, bool kTiled>
__global__ void __launch_bounds__(kTcThreads, 3)
    block_spmm_tc(const __nv_bfloat16* __restrict__ x,
                  const int* __restrict__ src, const int* __restrict__ dst,
                  const int* __restrict__ starts, int num_edges, int feat,
                  __nv_bfloat16* __restrict__ out) {
  using W = typename bignn::Word<2 * VEC>::type;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned* cnt = reinterpret_cast<unsigned*>(tc_smem);  // [128][64] pairs
  __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(tc_smem + kABytes);
  __shared__ int big, over;
  __shared__ unsigned slabs;  // band-and-slab bits of A_b's nonzeros
  const int fp = padded_feat(feat);
  const int xs = fp + 8;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x;
  const int row0 = b * kBlockRows;

  // the block's edge range and each thread's first kPre edges load first:
  // they arrive while x's rows are staged and A_b is zeroed
  const int e0 = max(0, min(starts[b], num_edges));
  const int e1 = max(e0, min(starts[b + 1], num_edges));
  int pd[kPre], ps[kPre];
#pragma unroll
  for (int r = 0; r < kPre; ++r) {
    const int e = e0 + tid + r * kTcThreads;
    pd[r] = e < e1 ? __ldg(dst + e) : -1;
    ps[r] = e < e1 ? __ldg(src + e) : -1;
  }
  // tile t of the tiled form into the buffer
  auto stage_tile = [&](int t) {
    const int w = min(kTiledCols, feat - t * kTiledCols);
    stage_x<VEC>(x, b, feat, t * kTiledCols, w, padded_feat(w), kBufRow,
                 xsm);
    if constexpr (VEC >= 2)
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if constexpr (kTiled) {
    stage_tile(0);
  } else {
    stage_x<VEC>(x, b, feat, 0, feat, fp, xs, xsm);
    if constexpr (VEC >= 2)
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // A_b in bf16 by atomic adds of 1 at [d, s] for each in-block edge,
  // exact while no count passes 256: *over is set where one would
  auto build_fast = [&]() {
    for (int i = tid; i < kBlockRows * kBlockRows / 8; i += kTcThreads)
      *reinterpret_cast<uint4*>(a + (i / 16) * kARow + (i % 16) * 8) =
          make_uint4(0, 0, 0, 0);
    if (tid == 0) {
      over = 0;
      slabs = 0;
    }
    __syncthreads();
    const __nv_bfloat16 one = __float2bfloat16_rn(1.f);
    unsigned bits = 0;
    bool past = false;
    auto add = [&](int d, int s) {
      d -= row0;
      s -= row0;
      if (d >= 0 && d < kBlockRows && s >= 0 && s < kBlockRows) {
        past |= __bfloat162float(atomicAdd(a + d * kARow + s, one)) >= 256.f;
        bits |= 1u << (d / 32 * 8 + s / 16);
      }
    };
    int e = e0 + tid;
#pragma unroll
    for (int r = 0; r < kPre; ++r, e += kTcThreads)
      if (e < e1) add(pd[r], ps[r]);
    for (; e < e1; e += kTcThreads) add(__ldg(dst + e), __ldg(src + e));
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(&slabs, bits);
    if (past) over = 1;
    if constexpr (VEC >= 2) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  };
  // A_b over edges [p0, p1): the counts (one in-block edge adds 1 at
  // [d, s]), converted in place to c mod 256 (hi false) or 256 (c div 256)
  auto build = [&](int p0, int p1, bool hi) {
    for (int i = tid; i < kCountBytes / 16; i += kTcThreads)
      reinterpret_cast<uint4*>(cnt)[i] = make_uint4(0, 0, 0, 0);
    if (tid == 0) {
      big = 0;
      slabs = 0;
    }
    __syncthreads();
    for (int e = p0 + tid; e < p1; e += kTcThreads) {
      const int d = __ldg(dst + e) - row0;
      const int s = __ldg(src + e) - row0;
      if (d >= 0 && d < kBlockRows && s >= 0 && s < kBlockRows)
        atomicAdd(cnt + d * (kBlockRows / 2) + s / 2, 1u << (16 * (s & 1)));
    }
    __syncthreads();
    convert_counts(tc_smem, hi, &big, &slabs);
    if constexpr (VEC >= 2) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  };

  build_fast();
  const bool exact = over;  // a count passes 256: the 16-bit counts
  if constexpr (kTiled) {
    __nv_bfloat16* cur = xsm;
    const int tiles = (feat + kTiledCols - 1) / kTiledCols;
    for (int t = 0; t < tiles; ++t) {
      const int t0 = t * kTiledCols;  // the tile's first column of the row
      const int tw = min(kTiledCols, feat - t0);
      // tile t has landed (tile 0 while the edges were counted)
      if constexpr (VEC >= 2) asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      for (int c0 = 0; c0 < tw; c0 += kChunk) {
        const int nw = min(kChunk, tw - c0);
        const int nc = padded_feat(nw);
        float acc[2][kTileCols / 8][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int u = 0; u < kTileCols / 8; ++u) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][u][j] = 0.f;
          }
        }
        if (!exact)
          block_products(a, cur, kBufRow, c0, nc, warp, lane, slabs, acc);
        for (int p0 = e0; exact && p0 < e1; p0 += kPass) {
          const int p1 = min(e1, p0 + kPass);
          __syncthreads();  // every warp is done with A_b
          build(p0, p1, false);
          block_products(a, cur, kBufRow, c0, nc, warp, lane, slabs, acc);
          if (big) {  // counts of 256 or more: their 256 (c div 256) part
            __syncthreads();
            build(p0, p1, true);
            block_products(a, cur, kBufRow, c0, nc, warp, lane, slabs, acc);
          }
        }
        __syncthreads();  // every warp is done with this chunk's X_b
        // round once to bf16 through the chunk's columns of the buffer,
        // then store
        const int m0 = tile_row(warp);
        const int n0 = tile_col(warp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int u = 0; u < kTileCols / 8; ++u) {
            if (n0 + 8 * u < nc) {
              const int col = c0 + n0 + 8 * u + 2 * (lane % 4);
              const int r = m0 + 16 * i + lane / 4;
              *reinterpret_cast<__nv_bfloat162*>(cur + r * kBufRow + col) =
                  __floats2bfloat162_rn(acc[i][u][0], acc[i][u][1]);
              *reinterpret_cast<__nv_bfloat162*>(cur + (r + 8) * kBufRow +
                                                 col) =
                  __floats2bfloat162_rn(acc[i][u][2], acc[i][u][3]);
            }
          }
        }
        __syncwarp();
        const int ncols = min(kTileCols, nw - n0);  // of y in the warp's tile
        __nv_bfloat16* ob = out + (static_cast<int64_t>(row0) + m0) * feat +
                            t0 + c0 + n0;
        const __nv_bfloat16* st = cur + m0 * kBufRow + c0 + n0;
        if constexpr (VEC >= 2) {
          const int words = ncols / VEC;
          if (words > 0) {
            const int rstep = 32 / words;
            const int wstep = 32 % words;
            int r = lane / words;
            int w = lane % words;
            for (; r < 32; r += rstep, w += wstep) {
              if (w >= words) {
                w -= words;
                ++r;
                if (r >= 32) break;
              }
              *reinterpret_cast<W*>(ob + static_cast<int64_t>(r) * feat +
                                    VEC * w) =
                  *reinterpret_cast<const W*>(st + r * kBufRow + VEC * w);
            }
          }
        } else {
          for (int i = lane; i < 32 * ncols; i += 32) {
            const int r = i / ncols;
            const int col = i % ncols;
            ob[static_cast<int64_t>(r) * feat + col] = st[r * kBufRow + col];
          }
        }
      }
      __syncthreads();  // every warp is done with the buffer
      if (t + 1 < tiles) stage_tile(t + 1);
    }
    return;
  }
  for (int c0 = 0; c0 < fp; c0 += kChunk) {
    const int nc = min(kChunk, fp - c0);
    float acc[2][kTileCols / 8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int t = 0; t < kTileCols / 8; ++t) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][t][j] = 0.f;
      }
    }
    if (!exact) block_products(a, xsm, xs, c0, nc, warp, lane, slabs, acc);
    for (int p0 = e0; exact && p0 < e1; p0 += kPass) {
      const int p1 = min(e1, p0 + kPass);
      __syncthreads();  // every warp is done with A_b
      build(p0, p1, false);
      block_products(a, xsm, xs, c0, nc, warp, lane, slabs, acc);
      if (big) {  // counts of 256 or more: their 256 (c div 256) part
        __syncthreads();
        build(p0, p1, true);
        block_products(a, xsm, xs, c0, nc, warp, lane, slabs, acc);
      }
    }
    if constexpr (VEC >= 2) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // every warp is done with this chunk's columns of X_b
    // round once to bf16 and store: the warp's tile goes through X_b's
    // bytes of this chunk's columns (no longer read), then out 16 bytes a
    // lane
    const int m0 = tile_row(warp);
    const int n0 = tile_col(warp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int t = 0; t < kTileCols / 8; ++t) {
        if (n0 + 8 * t < nc) {
          const int col = c0 + n0 + 8 * t + 2 * (lane % 4);
          const int r = m0 + 16 * i + lane / 4;
          *reinterpret_cast<__nv_bfloat162*>(xsm + r * xs + col) =
              __floats2bfloat162_rn(acc[i][t][0], acc[i][t][1]);
          *reinterpret_cast<__nv_bfloat162*>(xsm + (r + 8) * xs + col) =
              __floats2bfloat162_rn(acc[i][t][2], acc[i][t][3]);
        }
      }
    }
    __syncwarp();
    // columns of y in this warp's tile
    const int ncols = min(kTileCols, min(nc, feat - c0) - n0);
    __nv_bfloat16* ob =
        out + (static_cast<int64_t>(row0) + m0) * feat + c0 + n0;
    const __nv_bfloat16* st = xsm + m0 * xs + c0 + n0;
    if constexpr (VEC >= 2) {
      const int words = ncols / VEC;  // of a row of the tile; 32 lanes a step
      if (words > 0) {
        const int rstep = 32 / words;
        const int wstep = 32 % words;
        int r = lane / words;
        int w = lane % words;
        for (; r < 32; r += rstep, w += wstep) {
          if (w >= words) {
            w -= words;
            ++r;
            if (r >= 32) break;
          }
          *reinterpret_cast<W*>(ob + static_cast<int64_t>(r) * feat +
                                VEC * w) =
              *reinterpret_cast<const W*>(st + r * xs + VEC * w);
        }
      }
    } else {
      for (int i = lane; i < 32 * ncols; i += 32) {
        const int r = i / ncols;
        const int col = i % ncols;
        ob[static_cast<int64_t>(r) * feat + col] = st[r * xs + col];
      }
    }
  }
}

// Tiles of columns: gridDim.y.
inline int col_tiles(int feat) { return (feat + kMaxFeat - 1) / kMaxFeat; }

template <class T, int NV, bool kTiled>
int launch_walk(const void* x, const void* src, const void* dst,
                const void* weight, const void* starts, int num_edges,
                int num_blocks, int feat, void* out, cudaStream_t st) {
  const dim3 grid(num_blocks, kTiled ? col_tiles(feat) : 1);
  block_walk<T, NV, kTiled><<<grid, kWalkThreads, kWalkSmem, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const float*>(weight),
      static_cast<const int*>(starts), num_edges, feat, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, bool kTiled>
int launch_tc(const void* x, const void* src, const void* dst,
              const void* starts, int num_edges, int num_blocks, int feat,
              void* out, cudaStream_t st) {
  static int done[bignn::kMaxDevices] = {};
  const int smem = kTiled ? kTiledSmem : tc_smem_bytes(feat);
  const cudaError_t err =
      bignn::allow_smem(block_spmm_tc<VEC, kTiled>, smem, done,
                        cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_spmm_tc<VEC, kTiled><<<num_blocks, kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const int*>(starts),
      num_edges, feat, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Rows wider than kMaxFeat: tiles of columns, words of nv values, the
// widest that divides F and on which x and out lie.
template <class T>
int tiled(const void* x, const void* src, const void* dst, const void* weight,
          const void* starts, int num_edges, int num_blocks, int feat,
          void* out, cudaStream_t st) {
  const int nv = bignn::word_values<T>(
      feat, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out));
  if constexpr (sizeof(T) == 2) {
    if (weight == nullptr) {  // the tensor-core product
      switch (nv) {
        case 8:
          return launch_tc<8, true>(x, src, dst, starts, num_edges,
                                    num_blocks, feat, out, st);
        case 4:
          return launch_tc<4, true>(x, src, dst, starts, num_edges,
                                    num_blocks, feat, out, st);
        case 2:
          return launch_tc<2, true>(x, src, dst, starts, num_edges,
                                    num_blocks, feat, out, st);
        default:
          return launch_tc<1, true>(x, src, dst, starts, num_edges,
                                    num_blocks, feat, out, st);
      }
    }
    if (nv == 8)
      return launch_walk<T, 8, true>(x, src, dst, weight, starts, num_edges,
                                     num_blocks, feat, out, st);
  }
  switch (nv) {
    case 4:
      return launch_walk<T, 4, true>(x, src, dst, weight, starts, num_edges,
                                     num_blocks, feat, out, st);
    case 2:
      return launch_walk<T, 2, true>(x, src, dst, weight, starts, num_edges,
                                     num_blocks, feat, out, st);
    default:
      return launch_walk<T, 1, true>(x, src, dst, weight, starts, num_edges,
                                     num_blocks, feat, out, st);
  }
}

template <class T>
int block_spmm_rows(const void* x, const void* src, const void* dst,
                    const void* weight, const void* starts, int num_edges,
                    int num_blocks, int feat, void* out, void* stream) {
  if (num_edges < 0 || num_blocks < 0 || feat < 0 ||
      col_tiles(feat) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_blocks == 0 || feat == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat > kMaxFeat)
    return tiled<T>(x, src, dst, weight, starts, num_edges, num_blocks, feat,
                    out, st);
  // 16-byte loads: a block's rows start 128 * F values after x, so they are
  // aligned when x is and F is a multiple of kWide
  constexpr int kWide = 16 / sizeof(T);
  const bool wide = feat % kWide == 0 &&
                    (reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if constexpr (sizeof(T) == 2) {
    if (weight == nullptr) {  // the tensor-core product
      if (wide)
        return launch_tc<8, false>(x, src, dst, starts, num_edges, num_blocks,
                                   feat, out, st);
      return launch_tc<1, false>(x, src, dst, starts, num_edges, num_blocks,
                                 feat, out, st);
    }
  }
  if (wide)
    return launch_walk<T, kWide, false>(x, src, dst, weight, starts,
                                        num_edges, num_blocks, feat, out, st);
  return launch_walk<T, 1, false>(x, src, dst, weight, starts, num_edges,
                                  num_blocks, feat, out, st);
}

}  // namespace

extern "C" {

// x [num_blocks * 128, feat] f32 or bf16 (any feat), src/dst [num_edges]
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
