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
// For float32 both roundings are the identity.
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
// stages its own rows), the edge list once (the walk reads it again for its
// bounds, from L2), y written once: N * F * 2 * sizeof(T) + E * 12 bytes
// (bf16 at 301,312 rows and 908,411 edges, F 128: 0.0451 ms at 3.35 TB/s).
// The block products, 2 * 128 * 128 * F operations a block (~10 GFLOP for
// that bucket, ~10 us at the dense bf16 rate), lie below that line, and
// the slabs skipped cut them further.

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

// Stage block b's rows of x into xsm (bf16 [128][xs]), the padding columns
// [F, fp) zero: VEC 8 by 16-byte cp.async copies (F a multiple of 8, x on
// 16 bytes), VEC 1 one value at a time.
template <int VEC>
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        int b, int feat, int fp, int xs,
                                        __nv_bfloat16* xsm) {
  const __nv_bfloat16* xb = x + static_cast<int64_t>(b) * kBlockRows * feat;
  if constexpr (VEC == 8) {
    // word w of row r, stepping blockDim.x words with a carry: no division
    // in the loop
    const int words = fp / 8;
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
      const int col = 8 * w;
      __nv_bfloat16* to = xsm + r * xs + col;
      if (col < feat) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(to)),
                     "l"(xb + static_cast<int64_t>(r) * feat + col)
                     : "memory");
      } else {
        *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kBlockRows * fp; i += blockDim.x) {
      const int r = i / fp;
      const int col = i % fp;
      xsm[r * xs + col] = col < feat ? xb[static_cast<int64_t>(r) * feat + col]
                                     : __float2bfloat16_rn(0.f);
    }
  }
}

// One CTA per block, 3 an SM at F 128. The rows of x land (cp.async)
// while the edges are counted; A_b serves every column chunk unless the
// block needs more than one pass or holds a count of 256 or more.
template <int VEC>
__global__ void __launch_bounds__(kTcThreads, 3)
    block_spmm_tc(const __nv_bfloat16* __restrict__ x,
                  const int* __restrict__ src, const int* __restrict__ dst,
                  const int* __restrict__ starts, int num_edges, int feat,
                  __nv_bfloat16* __restrict__ out) {
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
  stage_x<VEC>(x, b, feat, fp, xs, xsm);
  if constexpr (VEC == 8) asm volatile("cp.async.commit_group;\n" ::: "memory");

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
    if constexpr (VEC == 8) asm volatile("cp.async.wait_all;\n" ::: "memory");
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
    if constexpr (VEC == 8) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  };

  build_fast();
  const bool exact = over;  // a count passes 256: the 16-bit counts
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
    if constexpr (VEC == 8) asm volatile("cp.async.wait_all;\n" ::: "memory");
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
    if constexpr (VEC == 8) {
      const int words = ncols / 8;  // of a row of the tile; 32 lanes a step
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
          *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(r) * feat +
                                    8 * w) =
              *reinterpret_cast<const uint4*>(st + r * xs + 8 * w);
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

template <class T, int VEC>
int launch(const void* x, const void* src, const void* dst,
           const void* weight, const void* starts, int num_edges,
           int num_blocks, int feat, void* out, cudaStream_t st) {
  static int done[bignn::kMaxDevices] = {};
  const int smem = kBlockRows * feat * 4 + kBoundsBytes;
  // the most shared memory: 2 CTAs an SM at F 128
  const cudaError_t err = bignn::allow_smem(block_spmm<T, VEC>, smem, done,
                                            cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_spmm<T, VEC><<<num_blocks, kWarps * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const float*>(weight),
      static_cast<const int*>(starts), num_edges, feat, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_tc(const void* x, const void* src, const void* dst,
              const void* starts, int num_edges, int num_blocks, int feat,
              void* out, cudaStream_t st) {
  static int done[bignn::kMaxDevices] = {};
  const int smem = tc_smem_bytes(feat);
  const cudaError_t err = bignn::allow_smem(block_spmm_tc<VEC>, smem, done,
                                            cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_spmm_tc<VEC><<<num_blocks, kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const int*>(starts),
      num_edges, feat, static_cast<__nv_bfloat16*>(out));
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
  const bool wide = feat % kWide == 0 &&
                    (reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if constexpr (sizeof(T) == 2) {
    if (weight == nullptr) {  // the tensor-core product
      if (wide)
        return launch_tc<8>(x, src, dst, starts, num_edges, num_blocks, feat,
                            out, st);
      return launch_tc<1>(x, src, dst, starts, num_edges, num_blocks, feat,
                          out, st);
    }
  }
  if (wide)
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
