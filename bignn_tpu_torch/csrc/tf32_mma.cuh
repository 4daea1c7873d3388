// Tensor-core products in 3xTF32 and asynchronous copies, shared by the
// flash-GAT kernels (flash_gat.cu, flash_gat_bwd.cu).
//
// mma.sync m16n8k8 takes TF32 operands (float32 with a 10-bit mantissa).
// 3xTF32 keeps float32-level products: each operand x is split into TF32
// halves hi + lo, and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b (the lo x lo
// term is below float32's rounding). Plain TF32, one hi x hi product, keeps
// about three digits.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bignn {
namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo as split_tf32, with both halves cut to TF32 by a bit mask
// (truncation) in place of cvt.rna: hi keeps x's top 10 mantissa bits, lo
// the top 10 of the exact rest. Three integer or float operations where
// split_tf32 takes two conversions; the halves lose at most 2^-20 of |x|
// (the rounded split 2^-22), below float32's rounding of a long sum.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a b on one m16n8k8 tile (a row-major 16 x 8, b column-major 8 x 8).
// A lane (gid = lane / 4, tig = lane % 4) holds a = {A[gid][tig],
// A[gid + 8][tig], A[gid][tig + 4], A[gid + 8][tig + 4]}, b = {B[tig][gid],
// B[tig + 4][gid]} and c = {C[gid][2 tig], C[gid][2 tig + 1],
// C[gid + 8][2 tig], C[gid + 8][2 tig + 1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first. The product of one k-step
// goes to fresh registers and is added to c in float32: chained through
// the tensor cores' accumulator, the k-steps' sums drift (the flash-GAT
// backward's a_l gradient, whose terms cancel, came off the plain step by
// 1.04e-4 of its scale against 3.0e-5 this way and 1.6e-5 for float32 FMAs)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, a_lo, b_hi);
  mma_tf32(p, a_hi, b_lo);
  mma_tf32(p, a_hi, b_hi);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += p[r];
}

}  // namespace
}  // namespace bignn
