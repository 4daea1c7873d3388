// Element types of the kernels' data, shared by every source that takes more
// than float32 (segment_sum.cu, segment_softmax.cu, spmm_multihead.cu,
// block_adj.cu).
//
// Every sum runs in float32 whatever the stored type: a value is widened
// with to_f32 when it is loaded and narrowed once, with round-to-nearest-even
// (__float2bfloat16_rn), when it is stored (from_f32). bf16 rows of an even
// width are read two values at a time (__nv_bfloat162, 4 bytes), which
// needs the row to start on a 4-byte boundary: an even row width does that.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bignn {
namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Values p[0], p[1] as floats: one 4-byte load for a bf16 pair (p on a
// 4-byte boundary), two loads for float32.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return make_float2(__ldg(p), __ldg(p + 1));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

// row[0 .. n) into out[0 .. n) as floats, n <= N; pairs when n is even (a
// row of an odd width may start off a 4-byte boundary).
template <int N, class T>
__device__ __forceinline__ void load_row(const T* row, int n, float* out) {
  if ((n & 1) == 0) {
#pragma unroll
    for (int h = 0; h < N; h += 2) {
      if (h < n) {
        const float2 v = load2(row + h);
        out[h] = v.x;
        out[h + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < N; ++h)
      if (h < n) out[h] = load1(row + h);
  }
}

// out[0 .. n) = v[0 .. n), narrowed to T; pairs when n is even.
template <int N, class T>
__device__ __forceinline__ void store_row(T* out, int n, const float* v) {
  if ((n & 1) == 0) {
#pragma unroll
    for (int h = 0; h < N; h += 2)
      if (h < n) store2(out + h, v[h], v[h + 1]);
  } else {
#pragma unroll
    for (int h = 0; h < N; ++h)
      if (h < n) out[h] = from_f32<T>(v[h]);
  }
}

// True when rows of n values of T may be read as pairs: always false for
// float32 (its pair load is two loads anyway), even n for bf16.
template <class T>
inline bool pairs_ok(int n);
template <>
inline bool pairs_ok<float>(int) {
  return false;
}
template <>
inline bool pairs_ok<__nv_bfloat16>(int n) {
  return n % 2 == 0;
}

}  // namespace
}  // namespace bignn
