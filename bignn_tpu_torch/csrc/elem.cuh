// Element types of the kernels' data, shared by every source that takes more
// than float32 (segment_sum.cu, segment_softmax.cu, spmm_multihead.cu,
// block_adj.cu, spmm.cu, block_spmm.cu, segment_max.cu), and the
// shared-memory opt-in of the kernels that launch with more than 48 KiB
// (block_spmm.cu, block_adj.cu, flash_gat_bwd.cu).
//
// Every sum runs in float32 whatever the stored type: a value is widened
// with to_f32 when it is loaded and narrowed once, with round-to-nearest-even
// (__float2bfloat16_rn), when it is stored (from_f32). A row read a word of
// several values at a time (a bf16 pair, a 16-byte word) must start on that
// word: the row's width and the tensor's base pointer must both allow it,
// and the host checks both before it picks the wider load (word_values, or
// the kernel's own check of width and pointers). An even width alone says
// nothing of a view that starts 2 bytes off.

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

// x rounded to T and widened back: the value a product takes when it is
// stored in T (identity for float32).
template <class T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// VEC consecutive values p[0 .. VEC) as floats, in one load where VEC spans
// 16 bytes (float32 VEC 4, bf16 VEC 8; p on a 16-byte boundary), one 4-byte
// load for a bf16 pair (VEC 2), or one value (VEC 1).
template <int VEC, class T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = load1(p);
  } else if constexpr (VEC == 2) {
    const float2 v = load2(p);
    out[0] = v.x;
    out[1] = v.y;
  } else if constexpr (VEC == 4) {
    static_assert(sizeof(T) == 4, "VEC 4 is the float32 16-byte load");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    static_assert(VEC == 8 && sizeof(T) == 2,
                  "VEC 8 is the bf16 16-byte load");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      out[2 * i] = v.x;
      out[2 * i + 1] = v.y;
    }
  }
}

// p[0 .. VEC) = v[0 .. VEC), narrowed to T: the stores matching load_vec.
template <int VEC, class T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else if constexpr (VEC == 2) {
    store2(p, v[0], v[1]);
  } else if constexpr (VEC == 4) {
    static_assert(sizeof(T) == 4, "VEC 4 is the float32 16-byte store");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(VEC == 8 && sizeof(T) == 2,
                  "VEC 8 is the bf16 16-byte store");
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The word type of B bytes (16, 8, 4 or 2), in which NV = B / sizeof(T)
// values of T are loaded or stored at once.
template <int B>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<2> {
  using type = unsigned short;
};

// out[0 .. NV) = the NV values of T packed in w, as floats.
template <class T, int NV, class W>
__device__ __forceinline__ void unpack_word(const W& w, float (&out)[NV]) {
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(&w);
#pragma unroll
    for (int i = 0; i < NV; ++i) out[i] = f[i];
  } else if constexpr (NV == 1) {
    out[0] = __bfloat162float(__ushort_as_bfloat16(w));
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      out[2 * i] = v.x;
      out[2 * i + 1] = v.y;
    }
  }
}

// v[0 .. NV) rounded to T and packed as one word.
template <class T, int NV, class W>
__device__ __forceinline__ W pack_word(const float (&v)[NV]) {
  W w;
  if constexpr (sizeof(T) == 4) {
    float* f = reinterpret_cast<float*>(&w);
#pragma unroll
    for (int i = 0; i < NV; ++i) f[i] = v[i];
  } else if constexpr (NV == 1) {
    w = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  return w;
}

// acc[0 .. NV) += the NV values of T packed in word, each multiplied by w
// and the product rounded to T: the message of a weighted SpMM in T (w a
// float holding a value of T). For bf16 two products at a time with
// __hmul2: the product of two bf16 values is exact in float32, so rounding
// it once to bf16 gives the bits that rounding the float32 product does
// (away from the subnormal range); for float32 the rounding is the
// identity and the sum a fused multiply-add.
template <class T, int NV, class W>
__device__ __forceinline__ void add_messages(const W& word, float w,
                                             float (&acc)[NV]) {
  if constexpr (sizeof(T) == 2 && NV % 2 == 0) {
    const __nv_bfloat162 w2 = __bfloat162bfloat162(__float2bfloat16_rn(w));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&word);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      const float2 m = __bfloat1622float2(__hmul2(w2, h[i]));
      acc[2 * i] += m.x;
      acc[2 * i + 1] += m.y;
    }
  } else {
    float f[NV];
    unpack_word<T, NV>(word, f);
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] += round_to<T>(w * f[k]);
  }
}

// row[0 .. n) into out[0 .. n) as floats, n <= N, read a word of NV values
// at a time: NV divides n and the row starts on NV * sizeof(T) bytes (the
// host's word_values checks both).
template <int N, int NV, class T>
__device__ __forceinline__ void load_row(const T* row, int n, float* out) {
  using W = typename Word<NV * static_cast<int>(sizeof(T))>::type;
#pragma unroll
  for (int h = 0; h < N; h += NV) {
    if (h < n) {
      float f[NV];
      unpack_word<T, NV>(__ldg(reinterpret_cast<const W*>(row + h)), f);
#pragma unroll
      for (int i = 0; i < NV; ++i) out[h + i] = f[i];
    }
  }
}

// row[0 .. n) = v[0 .. n), narrowed to T, a word of NV values at a time (as
// load_row).
template <int N, int NV, class T>
__device__ __forceinline__ void store_row(T* row, int n, const float* v) {
  using W = typename Word<NV * static_cast<int>(sizeof(T))>::type;
#pragma unroll
  for (int h = 0; h < N; h += NV) {
    if (h < n) {
      float f[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) f[i] = v[h + i];
      *reinterpret_cast<W*>(row + h) = pack_word<T, NV, W>(f);
    }
  }
}

// The values of T a word holds for rows of n values whose bases are the
// bits of addr (the OR of every tensor's base pointer the kernel reads or
// writes by rows): the widest power of two NV <= 16 / sizeof(T) that
// divides n with every base on NV * sizeof(T) bytes, so that every row
// starts on a word.
template <class T>
inline int word_values(int n, uintptr_t addr) {
  int nv = 16 / static_cast<int>(sizeof(T));
  while (nv > 1 && (n % nv != 0 || addr % (nv * sizeof(T)) != 0)) nv /= 2;
  return nv;
}

// log2 of the lanes a row of m words takes (a row slot, segment_sum.cu):
// m rounded up to a power of two.
__host__ __device__ __forceinline__ int slot_log2(int m) {
  int lg = 0;
  while ((1 << lg) < m) ++lg;
  return lg;
}

// True when rows of n values of T may be read as pairs as far as the width
// goes: always false for float32 (its pair load is two loads anyway), even
// n for bf16. The caller checks the base pointer on 4 bytes as well.
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

// Devices a kernel's record of its shared-memory opt-in covers.
constexpr int kMaxDevices = 64;

// Allow `bytes` of dynamic shared memory for `kernel` on the current device
// (above 48 KiB a launch needs this opt-in), with its preferred carveout,
// once per device and size: `done` is the kernel's record of the size
// allowed on each device. Every source that launches with more than 48 KiB
// calls it before its launch.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes,
                              int (&done)[kMaxDevices],
                              int carveout = cudaSharedmemCarveoutDefault) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = bytes;
  return err;
}

}  // namespace
}  // namespace bignn
