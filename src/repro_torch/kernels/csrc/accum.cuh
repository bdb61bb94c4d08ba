// Accumulator types and conversions shared by the coded product kernels
// (coded_fused.cu, coded_encode.cu, block_matmul.cu).
//
// float64 and float32 accumulate in their own type; bf16 and f16 accumulate
// in float32, as the TPU kernels do (an f32 scratch accumulator).  A result
// is written in its output type with round-to-nearest-even.  For float64 and
// float32 every conversion here is the identity, so those instances compile
// to the arithmetic they had before the half types were added.
//
// The FP32 encode chain of 16-byte vectors (8 bf16 / f16 elements) at the
// end is the one arithmetic of kernel 1's TMA form (coded_fused.cu,
// encode_pair) and kernel 4's 16-byte form (coded_encode.cu), so that the
// fused product equals the staged one bit for bit: a coded element's sum
// starts from 0, takes one FMA per raw block in increasing block order
// (fma8), and is rounded once to nearest even (round8).  Both kernels run
// it on several workers at once (kernel 1 a pair, kernel 4 one or four).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

namespace accum {

template <typename T>
struct Accum {
  using type = T;
};
template <>
struct Accum<__nv_bfloat16> {
  using type = float;
};
template <>
struct Accum<__half> {
  using type = float;
};

// The type element type T is summed in.
template <typename T>
using acc_t = typename Accum<T>::type;

__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// Cast<Out>::from(x): x in Out, rounded to nearest even.
template <typename Out>
struct Cast;
template <>
struct Cast<double> {
  __device__ static __forceinline__ double from(double x) { return x; }
};
template <>
struct Cast<float> {
  __device__ static __forceinline__ float from(float x) { return x; }
};
template <>
struct Cast<__nv_bfloat16> {
  __device__ static __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Cast<__half> {
  __device__ static __forceinline__ __half from(float x) { return __float2half_rn(x); }
};

// Two FP32 values as a pair of Out, each rounded to nearest even: one
// conversion instruction for bf16 and f16 (also wgmma_gemm.cuh's epilogue).
template <typename Out>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  __device__ static type of(float x, float y) { return make_float2(x, y); }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ static type of(float x, float y) { return __floats2bfloat162_rn(x, y); }
};
template <>
struct Pair<__half> {
  using type = __half2;
  __device__ static type of(float x, float y) { return __floats2half2_rn(x, y); }
};

// ---- the FP32 encode chain of 16-byte vectors of bf16 / f16 ------------------

// A 32-bit word of two 16-bit elements, widened to FP32 (exactly).  bf16
// is the top half of an FP32: one byte permute and one mask, both on the
// integer pipe, which leaves the FMA pipes to the encode's sums.
__device__ __forceinline__ void widen_pair(uint32_t word, float& lo, float& hi,
                                           __nv_bfloat16) {
  lo = __uint_as_float(__byte_perm(word, 0u, 0x1044));  // word << 16
  hi = __uint_as_float(word & 0xffff0000u);
}
__device__ __forceinline__ void widen_pair(uint32_t word, float& lo, float& hi, __half) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&word));
  lo = f.x;
  hi = f.y;
}

// One step of the chain for kW workers at once: s[w][l] += c[w] * e[l] for
// the 8 elements e of the raw 16-byte vector x, each widened once.  Every
// multiply-add is one FMA (nvcc contracts the product into the sum, its
// default), in this order: element pairs, then their two elements, then
// workers.
template <typename T, int kW>
__device__ __forceinline__ void fma8(float (&s)[kW][8], const float (&c)[kW],
                                     const uint4& x) {
  const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float e[2];
    widen_pair(words[u], e[0], e[1], T());
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int w = 0; w < kW; ++w) s[w][2 * u + h] += c[w] * e[h];
    }
  }
}

// The chain's end for kW workers: y[w] = the 8 sums s[w] rounded to T as
// one 16-byte vector.
template <typename T, int kW>
__device__ __forceinline__ void round8(const float (&s)[kW][8], uint4 (&y)[kW]) {
  union Packed {
    uint4 v;
    typename Pair<T>::type e[4];
  } packed[kW];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int w = 0; w < kW; ++w) packed[w].e[l] = Pair<T>::of(s[w][2 * l], s[w][2 * l + 1]);
  }
#pragma unroll
  for (int w = 0; w < kW; ++w) y[w] = packed[w].v;
}

}  // namespace accum
