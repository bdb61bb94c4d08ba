// Accumulator types and conversions shared by the coded product kernels
// (coded_fused.cu, coded_encode.cu, block_matmul.cu).
//
// float64 and float32 accumulate in their own type; bf16 and f16 accumulate
// in float32, as the TPU kernels do (an f32 scratch accumulator).  A result
// is written in its output type with round-to-nearest-even.  For float64 and
// float32 every conversion here is the identity, so those instances compile
// to the arithmetic they had before the half types were added.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

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

}  // namespace accum
