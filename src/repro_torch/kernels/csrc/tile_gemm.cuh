// The register-blocked product tile shared by coded_fused.cu and
// block_matmul.cu.
//
// One block of 256 threads owns a 64x64 output tile; each thread accumulates
// a 4x4 micro-tile in registers from (kBK x 64) tiles of the two operands in
// shared memory, both stored with the contraction dimension first (the
// transposed LHS of C = A^T B is read as it lies).  FP64 runs in FP64 with an
// FP64 accumulator and FP32 in FP32: no TF32 anywhere.  The kernels that
// include this file fill the shared tiles their own way and walk the
// contraction dimension themselves.
#pragma once

namespace tile_gemm {

constexpr int kBM = 64;   // output rows (r) per block
constexpr int kBN = 64;   // output cols (t) per block
constexpr int kBK = 16;   // contraction (v) rows per step
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 4;    // cols per thread
constexpr int kRowThreads = kBM / kTM;               // 16
constexpr int kColThreads = kBN / kTN;               // 16
constexpr int kThreads = kRowThreads * kColThreads;  // 256
constexpr int kStep = kThreads / kBM;  // tile rows one pass of loads fills (4)
constexpr int kIters = kBK / kStep;    // passes per step (4)
static_assert(kBM == kBN && kThreads % kBM == 0 && kBK % kStep == 0,
              "the tile-load mapping assumes square tiles");

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
}

// acc += a_s^T b_s over one step's kBK contraction rows.
template <typename T>
__device__ __forceinline__ void multiply(const T (&a_s)[kBK][kBM],
                                         const T (&b_s)[kBK][kBN],
                                         T (&acc)[kTM][kTN], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    T af[kTM];
    T bf[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) af[i] = a_s[kk][ty + i * kRowThreads];
#pragma unroll
    for (int j = 0; j < kTN; ++j) bf[j] = b_s[kk][tx + j * kColThreads];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] += af[i] * bf[j];
  }
}

// Write the micro-tile into the contiguous (r, t) output, masking the edge.
template <typename T>
__device__ __forceinline__ void store(T* __restrict__ out,
                                      const T (&acc)[kTM][kTN], long long r0,
                                      long long t0, long long r, long long t,
                                      int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long rr = r0 + ty + i * kRowThreads;
    if (rr >= r) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const long long tt = t0 + tx + j * kColThreads;
      if (tt < t) out[rr * t + tt] = acc[i][j];
    }
  }
}

}  // namespace tile_gemm
