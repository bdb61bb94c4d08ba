// WORKER-PRODUCT kernel for the staged backend, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/block_matmul.py::matmul_t_pallas: one worker's
// coded block product
//
//     C = A^T B                      A (v, r), B (v, t) -> C (r, t)
//
// What bounds it: FP64 (or FP32) operations, 2*r*t*v of them (1.28e11 at the
// paper's 8000^2 geometry, per worker) against 0.38 GB of operands.  The
// design is the plain register-blocked FMA product of coded_fused.cu (the
// 64x64 output tile with a 4x4 micro-tile per thread, tile_gemm.cuh), without
// the encode: one block per output tile walks v in steps of 16 rows.  The
// transposed LHS needs no transpose: a (16 x 64) tile of A is 16 row segments
// of A, each read coalesced along r, and stored contraction-first in shared
// memory, exactly as the product loop reads it (Hopper has no transposed
// matrix-unit tile to lean on).  Each thread issues its 4 loads of A and 4 of
// B together.  Every edge is masked, not padded (4000 fits no power of two).
// FP64 accumulates in FP64, never TF32.  Tensor cores (DMMA / wgmma) and
// TMA with a multi-stage ring are later work.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
matmul_t_kernel(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ out, long long v, long long r, long long t,
                long long lda, long long ldb) {
  __shared__ T a_s[kBK][kBM];
  __shared__ T b_s[kBK][kBN];

  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long t0 = static_cast<long long>(blockIdx.x) * kBN;
  const int ty = tid / kColThreads;
  const int tx = tid % kColThreads;
  T acc[kTM][kTN];
  zero(acc);

  // Load coordinates: column ec of the tile, rows er + kStep * it.
  const int ec = tid % kBM;
  const int er = tid / kBM;
  const bool a_col = r0 + ec < r;
  const bool b_col = t0 + ec < t;
  const T* a_src = A + r0 + ec;
  const T* b_src = B + t0 + ec;

  for (long long v0 = 0; v0 < v; v0 += kBK) {
    T xa[kIters];
    T xb[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const long long vr = v0 + er + it * kStep;
      xa[it] = a_col && vr < v ? a_src[vr * lda] : T(0);
      xb[it] = b_col && vr < v ? b_src[vr * ldb] : T(0);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      a_s[er + it * kStep][ec] = xa[it];
      b_s[er + it * kStep][ec] = xb[it];
    }
    __syncthreads();
    multiply(a_s, b_s, acc, ty, tx);
    __syncthreads();
  }

  store(out, acc, r0, t0, r, t, ty, tx);
}

template <typename T>
int launch(const T* A, const T* B, T* out, long long v, long long r,
           long long t, long long lda, long long ldb, void* stream) {
  if (r < 1 || t < 1 || v < 0 || (r + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((t + kBN - 1) / kBN),
                  static_cast<unsigned>((r + kBM - 1) / kBM));
  matmul_t_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, out, v, r, t, lda, ldb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (v, r) with row stride lda, B (v, t) with row stride ldb, both with unit
// column stride; out (r, t) contiguous.  Returns the cudaError_t of the
// launch.
extern "C" int repro_matmul_t_f64(const double* A, const double* B,
                                  double* out, long long v, long long r,
                                  long long t, long long lda, long long ldb,
                                  void* stream) {
  return launch<double>(A, B, out, v, r, t, lda, ldb, stream);
}

extern "C" int repro_matmul_t_f32(const float* A, const float* B, float* out,
                                  long long v, long long r, long long t,
                                  long long lda, long long ldb, void* stream) {
  return launch<float>(A, B, out, v, r, t, lda, ldb, stream);
}
