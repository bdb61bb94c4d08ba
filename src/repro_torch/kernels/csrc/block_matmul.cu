// WORKER-PRODUCT kernel for the staged backend, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/block_matmul.py::matmul_t_pallas: one worker's
// coded block product
//
//     C = A^T B                      A (v, r), B (v, t) -> C (r, t)
//
// What bounds it: FP64 (or FP32) operations, 2*r*t*v of them (1.28e11 at the
// paper's 8000^2 geometry, per worker) against 0.38 GB of operands, so the
// FP64 tensor cores set the floor (1.9 ms at 67 TFLOP/s).  The design is the
// main loop of dmma_gemm.cuh with plain operand loads: one block per 128x128
// output tile walks v 16 rows at a time through a 4-stage cp.async ring (one
// barrier per step; the stage refilled is the one the previous step read),
// and multiplies each stage on the FP64 tensor cores (mma.sync m16n8k8,
// FP64 accumulators; FP32 on CUDA-core FMAs, never TF32).  The transposed LHS
// needs no transpose: a (16 x 128) tile of A is 16 row segments of A, copied
// contraction-first as the fragments read it.  Every edge is zero-filled by
// the copies, not padded (4000 fits no power of two).

#include <cuda_runtime.h>

#include <cstdint>

#include "dmma_gemm.cuh"

namespace {

using namespace dmma_gemm;

constexpr int kBK = 16;     // contraction rows per stage
constexpr int kStages = 4;  // depth of the copy ring

template <typename T>
constexpr size_t smem_bytes() {
  return 2ull * kStages * kBK * kPitch * sizeof(T);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
matmul_t_kernel(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ out, long long v, long long r, long long t,
                long long lda, long long ldb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = kBK * kPitch;
  T* a_s = reinterpret_cast<T*>(smem);  // [kStages][kBK][kPitch]
  T* b_s = a_s + kStages * kStage;      // [kStages][kBK][kPitch]

  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long t0 = static_cast<long long>(blockIdx.x) * kBN;
  const long long steps = (v + kBK - 1) / kBK;

  auto load = [&](long long step) {
    const long long v0 = step * kBK;
    const int s = static_cast<int>(step % kStages);
    load_tile<T, kVec, kBK>(a_s + s * kStage, A + v0 * lda + r0, lda, v - v0, r - r0, tid);
    load_tile<T, kVec, kBK>(b_s + s * kStage, B + v0 * ldb + t0, ldb, v - v0, t - t0, tid);
  };

  // One copy group per step (empty past the end), so wait<kStages - 2>
  // always means "this step's tiles have landed".
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    async_copy::commit();
  }
  Tile<T> acc(tid);
  for (long long step = 0; step < steps; ++step) {
    async_copy::wait<kStages - 2>();
    __syncthreads();  // this step's tiles visible; the last step's product done
    if (step + kStages - 1 < steps) load(step + kStages - 1);
    async_copy::commit();
    const int s = static_cast<int>(step % kStages);
    acc.template multiply<kBK>(a_s + s * kStage, b_s + s * kStage);
  }
  async_copy::wait<0>();
  acc.store(out, r0, t0, r, t);
}

template <typename T>
int launch(const T* A, const T* B, T* out, long long v, long long r,
           long long t, long long lda, long long ldb, int copy_bytes,
           void* stream) {
  if (r < 1 || t < 1 || v < 0 || (r + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((t + kBN - 1) / kBN),
                  static_cast<unsigned>((r + kBM - 1) / kBM));
  const size_t bytes = smem_bytes<T>();
  if (copy_bytes == 16) {
    const auto misaligned = (reinterpret_cast<std::uintptr_t>(A) |
                             reinterpret_cast<std::uintptr_t>(B) |
                             static_cast<std::uintptr_t>(lda * sizeof(T)) |
                             static_cast<std::uintptr_t>(ldb * sizeof(T))) % 16;
    if (misaligned) return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_kernel(matmul_t_kernel<T, 16 / sizeof(T)>, grid, bytes, stream,
                         A, B, out, v, r, t, lda, ldb);
  }
  if (copy_bytes == static_cast<int>(sizeof(T))) {
    return launch_kernel(matmul_t_kernel<T, 1>, grid, bytes, stream, A, B, out,
                         v, r, t, lda, ldb);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// A (v, r) with row stride lda, B (v, t) with row stride ldb, both with unit
// column stride; out (r, t) contiguous.  copy_bytes is 16 (every pointer and
// row stride a 16-byte multiple) or the element size.  Returns the
// cudaError_t of the launch.
extern "C" int repro_matmul_t_f64(const double* A, const double* B,
                                  double* out, long long v, long long r,
                                  long long t, long long lda, long long ldb,
                                  int copy_bytes, void* stream) {
  return launch<double>(A, B, out, v, r, t, lda, ldb, copy_bytes, stream);
}

extern "C" int repro_matmul_t_f32(const float* A, const float* B, float* out,
                                  long long v, long long r, long long t,
                                  long long lda, long long ldb, int copy_bytes,
                                  void* stream) {
  return launch<float>(A, B, out, v, r, t, lda, ldb, copy_bytes, stream);
}
