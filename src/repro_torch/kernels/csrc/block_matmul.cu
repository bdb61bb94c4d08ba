// WORKER-PRODUCT kernel for the staged backend, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/block_matmul.py::matmul_t_pallas: one worker's
// coded block product
//
//     C = A^T B                      A (v, r), B (v, t) -> C (r, t)
//
// What bounds it: FP64 (or FP32) operations, 2*r*t*v of them (1.28e11 at the
// paper's 8000^2 geometry, per worker) against 0.38 GB of operands, so the
// FP64 tensor cores set the floor (1.9 ms at 67 TFLOP/s); in bf16/f16 the
// 16-bit tensor cores (0.13 ms at 989 TFLOP/s).  The design is the
// main loop of dmma_gemm.cuh with plain operand loads: one block per 128x128
// output tile walks v 16 rows at a time through a 4-stage cp.async ring (one
// barrier per step; the stage refilled is the one the previous step read),
// and multiplies each stage on the FP64 tensor cores (mma.sync m16n8k8,
// FP64 accumulators; FP32 on CUDA-core FMAs, never TF32).  bf16 / f16 run
// on the tensor cores (mma.sync m16n8k16 fed by ldmatrix.trans, FP32
// accumulators, the output rounded to nearest even), at a pitch of 136; a
// one-element copy of a 2-byte type is a plain load.  The
// transposed LHS needs no transpose: a (16 x 128) tile of A is 16 row
// segments of A, copied contraction-first as the fragments read it.  Every edge is zero-filled by
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
  return 2ull * kStages * kBK * kPitchOf<T> * sizeof(T);
}

template <typename T, typename Out, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
matmul_t_kernel(const T* __restrict__ A, const T* __restrict__ B,
                Out* __restrict__ out, long long v, long long r, long long t,
                long long lda, long long ldb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = kBK * kPitchOf<T>;
  T* a_s = reinterpret_cast<T*>(smem);  // [kStages][kBK][kPitchOf<T>]
  T* b_s = a_s + kStages * kStage;      // [kStages][kBK][kPitchOf<T>]

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

template <typename T, typename Out>
int launch(const void* A_, const void* B_, void* out_, long long v, long long r,
           long long t, long long lda, long long ldb, int copy_bytes,
           void* stream) {
  const T* A = static_cast<const T*>(A_);
  const T* B = static_cast<const T*>(B_);
  Out* out = static_cast<Out*>(out_);
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
    return launch_kernel(matmul_t_kernel<T, Out, 16 / sizeof(T)>, grid, bytes, stream,
                         A, B, out, v, r, t, lda, ldb);
  }
  if (copy_bytes == static_cast<int>(sizeof(T))) {
    return launch_kernel(matmul_t_kernel<T, Out, 1>, grid, bytes, stream, A, B, out,
                         v, r, t, lda, ldb);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// A (v, r) with row stride lda, B (v, t) with row stride ldb, both with unit
// column stride; out (r, t) contiguous.  copy_bytes is 16 (every pointer and
// row stride a 16-byte multiple) or the element size.  Returns the
// cudaError_t of the launch.  The _bf16 / _f16 entries accumulate in FP32
// and write their input type; the _out_f32 ones write the FP32 sums.
#define REPRO_MATMUL_T(NAME, T, OUT)                                               \
  extern "C" int NAME(const void* A, const void* B, void* out, long long v,         \
                      long long r, long long t, long long lda, long long ldb,       \
                      int copy_bytes, void* stream) {                               \
    return launch<T, OUT>(A, B, out, v, r, t, lda, ldb, copy_bytes, stream);        \
  }

REPRO_MATMUL_T(repro_matmul_t_f64, double, double)
REPRO_MATMUL_T(repro_matmul_t_f32, float, float)
REPRO_MATMUL_T(repro_matmul_t_bf16, __nv_bfloat16, __nv_bfloat16)
REPRO_MATMUL_T(repro_matmul_t_bf16_out_f32, __nv_bfloat16, float)
REPRO_MATMUL_T(repro_matmul_t_f16, __half, __half)
REPRO_MATMUL_T(repro_matmul_t_f16_out_f32, __half, float)
