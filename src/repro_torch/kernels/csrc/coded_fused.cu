// Fused ENCODE + WORKER-PRODUCT kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/coded_fused.py::fused_worker_pallas.  For every
// worker k at once it computes
//
//     Y_k = (sum_p ca[k, p] * A_p)^T (sum_q cb[k, q] * B_q)
//
// straight from the raw blocks A_p (v x r) and B_q (v x t).  The coded tiles
// a~ (BK x BM) and b~ (BK x BN) are formed in shared memory from the P and Q
// raw tiles and the worker's coefficient row (also in shared memory), so the
// coded operands never reach device memory.
//
// What bounds it: FP64 (or FP32) operations, 2*K*r*t*v of them, against a
// few GB of operands.  The design is a plain register-blocked FMA product:
// 256 threads per block, each accumulating a 4x4 micro-tile of the 64x64
// output tile in registers, with fragments read from shared memory (100
// registers, so two blocks share an SM; the tile is tile_gemm.cuh, shared
// with block_matmul.cu).  The encode adds P/BN + Q/BM
// (12.5% at P=Q=4) operations, and each block re-reads its P + Q raw tiles
// from L2 for every v-step; the tensor-core (DMMA / wgmma) and TMA
// versions are later work.
//
// Layout: one block per (worker k, r-tile, t-tile); a loop inside the block
// walks the contraction dimension v (the TPU kernel's sequential innermost
// grid axis).  Blocks are passed as a base pointer, one element offset per
// block and a row stride, so strided views (block_decompose) need no copy.
// Ragged edges are masked in the kernel.  No TF32 anywhere: FP64 runs in
// FP64 with an FP64 accumulator, FP32 in FP32.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

constexpr int kMaxBlocks = 64;  // largest P or Q the kernel takes

struct BlockOffsets {
  long long v[kMaxBlocks];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_worker_kernel(const T* __restrict__ ca, const T* __restrict__ cb,
                    const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, BlockOffsets a_off, BlockOffsets b_off,
                    int P, int Q, long long v, long long r, long long t,
                    long long a_sv, long long b_sv) {
  __shared__ T ca_s[kMaxBlocks];
  __shared__ T cb_s[kMaxBlocks];
  __shared__ long long aoff_s[kMaxBlocks];
  __shared__ long long boff_s[kMaxBlocks];
  __shared__ T a_s[kBK][kBM];
  __shared__ T b_s[kBK][kBN];

  const int tid = threadIdx.x;
  const long long k = blockIdx.z;
  const long long r0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long t0 = static_cast<long long>(blockIdx.x) * kBN;
  if (tid < P) {
    ca_s[tid] = ca[k * P + tid];
    aoff_s[tid] = a_off.v[tid];
  }
  if (tid < Q) {
    cb_s[tid] = cb[k * Q + tid];
    boff_s[tid] = b_off.v[tid];
  }
  __syncthreads();

  const int ty = tid / kColThreads;
  const int tx = tid % kColThreads;
  T acc[kTM][kTN];
  zero(acc);

  // Encode-phase coordinates: column ec of the tile, rows er + kStep * it.
  const int ec = tid % kBM;
  const int er = tid / kBM;
  const bool a_col = r0 + ec < r;
  const bool b_col = t0 + ec < t;
  const int PQ = P > Q ? P : Q;

  for (long long v0 = 0; v0 < v; v0 += kBK) {
    // ENCODE: a~[kk][i] = sum_p ca[k,p] * A_p[v0+kk, r0+i], zero off the
    // edge; likewise b~.  Block p's kIters loads are issued together, so a
    // thread waits for max(P, Q) round trips to L2 per step, not P*kIters.
    T xa[kIters];
    T xb[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      xa[it] = T(0);
      xb[it] = T(0);
    }
    const long long vr = v0 + er;
    for (int p = 0; p < PQ; ++p) {
      if (p < P && a_col) {
        const T c = ca_s[p];
        const T* src = a + aoff_s[p] + vr * a_sv + r0 + ec;
#pragma unroll
        for (int it = 0; it < kIters; ++it) {
          if (vr + it * kStep < v) xa[it] += c * src[it * kStep * a_sv];
        }
      }
      if (p < Q && b_col) {
        const T c = cb_s[p];
        const T* src = b + boff_s[p] + vr * b_sv + t0 + ec;
#pragma unroll
        for (int it = 0; it < kIters; ++it) {
          if (vr + it * kStep < v) xb[it] += c * src[it * kStep * b_sv];
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      a_s[er + it * kStep][ec] = xa[it];
      b_s[er + it * kStep][ec] = xb[it];
    }
    __syncthreads();

    // WORKER PRODUCT: acc += a~^T b~ over this step's kBK rows.
    multiply(a_s, b_s, acc, ty, tx);
    __syncthreads();
  }

  store(out + k * r * t, acc, r0, t0, r, t, ty, tx);
}

template <typename T>
int launch(const T* ca, const T* cb, const T* a, const T* b, T* out,
           const long long* a_off, const long long* b_off, int K, int P, int Q,
           long long v, long long r, long long t, long long a_sv, long long b_sv,
           void* stream) {
  if (P < 1 || Q < 1 || P > kMaxBlocks || Q > kMaxBlocks || K < 1 || r < 1 ||
      t < 1 || K > 65535 || (r + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockOffsets ao{};
  BlockOffsets bo{};
  for (int p = 0; p < P; ++p) ao.v[p] = a_off[p];
  for (int q = 0; q < Q; ++q) bo.v[q] = b_off[q];
  const dim3 grid(static_cast<unsigned>((t + kBN - 1) / kBN),
                  static_cast<unsigned>((r + kBM - 1) / kBM),
                  static_cast<unsigned>(K));
  fused_worker_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ca, cb, a, b, out, ao, bo, P, Q, v, r, t, a_sv, b_sv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ca (K, P), cb (K, Q) contiguous; block p of A starts at a + a_off[p] (in
// elements) with row stride a_sv and unit column stride, likewise B; out
// (K, r, t) contiguous.  a_off / b_off are HOST arrays.  Returns the
// cudaError_t of the launch.
extern "C" int repro_fused_worker_f64(
    const double* ca, const double* cb, const double* a, const double* b,
    double* out, const long long* a_off, const long long* b_off, int K, int P,
    int Q, long long v, long long r, long long t, long long a_sv, long long b_sv,
    void* stream) {
  return launch<double>(ca, cb, a, b, out, a_off, b_off, K, P, Q, v, r, t,
                        a_sv, b_sv, stream);
}

extern "C" int repro_fused_worker_f32(
    const float* ca, const float* cb, const float* a, const float* b,
    float* out, const long long* a_off, const long long* b_off, int K, int P,
    int Q, long long v, long long r, long long t, long long a_sv, long long b_sv,
    void* stream) {
  return launch<float>(ca, cb, a, b, out, a_off, b_off, K, P, Q, v, r, t,
                       a_sv, b_sv, stream);
}
