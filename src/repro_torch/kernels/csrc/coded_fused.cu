// Fused ENCODE + WORKER-PRODUCT kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/coded_fused.py::fused_worker_pallas.  For every
// worker k at once it computes
//
//     Y_k = (sum_p ca[k, p] * A_p)^T (sum_q cb[k, q] * B_q)
//
// straight from the raw blocks A_p (v x r) and B_q (v x t).  The coded tiles
// are formed in shared memory from the raw tiles and the worker's
// coefficient row (also in shared memory), so the coded operands never reach
// device memory.
//
// What bounds it: FP64 (or FP32) operations, 2*K*r*t*v of them (1.28e12 at
// the paper's 8000^2 geometry, 19 ms at the FP64 tensor peak), and behind
// them the raw-tile traffic: a block reads P + Q raw tiles for every coded
// pair it multiplies, 0.25 B per FLOP from L2 at P = Q = 4 and a 128x128
// tile (some 335 GB at the main shape), four times kernel 5's, and the
// shared-memory work of the encode: those two, not the tensor cores, hold
// the kernel.
//
// Design: the main loop of dmma_gemm.cuh (128x128 output tile, 8 warps,
// FP64 on the tensor cores with mma.sync m16n8k8, FP32 on CUDA-core FMAs,
// never TF32) with the encode fused in.  A block owns one (worker, output
// tile) and walks v 8 rows at a time.  Each step's raw tiles - up to kGroup
// blocks of each operand - arrive through a 2-stage cp.async ring; all
// threads form the coded tiles shared-to-shared (16-byte vectors,
// coefficients broadcast from shared memory) into one of two coded pairs,
// and the step's product runs in the next barrier interval, beside the next
// step's encode: one barrier per step.  Half the warps multiply before they
// encode and half after, so each SM sub-partition has one warp on its tensor
// core while the other works the shared-memory pipe.  P or Q above kGroup
// are walked in groups of kGroup that accumulate into the coded pair.  The
// grid puts the worker on the fastest axis, so the K blocks of one output
// tile run together and share their raw tiles through L2.  Blocks are passed
// as a base pointer, one element offset per block and a row stride, so
// strided views (block_decompose) need no copy; ragged edges are zero-filled
// by the copies.

#include <cuda_runtime.h>

#include <cstdint>

#include "dmma_gemm.cuh"

namespace {

using namespace dmma_gemm;

constexpr int kMaxBlocks = 64;  // largest P or Q the kernel takes
constexpr int kBK = 8;          // contraction rows per ring stage
constexpr int kGroup = 4;       // raw blocks of each operand per stage
constexpr int kStages = 2;      // depth of the copy ring
constexpr int kTile = kBK * kPitch;

struct BlockOffsets {
  long long v[kMaxBlocks];
};

// Offsets, coefficients, the raw-tile ring and two coded pairs.
template <typename T>
constexpr size_t smem_bytes() {
  return 2ull * kMaxBlocks * (sizeof(long long) + sizeof(T)) +
         (2ull * kGroup * kStages + 4) * kTile * sizeof(T);
}

template <typename T>
struct Pack;  // 16 bytes of T
template <>
struct Pack<double> {
  using type = double2;
  static constexpr int n = 2;
};
template <>
struct Pack<float> {
  using type = float4;
  static constexpr int n = 4;
};

// coded (+)= sum_{j < n} coef[j] * raw[j], over one [kBK][kPitch] tile;
// `first` starts the sum from zero.
template <typename T>
__device__ __forceinline__ void encode(T* coded, const T* raw, const T* coef,
                                       int n, bool first, int tid) {
  using V = typename Pack<T>::type;
  constexpr int kN = Pack<T>::n;
  constexpr int kPerRow = kBM / kN;
  static_assert(kBK * kPerRow % kThreads == 0, "whole packs per thread");
#pragma unroll
  for (int i = 0; i < kBK * kPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int at = (c / kPerRow) * kPitch + (c % kPerRow) * kN;
    union {
      V v;
      T e[kN];
    } acc, x;
    if (first) {
#pragma unroll
      for (int l = 0; l < kN; ++l) acc.e[l] = T(0);
    } else {
      acc.v = *reinterpret_cast<const V*>(coded + at);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < n) {
        const T w = coef[j];
        x.v = *reinterpret_cast<const V*>(raw + j * kTile + at);
#pragma unroll
        for (int l = 0; l < kN; ++l) acc.e[l] += w * x.e[l];
      }
    }
    *reinterpret_cast<V*>(coded + at) = acc.v;
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
fused_worker_kernel(const T* __restrict__ ca, const T* __restrict__ cb,
                    const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, BlockOffsets a_off, BlockOffsets b_off,
                    int K, int P, int Q, long long v, long long r, long long t,
                    long long a_sv, long long b_sv) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* aoff_s = reinterpret_cast<long long*>(smem);
  long long* boff_s = aoff_s + kMaxBlocks;
  T* ca_s = reinterpret_cast<T*>(boff_s + kMaxBlocks);
  T* cb_s = ca_s + kMaxBlocks;
  T* raw_s = cb_s + kMaxBlocks;  // [kStages][2 * kGroup][kBK][kPitch]: A, then B
  T* coded_s = raw_s + kStages * 2 * kGroup * kTile;  // [2][A, B][kBK][kPitch]

  const int tid = threadIdx.x;
  const long long k = blockIdx.x % K;  // worker on the fastest axis
  const long long tile = blockIdx.x / K;
  const long long tiles_t = (t + kBN - 1) / kBN;
  const long long r0 = (tile / tiles_t) * kBM;
  const long long t0 = (tile % tiles_t) * kBN;
  if (tid < P) {
    ca_s[tid] = ca[k * P + tid];
    aoff_s[tid] = a_off.v[tid];
  }
  if (tid < Q) {
    cb_s[tid] = cb[k * Q + tid];
    boff_s[tid] = b_off.v[tid];
  }
  __syncthreads();

  // One item per (v-step, group of raw blocks); a step's coded pair is
  // multiplied after its last group.
  const int groups = max((P + kGroup - 1) / kGroup, (Q + kGroup - 1) / kGroup);
  const long long items = (v + kBK - 1) / kBK * groups;
  auto stage = [&](long long item) {
    return raw_s + static_cast<int>(item % kStages) * 2 * kGroup * kTile;
  };
  auto load = [&](long long item) {
    const long long v0 = item / groups * kBK;
    const int p0 = static_cast<int>(item % groups) * kGroup;
    T* s = stage(item);
    for (int j = 0; j < kGroup; ++j) {
      if (p0 + j < P) {
        load_tile<T, kVec, kBK>(s + j * kTile, a + aoff_s[p0 + j] + v0 * a_sv + r0,
                                a_sv, v - v0, r - r0, tid);
      }
      if (p0 + j < Q) {
        load_tile<T, kVec, kBK>(s + (kGroup + j) * kTile,
                                b + boff_s[p0 + j] + v0 * b_sv + t0, b_sv, v - v0,
                                t - t0, tid);
      }
    }
  };

  // Step s's coded pair is coded_s[s % 2]: one barrier per item, and step
  // s's product runs in the barrier interval of step s + 1's first encode.
  // Warps 4-7 multiply before they encode and warps 0-3 after, so the two
  // warps of each SM sub-partition keep its tensor core and its
  // shared-memory pipe busy together.
  Tile<T> acc(tid);
  const bool product_first = tid >= kThreads / 2;
  auto product = [&](long long step) {
    const T* c = coded_s + static_cast<int>(step & 1) * 2 * kTile;
    acc.template multiply<kBK>(c, c + kTile);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) load(s);
    async_copy::commit();
  }
  for (long long item = 0; item < items; ++item) {
    async_copy::wait<kStages - 2>();
    __syncthreads();  // this item's raw tiles and the last encode visible
    if (item + kStages - 1 < items) load(item + kStages - 1);
    async_copy::commit();
    const long long step = item / groups;
    const int g = static_cast<int>(item % groups);
    const bool multiply = g == 0 && step > 0;
    if (multiply && product_first) product(step - 1);
    const int p0 = g * kGroup;
    const T* s = stage(item);
    T* coded = coded_s + static_cast<int>(step & 1) * 2 * kTile;
    if (p0 < P) encode(coded, s, ca_s + p0, min(kGroup, P - p0), g == 0, tid);
    if (p0 < Q) {
      encode(coded + kTile, s + kGroup * kTile, cb_s + p0, min(kGroup, Q - p0), g == 0,
             tid);
    }
    if (multiply && !product_first) product(step - 1);
  }
  if (items > 0) {
    __syncthreads();  // the last coded pair is complete
    product(items / groups - 1);
  }
  async_copy::wait<0>();
  acc.store(out + k * r * t, r0, t0, r, t);
}

template <typename T>
int launch(const T* ca, const T* cb, const T* a, const T* b, T* out,
           const long long* a_off, const long long* b_off, int K, int P, int Q,
           long long v, long long r, long long t, long long a_sv, long long b_sv,
           int copy_bytes, void* stream) {
  const long long tiles = ((r + kBM - 1) / kBM) * ((t + kBN - 1) / kBN);
  if (P < 1 || Q < 1 || P > kMaxBlocks || Q > kMaxBlocks || K < 1 || r < 1 ||
      t < 1 || v < 0 || tiles * K > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockOffsets ao{};
  BlockOffsets bo{};
  std::uintptr_t misaligned = reinterpret_cast<std::uintptr_t>(a) |
                              reinterpret_cast<std::uintptr_t>(b) |
                              static_cast<std::uintptr_t>(a_sv * sizeof(T)) |
                              static_cast<std::uintptr_t>(b_sv * sizeof(T));
  for (int p = 0; p < P; ++p) {
    ao.v[p] = a_off[p];
    misaligned |= static_cast<std::uintptr_t>(a_off[p] * sizeof(T));
  }
  for (int q = 0; q < Q; ++q) {
    bo.v[q] = b_off[q];
    misaligned |= static_cast<std::uintptr_t>(b_off[q] * sizeof(T));
  }
  const dim3 grid(static_cast<unsigned>(tiles * K));
  const size_t bytes = smem_bytes<T>();
  if (copy_bytes == 16) {
    if (misaligned % 16) return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_kernel(fused_worker_kernel<T, 16 / sizeof(T)>, grid, bytes,
                         stream, ca, cb, a, b, out, ao, bo, K, P, Q, v, r, t,
                         a_sv, b_sv);
  }
  if (copy_bytes == static_cast<int>(sizeof(T))) {
    return launch_kernel(fused_worker_kernel<T, 1>, grid, bytes, stream, ca, cb,
                         a, b, out, ao, bo, K, P, Q, v, r, t, a_sv, b_sv);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ca (K, P), cb (K, Q) contiguous; block p of A starts at a + a_off[p] (in
// elements) with row stride a_sv and unit column stride, likewise B; out
// (K, r, t) contiguous.  a_off / b_off are HOST arrays.  copy_bytes is 16
// (both base pointers, every block offset and both row strides 16-byte
// multiples) or the element size.  Returns the cudaError_t of the launch.
extern "C" int repro_fused_worker_f64(
    const double* ca, const double* cb, const double* a, const double* b,
    double* out, const long long* a_off, const long long* b_off, int K, int P,
    int Q, long long v, long long r, long long t, long long a_sv, long long b_sv,
    int copy_bytes, void* stream) {
  return launch<double>(ca, cb, a, b, out, a_off, b_off, K, P, Q, v, r, t,
                        a_sv, b_sv, copy_bytes, stream);
}

extern "C" int repro_fused_worker_f32(
    const float* ca, const float* cb, const float* a, const float* b,
    float* out, const long long* a_off, const long long* b_off, int K, int P,
    int Q, long long v, long long r, long long t, long long a_sv, long long b_sv,
    int copy_bytes, void* stream) {
  return launch<float>(ca, cb, a, b, out, a_off, b_off, K, P, Q, v, r, t,
                       a_sv, b_sv, copy_bytes, stream);
}
