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
// bf16 / f16 inputs accumulate in FP32 and write the input type (or FP32):
// each coded tile is the FP32 sum of its raw tiles, rounded once to the input
// type before the product (on the bf16/f16 tensor cores), as
// ref.fused_worker_ref states.
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
// never TF32; bf16/f16 on the tensor cores with mma.sync m16n8k16 and FP32
// accumulators) with the encode fused in.  A block owns one (worker, output
// tile) and walks v 8 rows at a time (16 for bf16/f16).  Each step's raw tiles - up to kGroup
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
#include <type_traits>

#include "dmma_gemm.cuh"

namespace {

using namespace dmma_gemm;
using accum::acc_t;

constexpr int kMaxBlocks = 64;  // largest P or Q the kernel takes
constexpr int kGroup = 4;       // raw blocks of each operand per stage
constexpr int kStages = 2;      // depth of the copy ring

// Contraction rows per ring stage: 8, or 16 for 2-byte elements, whose
// 16-byte copies cover a 128-wide row in 16 pieces (8 rows would leave half
// the threads without a copy) and whose MMA steps are 16 deep.
template <typename T>
constexpr int kBKOf = sizeof(T) == 2 ? 16 : 8;
// A raw or coded tile [kBK][kPitchOf<T>] of T; for bf16/f16 also a tile of
// FP32 partial sums [kBK][kPitch], which carries a coded tile's sum across
// groups of raw blocks (P or Q above kGroup) until its one rounding.
template <typename T>
constexpr int kTile = kBKOf<T> * kPitchOf<T>;
template <typename T>
constexpr int kPartialTile = std::is_same_v<acc_t<T>, T> ? 0 : kBKOf<T> * kPitch;

struct BlockOffsets {
  long long v[kMaxBlocks];
};

// Offsets, coefficients, the raw-tile ring, two coded pairs and (bf16/f16)
// their partial sums.
template <typename T>
constexpr size_t smem_bytes() {
  return 2ull * kMaxBlocks * (sizeof(long long) + sizeof(acc_t<T>)) +
         (2ull * kGroup * kStages + 4) * kTile<T> * sizeof(T) +
         4ull * kPartialTile<T> * sizeof(acc_t<T>);
}
static_assert(smem_bytes<__nv_bfloat16>() <= 232448, "the opt-in shared-memory limit");

// coded (+)= sum_{j < n} coef[j] * raw[j], over one coded tile, 16 bytes of
// raw elements a thread at a time; `first` starts the sum from zero.
// float64/float32 sum in the coded tile itself.  bf16/f16 sum in FP32: in
// registers within a group, in `partial` across groups, and the group that
// ends the sum (`round`) writes it to the coded tile rounded once to T, as
// ref.fused_worker_ref forms it.
template <typename T>
__device__ __forceinline__ void encode(T* coded, acc_t<T>* partial, const T* raw,
                                       const acc_t<T>* coef, int n, bool first,
                                       bool round, int tid) {
  using Acc = acc_t<T>;
  constexpr bool kWide = !std::is_same_v<Acc, T>;
  constexpr int kN = 16 / sizeof(T);               // raw elements per thread
  constexpr int kAccVecs = kN * sizeof(Acc) / 16;  // 16-byte pieces of their sums
  constexpr int kPerRow = kBM / kN;
  static_assert(kBKOf<T> * kPerRow % kThreads == 0, "whole packs per thread");
#pragma unroll
  for (int i = 0; i < kBKOf<T> * kPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kPerRow;
    const int col = (c % kPerRow) * kN;
    const int at = row * kPitchOf<T> + col;
    uint4* sums;
    if constexpr (kWide) {
      sums = reinterpret_cast<uint4*>(partial + row * kPitch + col);
    } else {
      sums = reinterpret_cast<uint4*>(coded + at);
    }
    union {
      uint4 v[kAccVecs];
      Acc e[kN];
    } acc;
    union {
      uint4 v;
      T e[kN];
    } x;
    if (first) {
#pragma unroll
      for (int l = 0; l < kN; ++l) acc.e[l] = Acc(0);
    } else {
#pragma unroll
      for (int u = 0; u < kAccVecs; ++u) acc.v[u] = sums[u];
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < n) {
        const Acc w = coef[j];
        x.v = *reinterpret_cast<const uint4*>(raw + j * kTile<T> + at);
#pragma unroll
        for (int l = 0; l < kN; ++l) acc.e[l] += w * accum::widen(x.e[l]);
      }
    }
    if (kWide && round) {
#pragma unroll
      for (int l = 0; l < kN; ++l) x.e[l] = accum::Cast<T>::from(acc.e[l]);
      *reinterpret_cast<uint4*>(coded + at) = x.v;
    } else {
#pragma unroll
      for (int u = 0; u < kAccVecs; ++u) sums[u] = acc.v[u];
    }
  }
}

template <typename T, typename Out, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
fused_worker_kernel(const T* __restrict__ ca, const T* __restrict__ cb,
                    const T* __restrict__ a, const T* __restrict__ b,
                    Out* __restrict__ out, BlockOffsets a_off, BlockOffsets b_off,
                    int K, int P, int Q, long long v, long long r, long long t,
                    long long a_sv, long long b_sv) {
  using Acc = acc_t<T>;
  constexpr int kBK = kBKOf<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* aoff_s = reinterpret_cast<long long*>(smem);
  long long* boff_s = aoff_s + kMaxBlocks;
  Acc* ca_s = reinterpret_cast<Acc*>(boff_s + kMaxBlocks);
  Acc* cb_s = ca_s + kMaxBlocks;
  T* raw_s = reinterpret_cast<T*>(cb_s + kMaxBlocks);  // [kStages][2 * kGroup][tile]: A, then B
  T* coded_s = raw_s + kStages * 2 * kGroup * kTile<T>;  // [2][A, B][tile]
  Acc* partial_s = reinterpret_cast<Acc*>(coded_s + 4 * kTile<T>);  // [2][A, B][partial tile]

  const int tid = threadIdx.x;
  const long long k = blockIdx.x % K;  // worker on the fastest axis
  const long long tile = blockIdx.x / K;
  const long long tiles_t = (t + kBN - 1) / kBN;
  const long long r0 = (tile / tiles_t) * kBM;
  const long long t0 = (tile % tiles_t) * kBN;
  if (tid < P) {
    ca_s[tid] = accum::widen(ca[k * P + tid]);
    aoff_s[tid] = a_off.v[tid];
  }
  if (tid < Q) {
    cb_s[tid] = accum::widen(cb[k * Q + tid]);
    boff_s[tid] = b_off.v[tid];
  }
  __syncthreads();

  // One item per (v-step, group of raw blocks); a step's coded pair is
  // multiplied after its last group.
  const int groups = max((P + kGroup - 1) / kGroup, (Q + kGroup - 1) / kGroup);
  const long long items = (v + kBK - 1) / kBK * groups;
  auto stage = [&](long long item) {
    return raw_s + static_cast<int>(item % kStages) * 2 * kGroup * kTile<T>;
  };
  auto load = [&](long long item) {
    const long long v0 = item / groups * kBK;
    const int p0 = static_cast<int>(item % groups) * kGroup;
    T* s = stage(item);
    for (int j = 0; j < kGroup; ++j) {
      if (p0 + j < P) {
        load_tile<T, kVec, kBK>(s + j * kTile<T>, a + aoff_s[p0 + j] + v0 * a_sv + r0,
                                a_sv, v - v0, r - r0, tid);
      }
      if (p0 + j < Q) {
        load_tile<T, kVec, kBK>(s + (kGroup + j) * kTile<T>,
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
    const T* c = coded_s + static_cast<int>(step & 1) * 2 * kTile<T>;
    acc.template multiply<kBK>(c, c + kTile<T>);
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
    T* coded = coded_s + static_cast<int>(step & 1) * 2 * kTile<T>;
    Acc* partial = partial_s + static_cast<int>(step & 1) * 2 * kPartialTile<T>;
    if (p0 < P) {
      encode<T>(coded, partial, s, ca_s + p0, min(kGroup, P - p0), g == 0,
                p0 + kGroup >= P, tid);
    }
    if (p0 < Q) {
      encode<T>(coded + kTile<T>, partial + kPartialTile<T>, s + kGroup * kTile<T>,
                cb_s + p0, min(kGroup, Q - p0), g == 0, p0 + kGroup >= Q, tid);
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

template <typename T, typename Out>
int launch(const void* ca_, const void* cb_, const void* a_, const void* b_, void* out_,
           const long long* a_off, const long long* b_off, int K, int P, int Q,
           long long v, long long r, long long t, long long a_sv, long long b_sv,
           int copy_bytes, void* stream) {
  const T* ca = static_cast<const T*>(ca_);
  const T* cb = static_cast<const T*>(cb_);
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  Out* out = static_cast<Out*>(out_);
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
    return launch_kernel(fused_worker_kernel<T, Out, 16 / sizeof(T)>, grid, bytes,
                         stream, ca, cb, a, b, out, ao, bo, K, P, Q, v, r, t,
                         a_sv, b_sv);
  }
  if (copy_bytes == static_cast<int>(sizeof(T))) {
    return launch_kernel(fused_worker_kernel<T, Out, 1>, grid, bytes, stream, ca, cb,
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
// The _bf16 / _f16 entries accumulate in FP32 and write their input type;
// the _out_f32 ones write the FP32 sums.
#define REPRO_FUSED_WORKER(NAME, T, OUT)                                           \
  extern "C" int NAME(const void* ca, const void* cb, const void* a, const void* b,  \
                      void* out, const long long* a_off, const long long* b_off,     \
                      int K, int P, int Q, long long v, long long r, long long t,    \
                      long long a_sv, long long b_sv, int copy_bytes, void* stream) { \
    return launch<T, OUT>(ca, cb, a, b, out, a_off, b_off, K, P, Q, v, r, t, a_sv,  \
                          b_sv, copy_bytes, stream);                                \
  }

REPRO_FUSED_WORKER(repro_fused_worker_f64, double, double)
REPRO_FUSED_WORKER(repro_fused_worker_f32, float, float)
REPRO_FUSED_WORKER(repro_fused_worker_bf16, __nv_bfloat16, __nv_bfloat16)
REPRO_FUSED_WORKER(repro_fused_worker_bf16_out_f32, __nv_bfloat16, float)
REPRO_FUSED_WORKER(repro_fused_worker_f16, __half, __half)
REPRO_FUSED_WORKER(repro_fused_worker_f16_out_f32, __half, float)
