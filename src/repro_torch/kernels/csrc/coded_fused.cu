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
// float64 / float32, one block a tile (the tile form; in float64 for
// the calls the cluster form below does not take).  What bounds it: FP64
// (or FP32) operations, 2*K*r*t*v of them (1.28e12 at the paper's 8000^2
// geometry, 19 ms at the FP64 tensor peak), and behind them the raw-tile
// traffic: a block reads P + Q raw tiles for every coded pair it
// multiplies, 0.25 B per FLOP from L2 at P = Q = 4 and a 128x128 tile (some
// 335 GB at the main shape), four times kernel 5's, and the shared-memory
// work of the encode: those two, not the tensor cores, hold the kernel.
// Design: the main loop of dmma_gemm.cuh (128x128 output tile, 8 warps,
// FP64 on the tensor cores with mma.sync m16n8k8, FP32 on CUDA-core FMAs,
// never TF32) with the encode fused in.  A block owns one (worker, output
// tile) and walks v 8 rows at a time.  Each step's raw tiles - up to kGroup
// blocks of each operand - arrive through a 2-stage cp.async ring; all
// threads form the coded tiles shared-to-shared (16-byte vectors,
// coefficients broadcast from shared memory) into one of two coded pairs,
// and the step's product runs in the next barrier interval, beside the next
// step's encode: one barrier per step.  Half the warps multiply before they
// encode and half after, so each SM sub-partition has one warp on its
// tensor core while the other works the shared-memory pipe.  P or Q above
// kGroup are walked in groups of kGroup that accumulate into the coded
// pair.  The grid puts the worker on the fastest axis, so the K blocks of
// one output tile run together and share their raw tiles through L2.
// Blocks are passed as a base pointer, one element offset per block and a
// row stride, so strided views (block_decompose) need no copy; ragged edges
// are zero-filled by the copies.
//
// float64, the cluster form: 16-byte copies, at most kGroup raw blocks a
// side and two output tiles or more along both r and t (coded_fused.py's
// `clustered`; every other call keeps the form above).  What bounded the
// form above there, per 8-row step of a block at P = Q = 4: 64 KB of raw
// tiles from L2 for 262,144 FLOP, and about 1,536 cycles of shared-memory
// traffic (raw tiles in 512, encode reads 512, coded writes 128, DMMA
// fragments 384) against about 1,024 cycles of DMMA.  A probe on an H100
// (K = 10, v = r = t = 4000) took 76.2 ms at P = Q = 4 and 59.2 ms at P = Q
// = 1 (a quarter of the raw bytes and of the encode) against 31.2 ms for
// ten kernel 5 calls: the raw tiles and the encode cost some 5.7 ms a raw
// block a side, the 8-row loop around them the rest.  Design: a cluster of
// 2 x 2 blocks (cudaLaunchKernelEx, cluster dimension 4) owns one worker's
// 256 x 256 super-tile, the workers on the grid's fastest axis over
// super-tiles.  The four blocks need only two coded A and two coded B
// tiles, so each loads and encodes one half of one of each (half the L2
// bytes and half the encode a block) and stores the coded halves into its
// own shared memory and, through distributed shared memory, into the one
// peer that reads them (st.async, counted off by the peer's mbarrier: no
// fence a step).  The raw vectors go from L2 straight into registers, a
// sub-step ahead, so shared memory carries only the coded tiles; steps are
// 24 rows (three 8-row sub-steps, a vector of each raw half tile a thread a
// sub-step: 32 registers) under one __syncthreads and one barrier wait; the
// coded ring is 3 deep, so a step's product runs beside the next step's
// encode and a peer's halves of a step release the slot two steps back.
// Measured on the H100 at the main shape: 51.2 ms (37% of the FP64 tensor
// peak) against 76.4 ms for the form above, bit for bit the same output;
// 30 clusters fit at once, 120 of the 132 SMs.
//
// bf16 / f16 with 16-byte aligned operands (the TMA form).  The bf16 tensor
// cores take the product's 2*K*r*t*v operations in 1.3 ms at the main
// shape; the encode is the heavier half.  Per coded element it takes one
// FP32 FMA per raw block (the sums must match kernel 4's FMA chain bit for
// bit, so they cannot run on the tensor cores), which at a 128x128 tile
// and P = Q = 4 is 1/16 of the product's multiply-adds on CUDA cores that
// run at 1/16 of the tensor rate, plus a widening per raw element and a
// rounding per coded one.  Design: the main loop of wgmma_gemm.cuh with
// the encode fused in, a block per (128x128 output tile, PAIR of workers),
// the pairs on the grid's fastest axis so that the five pairs of a tile
// share their raw tiles through L2.  The producer warp's lanes issue one
// TMA box each (a single thread issuing a stage's 16 boxes in turn paced
// the loads), 32 rows of v a stage into a 2-stage raw ring (64 KB a stage
// at P = Q = 4); each raw tile arrives once for both workers.  Both
// consumer warpgroups encode a stage elementwise (raw and coded tiles share
// one swizzled layout), reading each raw 16-byte vector once for both
// workers with the block count unrolled, into a 2-stage coded ring, and
// fence the stores to the async proxy; warpgroup w then multiplies worker
// w's coded pair (two m64n128k16 bands, 128 FP32 accumulators a thread)
// while the next step is encoded.  P or Q above kGroup take the 16-row
// plan, whose FP32 partial sums wait in shared memory between groups of
// kGroup raw blocks.  An odd K (or K = 1) leaves the last block's second
// warpgroup encoding for its partner only.  The one-element form (a
// stride TMA cannot describe) keeps the mma.sync loop above with plain
// 2-byte loads.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "dmma_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace dmma_gemm;
using accum::acc_t;

constexpr int kMaxBlocks = 64;  // block offsets by value, and the TMA form's most blocks
constexpr int kGroup = 4;       // raw blocks of each operand per stage
constexpr int kStages = 2;      // depth of the copy ring

// Contraction rows per ring stage: 8, or 16 for 2-byte elements (their
// one-element form here), whose MMA steps are 16 deep.
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

// Offsets and coefficients of nb blocks a side, the raw-tile ring, two
// coded pairs and (bf16/f16) their partial sums.  nb is kMaxBlocks, or P
// and Q rounded up to 16 where they exceed it (the ring stays 16-byte
// aligned); then the blocks' offsets come from device memory.
template <typename T>
constexpr size_t smem_bytes(int nb = kMaxBlocks) {
  return 2ull * nb * (sizeof(long long) + sizeof(acc_t<T>)) +
         (2ull * kGroup * kStages + 4) * kTile<T> * sizeof(T) +
         4ull * kPartialTile<T> * sizeof(acc_t<T>);
}
static_assert(smem_bytes<__nv_bfloat16>() <= 232448, "the opt-in shared-memory limit");

inline int head_blocks(int P, int Q) {
  const int n = P > Q ? P : Q;
  return n <= kMaxBlocks ? kMaxBlocks : (n + 15) / 16 * 16;
}

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

// kHead: kMaxBlocks (offsets by value, the head of compile-time size the
// main path runs) or 0 (the head sized by nb at run time, offsets from
// `offs`).  A run-time head puts every shared-memory address of the main
// loop at a run-time offset, which slowed the float64 kernel on an H100.
template <typename T, typename Out, int kVec, int kHead>
__global__ void __launch_bounds__(kThreads, 1)
fused_worker_kernel(const T* __restrict__ ca, const T* __restrict__ cb,
                    const T* __restrict__ a, const T* __restrict__ b,
                    Out* __restrict__ out, BlockOffsets a_off, BlockOffsets b_off,
                    const long long* __restrict__ offs, int nb,
                    int K, int P, int Q, long long v, long long r, long long t,
                    long long a_sv, long long b_sv) {
  using Acc = acc_t<T>;
  constexpr int kBK = kBKOf<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int head = kHead ? kHead : nb;
  long long* aoff_s = reinterpret_cast<long long*>(smem);
  long long* boff_s = aoff_s + head;
  Acc* ca_s = reinterpret_cast<Acc*>(boff_s + head);
  Acc* cb_s = ca_s + head;
  T* raw_s = reinterpret_cast<T*>(cb_s + head);  // [kStages][2 * kGroup][tile]: A, then B
  T* coded_s = raw_s + kStages * 2 * kGroup * kTile<T>;  // [2][A, B][tile]
  Acc* partial_s = reinterpret_cast<Acc*>(coded_s + 4 * kTile<T>);  // [2][A, B][partial tile]

  const int tid = threadIdx.x;
  const long long k = blockIdx.x % K;  // worker on the fastest axis
  const long long tile = blockIdx.x / K;
  const long long tiles_t = (t + kBN - 1) / kBN;
  const long long r0 = (tile / tiles_t) * kBM;
  const long long t0 = (tile % tiles_t) * kBN;
  // block offsets by value (kHead), else from `offs`: A's P, then B's Q
  if constexpr (kHead != 0) {
    if (tid < P) {
      ca_s[tid] = accum::widen(ca[k * P + tid]);
      aoff_s[tid] = a_off.v[tid];
    }
    if (tid < Q) {
      cb_s[tid] = accum::widen(cb[k * Q + tid]);
      boff_s[tid] = b_off.v[tid];
    }
  } else {
    for (int i = tid; i < P; i += kThreads) {
      ca_s[i] = accum::widen(ca[k * P + i]);
      aoff_s[i] = offs[i];
    }
    for (int i = tid; i < Q; i += kThreads) {
      cb_s[i] = accum::widen(cb[k * Q + i]);
      boff_s[i] = offs[P + i];
    }
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

// ---- float64: the cluster form -----------------------------------------------

constexpr int kHalf = kBM / 2;      // columns of a half tile
constexpr int kClusterBlocks = 4;   // a 2 x 2 cluster: one worker's 256 x 256 super-tile
constexpr int kSubRows = 8;         // rows of a sub-step: one 16-byte vector of every raw
                                    // half tile a thread
constexpr int kSubSteps = 3;        // sub-steps a step (one __syncthreads, one wait)
constexpr int kStepRows = kSubSteps * kSubRows;
constexpr int kDepth = 3;           // coded slots: a step's product lags its encode by one
constexpr int kCodedTile = kStepRows * kPitch;  // doubles in a coded tile
// a coded ring of kDepth (A, B) pairs of whole tiles ([kStepRows][kPitch]
// each, as Tile<double> reads them), the worker's coefficients, and a
// barrier a slot that counts the bytes of the peers' halves
constexpr size_t kClusterSmemBytes =
    sizeof(double) * (kDepth * 2 * kCodedTile + 2 * kGroup) + sizeof(uint64_t) * kDepth;
static_assert(kSubRows * kHalf / 2 == kThreads, "one vector a thread");
static_assert(kClusterSmemBytes <= 232448, "the opt-in shared-memory limit");

// The 16 bytes at p (16-byte aligned) into registers, past L1: zeros where
// the row is past v, only the first element where one column is left.
__device__ __forceinline__ double2 load_raw(const double* p, bool row_in, long long cols_left) {
  double2 x = make_double2(0.0, 0.0);
  if (row_in && cols_left >= 2) {
    x = __ldcg(reinterpret_cast<const double2*>(p));
  } else if (row_in && cols_left == 1) {
    x.x = __ldcg(p);
  }
  return x;
}

// A coded vector = sum_{j < n} coef[j] * x[j], encode<double>'s FMA chain
// (from zero, the blocks in order), written at `local` (this block's coded
// tile) and at the same place of the peer's (`remote`, a shared::cluster
// address), whose barrier `bar` counts its bytes.
__device__ __forceinline__ void encode_vector(double* local, uint32_t remote, uint32_t bar,
                                              const double2 (&x)[kGroup], const double* coef,
                                              int n) {
  double s0 = 0.0;
  double s1 = 0.0;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (j < n) {
      const double w = coef[j];
      s0 += w * x[j].x;
      s1 += w * x[j].y;
    }
  }
  *reinterpret_cast<double2*>(local) = make_double2(s0, s1);
  async_copy::store_peer(remote, s0, s1, bar);
}

// A cluster of four blocks owns worker k's super-tile of 2 x 2 output tiles;
// block (i, j) = (rank / 2, rank % 2) the tile (r_i, t_j).  Of the coded
// tiles its product needs, A(r_i) is shared with block (i, 1 - j) and B(t_j)
// with block (1 - i, j), so it loads and encodes only half of each: columns
// [64 j, 64 j + 64) of r_i's P raw A tiles and [64 i, 64 i + 64) of t_j's Q
// raw B tiles.  Each thread loads one 16-byte vector of every raw half tile
// a sub-step straight into registers, a sub-step ahead (addressed from the
// block offsets in the kernel's parameters), encodes it, and stores the
// coded vector into its block's coded slot and, asynchronously, into that
// of the peer that reads it; the slot's barrier there counts the bytes.
// Step s's product waits for the peers' halves of step s and runs in the
// interval of step s + 1's encode, a sub-step at a time.  A peer's halves of
// step s also tell that it has multiplied step s - 2 (before its
// __syncthreads of step s), so once they have landed this block may
// overwrite the peer's slot of step s - 2 with step s + 1: kDepth = 3
// slots, and no barrier for the slot's release.  This block's own halves
// are ordered by its one __syncthreads a step.  P and Q are at most kGroup;
// blocks past r or t load zeros, encode and store for their peers, and
// write no output.
__global__ void __launch_bounds__(kThreads, 1)
fused_worker_cluster_kernel(const double* __restrict__ ca, const double* __restrict__ cb,
                            const double* __restrict__ a, const double* __restrict__ b,
                            double* __restrict__ out, BlockOffsets a_off, BlockOffsets b_off,
                            int K, int P, int Q, long long v, long long r, long long t,
                            long long a_sv, long long b_sv) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* coded_s = reinterpret_cast<double*>(smem);  // [kDepth][A, B][kStepRows][kPitch]
  double* ca_s = coded_s + kDepth * 2 * kCodedTile;
  double* cb_s = ca_s + kGroup;
  uint64_t* full = reinterpret_cast<uint64_t*>(cb_s + kGroup);  // [kDepth]

  const int tid = threadIdx.x;
  const uint32_t rank = async_copy::cluster_rank();
  const int i = static_cast<int>(rank >> 1);
  const int j = static_cast<int>(rank & 1);
  const long long cluster = blockIdx.x / kClusterBlocks;
  const long long k = cluster % K;  // worker on the fastest axis
  const long long super = cluster / K;
  const long long supers_t = ((t + kBN - 1) / kBN + 1) / 2;
  const long long r0 = (super / supers_t * 2 + i) * kBM;
  const long long t0 = (super % supers_t * 2 + j) * kBN;
  // this thread's vector of each half tile: row `row` of a sub-step,
  // columns col, col + 1 of the half; A's half starts at column ra, B's at tb
  const int row = tid / (kHalf / 2);
  const int col = tid % (kHalf / 2) * 2;
  const long long ra = r0 + j * kHalf + col;
  const long long tb = t0 + i * kHalf + col;
  if (tid < P) ca_s[tid] = ca[k * P + tid];
  if (tid < Q) cb_s[tid] = cb[k * Q + tid];
  if (tid == 0) {
    for (int d = 0; d < kDepth; ++d) async_copy::barrier_init(&full[d]);
    async_copy::fence_barrier_init();
  }
  // every block's barriers are set up before any peer stores into it
  async_copy::cluster_arrive();
  async_copy::cluster_wait();

  // the peers: (i, 1 - j) shares A(r_i), (1 - i, j) shares B(t_j)
  const uint32_t peer_a = rank ^ 1;
  const uint32_t peer_b = rank ^ 2;
  const int at_a = row * kPitch + j * kHalf + col;               // in a slot's A tile
  const int at_b = kCodedTile + row * kPitch + i * kHalf + col;  // in its B tile
  const uint32_t coded_a = async_copy::peer_address(coded_s + at_a, peer_a);
  const uint32_t coded_b = async_copy::peer_address(coded_s + at_b, peer_b);
  const uint32_t full_a = async_copy::peer_address(full, peer_a);
  const uint32_t full_b = async_copy::peer_address(full, peer_b);
  constexpr uint32_t kSlotBytes = 2 * kCodedTile * sizeof(double);
  constexpr uint32_t kSubBytes = kSubRows * kPitch * sizeof(double);
  constexpr uint32_t kPeerBytes = 2 * kStepRows * kHalf * sizeof(double);  // a step's

  const long long steps = (v + kStepRows - 1) / kStepRows;
  double2 xa[kGroup];
  double2 xb[kGroup];
  auto fetch = [&](long long sub) {
    const long long vr = sub * kSubRows + row;
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (p < P) xa[p] = load_raw(a + a_off.v[p] + vr * a_sv + ra, vr < v, r - ra);
      if (p < Q) xb[p] = load_raw(b + b_off.v[p] + vr * b_sv + tb, vr < v, t - tb);
    }
  };
  // sub-step h of step `step` into its slot (rows past v as zeros)
  auto encode = [&](long long step, int h) {
    const int d = static_cast<int>(step % kDepth);
    double* c = coded_s + d * 2 * kCodedTile + h * kSubRows * kPitch;
    const uint32_t at = d * kSlotBytes + h * kSubBytes;
    const uint32_t bar = d * sizeof(uint64_t);
    encode_vector(c + at_a, coded_a + at, full_a + bar, xa, ca_s, P);
    encode_vector(c + at_b, coded_b + at, full_b + bar, xb, cb_s, Q);
  };
  Tile<double> acc(tid);
  auto product = [&](long long step, int h) {
    const double* c =
        coded_s + static_cast<int>(step % kDepth) * 2 * kCodedTile + h * kSubRows * kPitch;
    acc.multiply<kSubRows>(c, c + kCodedTile);
  };
  auto wait = [&](long long step) {  // the peers' halves of `step` have landed
    async_copy::barrier_wait(&full[step % kDepth], static_cast<uint32_t>(step / kDepth) & 1);
  };

  if (steps > 0) fetch(0);
  for (long long step = 0; step < steps; ++step) {
    __syncthreads();  // this block's halves of the earlier steps visible, their slots read
    // announce the peers' bytes of this step (the slot's last phase was
    // waited on before the __syncthreads above)
    if (tid == 0) async_copy::arrive_expect_bytes(&full[step % kDepth], kPeerBytes);
    if (step > 0) wait(step - 1);
#pragma unroll
    for (int h = 0; h < kSubSteps; ++h) {
      encode(step, h);
      const long long next = step * kSubSteps + h + 1;
      if (next < steps * kSubSteps) fetch(next);
      if (step > 0) product(step - 1, h);
    }
  }
  if (steps > 0) {
    __syncthreads();  // this block's halves of the last step
    wait(steps - 1);
#pragma unroll
    for (int h = 0; h < kSubSteps; ++h) product(steps - 1, h);
  }
  // no block leaves while a peer may still store into it
  async_copy::cluster_arrive();
  if (r0 < r && t0 < t) acc.store(out + k * r * t, r0, t0, r, t);
  async_copy::cluster_wait();
}

// ---- bf16 / f16: the TMA form ------------------------------------------------

constexpr int kPairWorkers = 2;  // workers per block, one per consumer warpgroup
constexpr int kLayoutHead = 12;  // rank, v_dim, dims[5], strides[5] (see coded_fused.py)

// A block grid as one tensor map: dimension 0 is r (or t) within a block,
// dimension v_dim is v; the others index the grid.  coord[p] holds block
// p's coordinates in dimensions 1..rank-1 (0 at v_dim).
struct Grid {
  int rank;
  int v_dim;
  int coord[kMaxBlocks][wgmma_gemm::kMaxRank - 1];
};

// The shared-memory plan of the TMA form: kTK contraction rows a stage, a
// raw ring of kStages stages and two coded stages (a step's products read
// one while the next step's encode writes the other).  A tile is 128 x kTK
// elements as two 64-wide TMA boxes; raw and coded tiles share that
// swizzled layout, so the encode is elementwise over 16-byte vectors.
// P, Q <= kGroup take 32-row stages (64 KB of raw tiles at P = Q = 4; TMA
// moves boxes under 4 KB at fewer bytes a cycle), two deep: what paces the
// kernel is the encode, not the ring (three raw stages beside one coded
// stage ran no faster on an H100).  Above kGroup, 16-row stages, four
// deep, beside the FP32 partial sums that wait in shared memory between
// groups of kGroup raw blocks.
template <int kTK, int kStages>
struct Plan {
  static constexpr bool kGrouped = kTK < 32;
  static constexpr int kBoxBytes = wgmma_gemm::kBox * kTK * 2;
  static constexpr int kTileBytes = 2 * kBoxBytes;
  static constexpr int kVecs = kTileBytes / 16;                        // per tile
  static constexpr int kVecsPerThread = kVecs / (2 * wgmma_gemm::kWarpgroup);
  static constexpr int kRawBytes = 2 * kGroup * kTileBytes;            // A tiles, then B
  static constexpr int kCodedBytes = kPairWorkers * 2 * kTileBytes;    // [worker][A, B]
  static constexpr int kPartialBytes = kGrouped ? 2 * kPairWorkers * kVecs * 32 : 0;
  static constexpr size_t kSmemBytes =
      wgmma_gemm::kAlign + kStages * kRawBytes + 2 * kCodedBytes + kPartialBytes +
      2 * kPairWorkers * kMaxBlocks * sizeof(float) +
      2 * kMaxBlocks * wgmma_gemm::kMaxRank * sizeof(int8_t) + 2 * kStages * sizeof(uint64_t);
  static_assert(kSmemBytes <= 232448, "the opt-in shared-memory limit");
  static_assert(kVecsPerThread >= 1, "every consumer thread encodes");
};

// The two workers' coded tiles (+)= sum_{j < kN} c[w][j] * raw[j] at this
// consumer thread's 16-byte vector `at` of a tile, from the vector's kN raw
// values x, read once for both workers.  FP32 sums in registers within a
// group of raw blocks; `first` starts them from zero, `last` rounds them
// once to T into the coded tiles (two elements a conversion, each to
// nearest even), and between groups (the grouped plan) they wait in
// `partial` ([worker][vector][2] float4).  The arithmetic is accum.cuh's
// encode chain, which kernel 4's 16-byte form runs too.
template <typename T, bool kGrouped, int kN>
__device__ __forceinline__ void encode_pair(unsigned char* __restrict__ coded0,
                                            unsigned char* __restrict__ coded1,
                                            float4* __restrict__ partial,
                                            const uint4 (&x)[kN], int vecs,
                                            const float (&c0)[kGroup],
                                            const float (&c1)[kGroup], bool first,
                                            bool last, int at) {
  float s[2][8];  // the two workers' sums
  if (!kGrouped || first) {
#pragma unroll
    for (int l = 0; l < 8; ++l) s[0][l] = s[1][l] = 0.0f;
  } else {
    const float4* p0 = partial + 2 * at;
    const float4* p1 = partial + 2 * (vecs + at);
    const float4 lo0 = p0[0], hi0 = p0[1], lo1 = p1[0], hi1 = p1[1];
    s[0][0] = lo0.x; s[0][1] = lo0.y; s[0][2] = lo0.z; s[0][3] = lo0.w;
    s[0][4] = hi0.x; s[0][5] = hi0.y; s[0][6] = hi0.z; s[0][7] = hi0.w;
    s[1][0] = lo1.x; s[1][1] = lo1.y; s[1][2] = lo1.z; s[1][3] = lo1.w;
    s[1][4] = hi1.x; s[1][5] = hi1.y; s[1][6] = hi1.z; s[1][7] = hi1.w;
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float c[2] = {c0[j], c1[j]};
    accum::fma8<T, 2>(s, c, x[j]);
  }
  if (!kGrouped || last) {
    uint4 y[2];
    accum::round8<T, 2>(s, y);
    reinterpret_cast<uint4*>(coded0)[at] = y[0];
    reinterpret_cast<uint4*>(coded1)[at] = y[1];
  } else {
    float4* p0 = partial + 2 * at;
    float4* p1 = partial + 2 * (vecs + at);
    p0[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
    p0[1] = make_float4(s[0][4], s[0][5], s[0][6], s[0][7]);
    p1[0] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
    p1[1] = make_float4(s[1][4], s[1][5], s[1][6], s[1][7]);
  }
}

// encode_pair over this thread's vectors of a tile from kN raw blocks: all
// the vectors' loads issued before the first sum consumes them.
template <typename T, typename L, int kN>
__device__ __forceinline__ void encode_tile(unsigned char* __restrict__ coded0,
                                            unsigned char* __restrict__ coded1,
                                            float4* __restrict__ partial,
                                            const unsigned char* __restrict__ raw,
                                            const float (&c0)[kGroup],
                                            const float (&c1)[kGroup], bool first,
                                            bool last, int ctid) {
  uint4 x[L::kVecsPerThread][kN];
#pragma unroll
  for (int i = 0; i < L::kVecsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      x[i][j] = reinterpret_cast<const uint4*>(raw + j * L::kTileBytes)
          [ctid + i * 2 * wgmma_gemm::kWarpgroup];
    }
#pragma unroll
  for (int i = 0; i < L::kVecsPerThread; ++i) {
    encode_pair<T, L::kGrouped, kN>(coded0, coded1, partial, x[i], L::kVecs, c0, c1, first,
                                    last, ctid + i * 2 * wgmma_gemm::kWarpgroup);
  }
}

// encode_tile for the group's n (1 to kGroup) raw blocks.
template <typename T, typename L>
__device__ __forceinline__ void encode_group(unsigned char* coded0, unsigned char* coded1,
                                             float4* partial, const unsigned char* raw,
                                             const float (&c0)[kGroup],
                                             const float (&c1)[kGroup], int n, bool first,
                                             bool last, int ctid) {
  static_assert(kGroup == 4, "one instance per block count");
  switch (n) {
    case 1:
      encode_tile<T, L, 1>(coded0, coded1, partial, raw, c0, c1, first, last, ctid);
      break;
    case 2:
      encode_tile<T, L, 2>(coded0, coded1, partial, raw, c0, c1, first, last, ctid);
      break;
    case 3:
      encode_tile<T, L, 3>(coded0, coded1, partial, raw, c0, c1, first, last, ctid);
      break;
    default:
      encode_tile<T, L, 4>(coded0, coded1, partial, raw, c0, c1, first, last, ctid);
      break;
  }
}

// A box's coordinates: x0 in dimension 0, v0 at v_dim (-1 in the block's
// row of the coordinate table), the block's grid coordinates elsewhere.
__device__ __forceinline__ void box_coords(int (&c)[wgmma_gemm::kMaxRank],
                                           const int8_t* coord, int x0, int v0) {
  c[0] = x0;
#pragma unroll
  for (int d = 1; d < wgmma_gemm::kMaxRank; ++d) c[d] = coord[d] < 0 ? v0 : coord[d];
}

// A block owns one output tile (128 x 128) for a pair of workers 2 * pair +
// {0, 1}: the producer warp brings each step's raw tiles (a group of up to
// kGroup blocks of A and of B, kTK rows) into the raw ring, one TMA box a
// lane; the consumer warpgroups encode them into the coded ring (both
// workers at once), then warpgroup w multiplies worker w's coded pair with
// wgmma while the next step is encoded.  An odd K leaves the last block's
// second warpgroup encoding for its partner only.
template <typename T, typename Out, int kTK, int kStages>
__global__ void __launch_bounds__(wgmma_gemm::kThreads, 1)
fused_worker_tma_kernel(const T* __restrict__ ca, const T* __restrict__ cb,
                        const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ Grid a_grid,
                        const __grid_constant__ Grid b_grid,
                        Out* __restrict__ out, int K, int P, int Q, long long v,
                        long long r, long long t, bool pairs) {
  namespace wg = wgmma_gemm;
  using L = Plan<kTK, kStages>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* raw_s = wg::aligned_smem(smem_raw);              // [kStages][raw stage]
  unsigned char* coded_s = raw_s + kStages * L::kRawBytes;        // [2][worker][A, B][tile]
  float4* partial_s = reinterpret_cast<float4*>(coded_s + 2 * L::kCodedBytes);  // [A, B][..]
  float* ca_s = reinterpret_cast<float*>(coded_s + 2 * L::kCodedBytes + L::kPartialBytes);
  float* cb_s = ca_s + kPairWorkers * kMaxBlocks;                 // [worker][block]
  uint64_t* full = reinterpret_cast<uint64_t*>(cb_s + kPairWorkers * kMaxBlocks);
  uint64_t* empty = full + kStages;
  // [A, B][block][dimension]: each block's box coordinates, -1 at v_dim
  int8_t* coord_s = reinterpret_cast<int8_t*>(empty + kStages);

  const int pairs_k = (K + 1) / 2;
  const int pair = static_cast<int>(blockIdx.x % pairs_k);  // workers on the fastest axis
  const long long tile = blockIdx.x / pairs_k;
  const long long tiles_t = (t + kBN - 1) / kBN;
  const int r0 = static_cast<int>(tile / tiles_t * kBM);
  const int t0 = static_cast<int>(tile % tiles_t * kBN);
  for (int i = threadIdx.x; i < kPairWorkers * kMaxBlocks; i += blockDim.x) {
    const int k = 2 * pair + i / kMaxBlocks;
    const int p = i % kMaxBlocks;
    ca_s[i] = k < K && p < P ? accum::widen(ca[k * P + p]) : 0.0f;
    cb_s[i] = k < K && p < Q ? accum::widen(cb[k * Q + p]) : 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * kMaxBlocks * wg::kMaxRank; i += blockDim.x) {
    const Grid& g = i < kMaxBlocks * wg::kMaxRank ? a_grid : b_grid;
    const int p = i / wg::kMaxRank % kMaxBlocks;
    const int d = i % wg::kMaxRank;
    coord_s[i] = static_cast<int8_t>(d == 0 ? 0 : d == g.v_dim ? -1 : g.coord[p][d - 1]);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      async_copy::barrier_init(&full[s]);
      async_copy::barrier_init(&empty[s], 2 * wg::kWarpgroup / 32);  // one per consumer warp
    }
    async_copy::fence_barrier_init();
  }
  __syncthreads();

  // One item per (v step, group of raw blocks); a step's coded tiles are
  // complete after its last group.
  const int groups = max((P + kGroup - 1) / kGroup, (Q + kGroup - 1) / kGroup);
  const int items = static_cast<int>((v + kTK - 1) / kTK) * groups;
  const int k_steps = static_cast<int>((v + wg::kStep - 1) / wg::kStep);

  if (threadIdx.x < wg::kWarpgroup) {  // the producer warp
    wg::regs_dec<wg::kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane >= 32) return;
    if (lane == 0) {
      async_copy::prefetch_map(&a_map);
      async_copy::prefetch_map(&b_map);
    }
    const int a_rank = a_grid.rank;
    const int b_rank = b_grid.rank;
    int slot = 0;
    uint32_t phase = 0;
    for (int item = 0; item < items; ++item) {
      const int v0 = item / groups * kTK;
      const int p0 = item % groups * kGroup;
      const int na = max(0, min(kGroup, P - p0));
      const int nb = max(0, min(kGroup, Q - p0));
      async_copy::barrier_wait(&empty[slot], phase ^ 1);
      if (lane == 0) async_copy::arrive_expect_bytes(&full[slot], (na + nb) * L::kTileBytes);
      // A stage is 2 (na + nb) boxes, A's then B's, box i from lane i: one
      // thread issuing them in turn would pace the kernel.  Each branch
      // names its tensor map itself (a map chosen at run time would reach
      // TMA as a generic address).
      unsigned char* s = raw_s + slot * L::kRawBytes;
      const int h = lane % 2;  // the box's half of its tile
      int c[wg::kMaxRank];
      if (lane < 2 * na) {
        const int j = lane / 2;
        box_coords(c, coord_s + (p0 + j) * wg::kMaxRank, r0 + h * wg::kBox, v0);
        async_copy::tensor_copy(s + j * L::kTileBytes + h * L::kBoxBytes, &a_map, &full[slot],
                                a_rank, c);
      } else if (lane < 2 * (na + nb)) {
        const int j = lane / 2 - na;
        box_coords(c, coord_s + (kMaxBlocks + p0 + j) * wg::kMaxRank, t0 + h * wg::kBox, v0);
        async_copy::tensor_copy(s + (kGroup + j) * L::kTileBytes + h * L::kBoxBytes, &b_map,
                                &full[slot], b_rank, c);
      }
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // the consumers: warpgroup w multiplies worker 2 * pair + w
  wg::regs_inc<wg::kConsumerRegs>();
  const int ctid = threadIdx.x - wg::kWarpgroup;
  const int w = ctid / wg::kWarpgroup;
  const int wtid = ctid % wg::kWarpgroup;
  const bool active = 2 * pair + w < K;
  float acc[2][64];  // rows 64 * band + [0, 64) of the tile
#pragma unroll
  for (int band = 0; band < 2; ++band)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[band][i] = 0.0f;
  // the group's coefficients of both workers, in registers: once for the
  // one-group plan, per group for the grouped one
  float ca0[kGroup], ca1[kGroup], cb0[kGroup], cb1[kGroup];
  auto coefficients = [&](int p0) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      ca0[j] = ca_s[p0 + j];
      ca1[j] = ca_s[kMaxBlocks + p0 + j];
      cb0[j] = cb_s[p0 + j];
      cb1[j] = cb_s[kMaxBlocks + p0 + j];
    }
  };
  if (!L::kGrouped) coefficients(0);
  int slot = 0;
  uint32_t phase = 0;
  for (int item = 0; item < items; ++item) {
    const int step = item / groups;
    const int g = item % groups;
    const int p0 = g * kGroup;
    if (L::kGrouped) coefficients(p0);
    async_copy::barrier_wait(&full[slot], phase);
    const unsigned char* s = raw_s + slot * L::kRawBytes;
    unsigned char* coded = coded_s + (step & 1) * L::kCodedBytes;
    if (p0 < P) {
      encode_group<T, L>(coded, coded + 2 * L::kTileBytes, partial_s, s, ca0, ca1,
                         min(kGroup, P - p0), g == 0, p0 + kGroup >= P, ctid);
    }
    if (p0 < Q) {
      encode_group<T, L>(coded + L::kTileBytes, coded + 3 * L::kTileBytes,
                         partial_s + 4 * L::kVecs, s + kGroup * L::kTileBytes, cb0, cb1,
                         min(kGroup, Q - p0), g == 0, p0 + kGroup >= Q, ctid);
    }
    __syncwarp();
    if (ctid % 32 == 0) async_copy::arrive(&empty[slot]);
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
    if (g != groups - 1) continue;
    // The step's coded tiles are complete: publish them to the async proxy,
    // let the last step's products finish in both warpgroups (the next
    // step's encode overwrites their tiles), then multiply this step while
    // the next one is encoded.
    async_copy::fence_proxy_async();
    wg::mma_wait<0>();
    wg::fence_operand(acc[0]);
    wg::fence_operand(acc[1]);
    wg::consumers_sync();
    if (active) {
      const unsigned char* a_t = coded + 2 * w * L::kTileBytes;
      const unsigned char* b_t = a_t + L::kTileBytes;
      const int n = min(kTK / wg::kStep, k_steps - step * (kTK / wg::kStep));
      wg::mma_fence();
#pragma unroll
      for (int k = 0; k < kTK / wg::kStep; ++k) {
        if (k < n) {
          const uint64_t db = wg::smem_desc(b_t + k * wg::kStepBytes, L::kBoxBytes);
#pragma unroll
          for (int band = 0; band < 2; ++band) {
            wg::mma<T>(acc[band],
                       wg::smem_desc(a_t + band * L::kBoxBytes + k * wg::kStepBytes,
                                     L::kBoxBytes),
                       db);
          }
        }
      }
      wg::mma_commit();
    }
  }
  wg::mma_wait<0>();
  wg::fence_operand(acc[0]);
  wg::fence_operand(acc[1]);
  if (active) {
    Out* y = out + (2 * pair + w) * r * t;
#pragma unroll
    for (int band = 0; band < 2; ++band) {
      wg::store(y, acc[band], r0 + 64 * band, t0, r, t, pairs, wtid);
    }
  }
}

// The TMA form's launch.  a_layout / b_layout (HOST arrays, coded_fused.py's
// tma_layout packed): rank, v_dim, dims[5], strides[5] in bytes, then each
// block's coordinates in dimensions 1..4.
template <typename T, typename Out, int kTK, int kStages>
int launch_tma(const T* ca, const T* cb, const T* a, const T* b, Out* out,
               const long long* a_layout, const long long* b_layout, int K, int P, int Q,
               long long v, long long r, long long t, void* stream) {
  namespace wg = wgmma_gemm;
  CUtensorMap maps[2] = {};
  Grid grids[2] = {};
  const long long* layouts[2] = {a_layout, b_layout};
  const T* bases[2] = {a, b};
  const int blocks[2] = {P, Q};
  for (int o = 0; o < 2; ++o) {
    const long long* l = layouts[o];
    if (l == nullptr || l[0] < 2 || l[0] > wg::kMaxRank || l[1] < 1 || l[1] >= l[0]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    grids[o].rank = static_cast<int>(l[0]);
    grids[o].v_dim = static_cast<int>(l[1]);
    for (int p = 0; p < blocks[o]; ++p)
      for (int d = 0; d < wg::kMaxRank - 1; ++d)
        grids[o].coord[p][d] = static_cast<int>(l[kLayoutHead + (wg::kMaxRank - 1) * p + d]);
    int box[wg::kMaxRank];
    for (int d = 0; d < grids[o].rank; ++d) {
      box[d] = d == 0 ? wg::kBox : d == grids[o].v_dim ? kTK : 1;
    }
    if (v > 0) {
      const int err = wg::encode_map<T>(&maps[o], bases[o], grids[o].rank, l + 2, l + 7, box);
      if (err != 0) return err;
    }
  }
  const long long tiles = ((r + kBM - 1) / kBM) * ((t + kBN - 1) / kBN);
  const bool pairs = t % 2 == 0 && reinterpret_cast<std::uintptr_t>(out) % (2 * sizeof(Out)) == 0;
  return wg::launch_kernel(fused_worker_tma_kernel<T, Out, kTK, kStages>,
                           dim3(static_cast<unsigned>(tiles * ((K + 1) / 2))),
                           Plan<kTK, kStages>::kSmemBytes, stream, ca, cb, maps[0], maps[1],
                           grids[0], grids[1], out, K, P, Q, v, r, t, pairs);
}

template <typename T, typename Out>
int launch(const void* ca_, const void* cb_, const void* a_, const void* b_, void* out_,
           const long long* a_off, const long long* b_off, const long long* offs_dev,
           const long long* a_tma, const long long* b_tma, int K, int P, int Q,
           long long v, long long r, long long t, long long a_sv, long long b_sv,
           int copy_bytes, void* stream) {
  const T* ca = static_cast<const T*>(ca_);
  const T* cb = static_cast<const T*>(cb_);
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  Out* out = static_cast<Out*>(out_);
  const long long tiles = ((r + kBM - 1) / kBM) * ((t + kBN - 1) / kBN);
  const int nb = head_blocks(P, Q);
  if (P < 1 || Q < 1 || K < 1 || r < 1 || t < 1 || v < 0 || tiles * K > 0x7fffffffLL ||
      (nb > kMaxBlocks && offs_dev == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* offs = nb > kMaxBlocks ? offs_dev : nullptr;
  BlockOffsets ao{};
  BlockOffsets bo{};
  std::uintptr_t misaligned = reinterpret_cast<std::uintptr_t>(a) |
                              reinterpret_cast<std::uintptr_t>(b) |
                              static_cast<std::uintptr_t>(a_sv * sizeof(T)) |
                              static_cast<std::uintptr_t>(b_sv * sizeof(T));
  for (int p = 0; p < P; ++p) {
    if (p < kMaxBlocks) ao.v[p] = a_off[p];
    misaligned |= static_cast<std::uintptr_t>(a_off[p] * sizeof(T));
  }
  for (int q = 0; q < Q; ++q) {
    if (q < kMaxBlocks) bo.v[q] = b_off[q];
    misaligned |= static_cast<std::uintptr_t>(b_off[q] * sizeof(T));
  }
  const dim3 grid(static_cast<unsigned>(tiles * K));
  const size_t bytes = smem_bytes<T>(nb);
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  if (copy_bytes == 16) {
    if (misaligned % 16) return static_cast<int>(cudaErrorMisalignedAddress);
    if constexpr (sizeof(T) == 2) {
      if (nb > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);  // one-element form
      if (P > kGroup || Q > kGroup) {  // the grouped plan: partial sums
        return launch_tma<T, Out, 16, 4>(ca, cb, a, b, out, a_tma, b_tma, K, P, Q, v, r, t,
                                         stream);
      }
      return launch_tma<T, Out, 32, 2>(ca, cb, a, b, out, a_tma, b_tma, K, P, Q, v, r, t,
                                       stream);
    } else {
      auto kernel = nb > kMaxBlocks ? fused_worker_kernel<T, Out, 16 / sizeof(T), 0>
                                    : fused_worker_kernel<T, Out, 16 / sizeof(T), kMaxBlocks>;
      return launch_kernel(kernel, grid, bytes, stream, ca, cb, a, b, out, ao, bo, offs, nb,
                           K, P, Q, v, r, t, a_sv, b_sv);
    }
  }
  if (copy_bytes == static_cast<int>(sizeof(T))) {
    auto kernel = nb > kMaxBlocks ? fused_worker_kernel<T, Out, 1, 0>
                                  : fused_worker_kernel<T, Out, 1, kMaxBlocks>;
    return launch_kernel(kernel, grid, bytes, stream, ca, cb, a, b, out, ao, bo, offs, nb, K,
                         P, Q, v, r, t, a_sv, b_sv);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cluster launch: a 1-D grid of clusters of four blocks.
cudaLaunchConfig_t cluster_config(unsigned blocks, cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kClusterSmemBytes;
  config.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

int launch_cluster(const double* ca, const double* cb, const double* a, const double* b,
                   double* out, const long long* a_off, const long long* b_off, int K, int P,
                   int Q, long long v, long long r, long long t, long long a_sv, long long b_sv,
                   int copy_bytes, void* stream) {
  const long long supers = ((r + kBM - 1) / kBM + 1) / 2 * (((t + kBN - 1) / kBN + 1) / 2);
  const long long blocks = supers * K * kClusterBlocks;
  if (copy_bytes != 16 || P < 1 || Q < 1 || P > kGroup || Q > kGroup || K < 1 || v < 0 ||
      r <= kBM || t <= kBN || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockOffsets ao{};
  BlockOffsets bo{};
  std::uintptr_t misaligned = reinterpret_cast<std::uintptr_t>(a) |
                              reinterpret_cast<std::uintptr_t>(b) |
                              static_cast<std::uintptr_t>(a_sv * sizeof(double)) |
                              static_cast<std::uintptr_t>(b_sv * sizeof(double));
  for (int p = 0; p < P; ++p) {
    ao.v[p] = a_off[p];
    misaligned |= static_cast<std::uintptr_t>(a_off[p] * sizeof(double));
  }
  for (int q = 0; q < Q; ++q) {
    bo.v[q] = b_off[q];
    misaligned |= static_cast<std::uintptr_t>(b_off[q] * sizeof(double));
  }
  if (misaligned % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaFuncSetAttribute(fused_worker_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kClusterSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(static_cast<unsigned>(blocks), &attr, stream);
  err = cudaLaunchKernelEx(&config, fused_worker_cluster_kernel, ca, cb, a, b, out, ao, bo, K,
                           P, Q, v, r, t, a_sv, b_sv);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float64 cluster form: the arguments of repro_fused_worker_f64 (P and
// Q at most 4, copy_bytes 16, more than 128 rows in both r and t; offs_dev,
// a_tma and b_tma unused).
extern "C" int repro_fused_worker_f64_cluster(const void* ca, const void* cb, const void* a,
                                              const void* b, void* out, const long long* a_off,
                                              const long long* b_off, const long long*,
                                              const long long*, const long long*, int K, int P,
                                              int Q, long long v, long long r, long long t,
                                              long long a_sv, long long b_sv, int copy_bytes,
                                              void* stream) {
  return launch_cluster(static_cast<const double*>(ca), static_cast<const double*>(cb),
                        static_cast<const double*>(a), static_cast<const double*>(b),
                        static_cast<double*>(out), a_off, b_off, K, P, Q, v, r, t, a_sv, b_sv,
                        copy_bytes, stream);
}

// How many of the cluster form's clusters the card holds at once, into
// *clusters; returns the cudaError_t of the query.
extern "C" int repro_fused_worker_f64_cluster_occupancy(int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(fused_worker_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kClusterSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(kClusterBlocks, &attr, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, fused_worker_cluster_kernel, &config));
}

// ca (K, P), cb (K, Q) contiguous; block p of A starts at a + a_off[p] (in
// elements) with row stride a_sv and unit column stride, likewise B; out
// (K, r, t) contiguous.  a_off / b_off are HOST arrays; offs_dev (DEVICE,
// A's P offsets then B's Q, or null) is read instead when P or Q exceeds 64
// (then the block offsets and coefficients sit in a larger head of shared
// memory, up to the card's per-block limit; the TMA form takes at most 64
// blocks a side, so bf16/f16 above that need copy_bytes = 2).  copy_bytes is 16
// (both base pointers, every block offset and both row strides 16-byte
// multiples) or the element size.  a_tma / b_tma (HOST arrays, or null) are
// the operands' tensor-map layouts, which the 16-byte form of the _bf16 /
// _f16 entries (TMA) reads.  Returns the cudaError_t of the launch.  The
// _bf16 / _f16 entries accumulate in FP32 and write their input type; the
// _out_f32 ones write the FP32 sums.
#define REPRO_FUSED_WORKER(NAME, T, OUT)                                             \
  extern "C" int NAME(const void* ca, const void* cb, const void* a, const void* b,    \
                      void* out, const long long* a_off, const long long* b_off,       \
                      const long long* offs_dev, const long long* a_tma,               \
                      const long long* b_tma, int K, int P, int Q, long long v,        \
                      long long r, long long t, long long a_sv, long long b_sv,        \
                      int copy_bytes, void* stream) {                                  \
    return launch<T, OUT>(ca, cb, a, b, out, a_off, b_off, offs_dev, a_tma, b_tma, K, P, \
                          Q, v, r, t, a_sv, b_sv, copy_bytes, stream);                 \
  }

REPRO_FUSED_WORKER(repro_fused_worker_f64, double, double)
REPRO_FUSED_WORKER(repro_fused_worker_f32, float, float)
REPRO_FUSED_WORKER(repro_fused_worker_bf16, __nv_bfloat16, __nv_bfloat16)
REPRO_FUSED_WORKER(repro_fused_worker_bf16_out_f32, __nv_bfloat16, float)
REPRO_FUSED_WORKER(repro_fused_worker_f16, __half, __half)
REPRO_FUSED_WORKER(repro_fused_worker_f16_out_f32, __half, float)
