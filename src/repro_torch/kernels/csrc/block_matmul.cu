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
// 16-bit tensor cores (0.13 ms at 989 TFLOP/s).
//
// float64 / float32: the main loop of dmma_gemm.cuh with plain operand
// loads: one block per 128x128 output tile walks v 16 rows at a time through
// a 4-stage cp.async ring (one barrier per step; the stage refilled is the
// one the previous step read), and multiplies each stage on the FP64 tensor
// cores (mma.sync m16n8k8, FP64 accumulators; FP32 on CUDA-core FMAs, never
// TF32).  The transposed LHS needs no transpose: a (16 x 128) tile of A is 16
// row segments of A, copied contraction-first as the fragments read it.
// Every edge is zero-filled by the copies, not padded (4000 fits no power of
// two).
//
// bf16 / f16 with 16-byte aligned operands (the TMA form): the main loop of
// wgmma_gemm.cuh as a persistent grid, one block per SM walking 128x256
// output tiles (one m64 row band per consumer warpgroup, each band two
// m64n128k16 products per 16 rows) through a 4-stage TMA ring of 64-row
// stages (16 KB of A and 32 KB of B).  A persistent block's next tile loads
// while its consumers write the last one.  The one-element form (a row
// stride that is no 16-byte multiple, which TMA cannot describe) keeps the
// mma.sync tile of dmma_gemm.cuh with plain 2-byte loads.

#include <cuda_runtime.h>

#include <cstdint>

#include "dmma_gemm.cuh"
#include "wgmma_gemm.cuh"

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

// ---- bf16 / f16: the TMA form ------------------------------------------------

constexpr int kTM = 128;  // output rows (r) per tile
constexpr int kTN = 256;  // output cols (t) per tile
constexpr int kTK = 64;   // contraction rows per stage
constexpr int kRing = 4;  // stages
constexpr int kBoxBytes = wgmma_gemm::kBox * kTK * 2;          // 8 KB
constexpr int kABytes = kTM / wgmma_gemm::kBox * kBoxBytes;     // 16 KB
constexpr int kBBytes = kTN / wgmma_gemm::kBox * kBoxBytes;     // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr size_t kTmaSmemBytes =
    wgmma_gemm::kAlign + kRing * kStageBytes + 2 * kRing * sizeof(uint64_t);
static_assert(kTmaSmemBytes <= 232448, "the opt-in shared-memory limit");

template <typename T, typename Out>
__global__ void __launch_bounds__(wgmma_gemm::kThreads, 1)
matmul_t_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map, Out* __restrict__ out,
                    long long v, long long r, long long t, bool pairs) {
  namespace wg = wgmma_gemm;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);  // [kRing][A, B]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * kStageBytes);
  uint64_t* empty = full + kRing;

  const long long tiles_t = (t + kTN - 1) / kTN;
  const long long tiles = (r + kTM - 1) / kTM * tiles_t;
  const int stages = static_cast<int>((v + kTK - 1) / kTK);  // per tile
  const int steps = static_cast<int>((v + wg::kStep - 1) / wg::kStep);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      async_copy::barrier_init(&full[s]);
      async_copy::barrier_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    async_copy::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < wg::kWarpgroup) {  // the producer
    wg::regs_dec<wg::kProducerRegs>();
    if (threadIdx.x != 0) return;
    async_copy::prefetch_map(&a_map);
    async_copy::prefetch_map(&b_map);
    int slot = 0;
    uint32_t phase = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int r0 = static_cast<int>(tile / tiles_t * kTM);
      const int t0 = static_cast<int>(tile % tiles_t * kTN);
      for (int s = 0; s < stages; ++s) {
        async_copy::barrier_wait(&empty[slot], phase ^ 1);
        async_copy::arrive_expect_bytes(&full[slot], kStageBytes);
        unsigned char* a_s = smem + slot * kStageBytes;
        unsigned char* b_s = a_s + kABytes;
        for (int h = 0; h < kTM / wg::kBox; ++h) {
          const int c[wg::kMaxRank] = {r0 + h * wg::kBox, s * kTK};
          async_copy::tensor_copy(a_s + h * kBoxBytes, &a_map, &full[slot], 2, c);
        }
        for (int h = 0; h < kTN / wg::kBox; ++h) {
          const int c[wg::kMaxRank] = {t0 + h * wg::kBox, s * kTK};
          async_copy::tensor_copy(b_s + h * kBoxBytes, &b_map, &full[slot], 2, c);
        }
        if (++slot == kRing) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup `band` owns rows 64 * band + [0, 64) of a tile
  wg::regs_inc<wg::kConsumerRegs>();
  const int band = threadIdx.x / wg::kWarpgroup - 1;
  const int wtid = threadIdx.x % wg::kWarpgroup;
  int slot = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile / tiles_t * kTM;
    const long long t0 = tile % tiles_t * kTN;
    float acc[2][64];  // columns 128 * h + [0, 128)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
    int last = 0;
    for (int s = 0; s < stages; ++s) {
      async_copy::barrier_wait(&full[slot], phase);
      const unsigned char* a_s = smem + slot * kStageBytes + band * kBoxBytes;
      const unsigned char* b_s = smem + slot * kStageBytes + kABytes;
      const int n = min(kTK / wg::kStep, steps - s * (kTK / wg::kStep));
      wg::fence_operand(acc[0]);
      wg::fence_operand(acc[1]);
      wg::mma_fence();
#pragma unroll
      for (int k = 0; k < kTK / wg::kStep; ++k) {
        if (k < n) {
          const uint64_t da = wg::smem_desc(a_s + k * wg::kStepBytes, kBoxBytes);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            wg::mma<T>(acc[h], da,
                       wg::smem_desc(b_s + 2 * h * kBoxBytes + k * wg::kStepBytes,
                                     kBoxBytes));
          }
        }
      }
      wg::mma_commit();
      wg::mma_wait<1>();  // the previous stage's products are done: release it
      if (s > 0 && wtid == 0) async_copy::arrive(&empty[last]);
      last = slot;
      if (++slot == kRing) {
        slot = 0;
        phase ^= 1;
      }
    }
    wg::mma_wait<0>();
    wg::fence_operand(acc[0]);
    wg::fence_operand(acc[1]);
    if (stages > 0 && wtid == 0) async_copy::arrive(&empty[last]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wg::store(out, acc[h], r0 + 64 * band, t0 + 128 * h, r, t, pairs, wtid);
    }
  }
}

// The TMA form's launch: each operand (v, x) with row stride ld is a rank-2
// map whose boxes are 64 x kTK.
template <typename T, typename Out>
int launch_tma(const T* A, const T* B, Out* out, long long v, long long r, long long t,
               long long lda, long long ldb, void* stream) {
  CUtensorMap maps[2] = {};
  if (v > 0) {
    const int box[2] = {wgmma_gemm::kBox, kTK};
    const long long a_dims[2] = {r, v};
    const long long b_dims[2] = {t, v};
    const long long a_strides[2] = {1, lda * static_cast<long long>(sizeof(T))};
    const long long b_strides[2] = {1, ldb * static_cast<long long>(sizeof(T))};
    int err = wgmma_gemm::encode_map<T>(&maps[0], A, 2, a_dims, a_strides, box);
    if (err == 0) err = wgmma_gemm::encode_map<T>(&maps[1], B, 2, b_dims, b_strides, box);
    if (err != 0) return err;
  }
  const long long tiles = (r + kTM - 1) / kTM * ((t + kTN - 1) / kTN);
  const long long blocks = tiles < wgmma_gemm::sm_count() ? tiles : wgmma_gemm::sm_count();
  const bool pairs = t % 2 == 0 && reinterpret_cast<std::uintptr_t>(out) % (2 * sizeof(Out)) == 0;
  return wgmma_gemm::launch_kernel(matmul_t_tma_kernel<T, Out>,
                                   dim3(static_cast<unsigned>(blocks)), kTmaSmemBytes, stream,
                                   maps[0], maps[1], out, v, r, t, pairs);
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
    if constexpr (sizeof(T) == 2) {
      return launch_tma(A, B, out, v, r, t, lda, ldb, stream);
    } else {
      return launch_kernel(matmul_t_kernel<T, Out, 16 / sizeof(T)>, grid, bytes, stream,
                           A, B, out, v, r, t, lda, ldb);
    }
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
// row stride a 16-byte multiple: for bf16/f16 the TMA form) or the element
// size.  Returns the
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
