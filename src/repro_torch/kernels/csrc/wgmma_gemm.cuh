// The 16-bit product main loop of kernels 1 (coded_fused.cu) and 5
// (block_matmul.cu) for Hopper (sm_90a): bf16 / f16 operands through the
// Tensor Memory Accelerator, products on wgmma, FP32 sums in registers.
//
// Both kernels compute tiles of C = A^T B from operands that lie
// contraction-first in device memory, A (v, r) and B (v, t).  A producer
// warpgroup keeps TMA loads (cp.async.bulk.tensor) in flight into a ring of
// shared-memory stages, each stage with a "full" mbarrier (the loads' bytes)
// and an "empty" one (the consumers' release).  Two consumer
// warpgroups multiply with wgmma.mma_async m64n128k16, both operands read
// from shared memory; setmaxnreg moves registers from the producer to them
// (128 FP32 accumulators a thread).
//
// Layout.  A TMA box is 64 elements (128 bytes) of r or t by BK rows of v,
// stored with 128-byte swizzle: row k of a box at k * 128 bytes, its 16-byte
// chunk j at chunk j ^ (k % 8), the pattern repeating every 8 rows (1 KB).
// A 128-wide tile is two boxes side by side in shared memory.  Both
// operands are thus "MN-major" for wgmma (the contraction is the slow axis),
// which the 16-bit types read with the instruction's transpose flags set:
// no transpose pass.  A shared-memory descriptor (PTX ISA, "Matrix
// Descriptor Format"; CuTe's canonical GMMA layout ((T,8,m),(8,k)) :
// ((1,T,LBO),(8T,SBO)) for MN-major 128-byte swizzle) names the start
// address, the leading byte offset LBO between 64-element chunks of M or N
// (one box to the next) and the stride byte offset SBO between groups of 8
// contraction rows (1 KB); a step of 16 rows moves the start by 2 KB, a
// multiple of the swizzle's 1 KB period, so every step's descriptor keeps
// base offset 0.  Every box starts on a 1 KB boundary.
//
// Bits.  Every kernel that uses this loop issues the same instruction
// (m64n128k16), chains an element's 16-row dot products in increasing v,
// starts from zeroed accumulators, and issues no step whose 16 rows all lie
// past v; so an element's FP32 sum is the same wherever it is formed, which
// makes the fused product of kernel 1 equal the staged one (kernel 4, then
// kernel 5) bit for bit.
//
// Edges.  A tensor map's dimensions are the block's (not the whole
// matrix's), so box elements past r, t or v arrive as zeros (TMA's
// out-of-bounds fill); the epilogue masks the output's ragged edge and
// rounds the FP32 sums once to the output type (nearest even).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "accum.cuh"
#include "async_copy.cuh"

namespace wgmma_gemm {

constexpr int kWarpgroup = 128;
constexpr int kThreads = 3 * kWarpgroup;  // a producer warpgroup, two consumer warpgroups
constexpr int kBox = 64;                  // elements in a TMA box's 128-byte row
constexpr int kStep = 16;                 // contraction rows per wgmma
constexpr int kStepBytes = kStep * 128;   // a box's 16 rows: the descriptor's step
constexpr int kMaxRank = 5;               // TMA's largest tensor rank
constexpr int kProducerRegs = 40;         // setmaxnreg: 128 x 40 + 256 x 232 <= 64K
constexpr int kConsumerRegs = 232;
constexpr size_t kAlign = 1024;           // the 128-byte swizzle's period

// ---- the producer's side: tensor maps --------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Encode the map of a 2-byte tensor at `base`: dims[0..rank) elements
// (innermost first), strides[1..rank) in bytes (strides[0] unused: unit),
// boxes of box[0..rank) elements with 128-byte swizzle and zero fill.
// Returns a cudaError_t.
template <typename T>
int encode_map(CUtensorMap* map, const void* base, int rank, const long long* dims,
               const long long* strides, const int* box) {
  static_assert(sizeof(T) == 2, "the 16-bit types");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cuuint64_t d[kMaxRank];
  cuuint64_t s[kMaxRank];
  cuuint32_t b[kMaxRank];
  cuuint32_t e[kMaxRank];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    s[i] = static_cast<cuuint64_t>(strides[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    e[i] = 1;
  }
  const CUtensorMapDataType type = std::is_same_v<T, __half>
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult res = encode(map, type, static_cast<cuuint32_t>(rank),
                              const_cast<void*>(base), d, s + 1, b, e,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---- the consumers' side: wgmma --------------------------------------------

// The descriptor of an MN-major operand with 128-byte swizzle whose 64-wide
// chunks lie `lbo` bytes apart, starting at `tile` (a 1 KB-aligned box plus
// a multiple of kStepBytes).
__device__ __forceinline__ uint64_t smem_desc(const void* tile, uint32_t lbo) {
  const uint32_t a = async_copy::smem_address(tile);
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(kAlign >> 4) << 32 |  // SBO: 8 rows of 128 bytes
         1ull << 62;                                 // 128-byte swizzle
}

#define REPRO_WGMMA_M64N128K16(TYPE)                                                   \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "    \
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "    \
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "    \
      "%61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),         \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),       \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),   \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),   \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),   \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                              \
      : "l"(a), "l"(b), "r"(1))

// d (64 x 128, FP32) += A^T B over 16 contraction rows: a and b describe
// MN-major tiles (the transpose flags are set), scale-d is 1.  Thread i of
// the warpgroup holds rows 16 * (i / 32) + (i % 32) / 4 + {0, 8} and
// columns 8 j + 2 (i % 4) + {0, 1} of chunk j: d[4 j + 2 h + e] is row +8h,
// column +e.
template <typename T>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (std::is_same_v<T, __half>) {
    REPRO_WGMMA_M64N128K16("f16");
  } else {
    static_assert(std::is_same_v<T, __nv_bfloat16>, "bf16 or f16");
    REPRO_WGMMA_M64N128K16("bf16");
  }
}
#undef REPRO_WGMMA_M64N128K16

// Make the compiler treat the accumulators as written here, so that no
// read of them moves across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most kPending of this warpgroup's wgmma groups are in flight.
template <int kPending>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A barrier of the two consumer warpgroups alone (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWarpgroup) : "memory");
}

// The start of dynamic shared memory, rounded up to the swizzle's period.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = async_copy::smem_address(raw);
  return raw + ((kAlign - a % kAlign) % kAlign);
}

// ---- the epilogue ------------------------------------------------------------

// Write the 64 x 128 accumulator tile d (warpgroup thread `wtid`) at (r0,
// t0) of the (r, t) output with row stride t, rounded to Out, masking the
// edge.  `pairs`: t is even and out two-element aligned, so neighbouring
// columns go out in one store.
template <typename Out>
__device__ __forceinline__ void store(Out* __restrict__ out, const float (&d)[64],
                                      long long r0, long long t0, long long r, long long t,
                                      bool pairs, int wtid) {
  const long long row = r0 + 16 * (wtid / 32) + (wtid % 32) / 4;
  const long long col = t0 + 2 * (wtid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long rr = row + 8 * h;
    if (rr >= r) continue;
    Out* p = out + rr * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long tt = col + 8 * j;
      const float x = d[4 * j + 2 * h];
      const float y = d[4 * j + 2 * h + 1];
      if (pairs) {
        if (tt < t) {
          using Pair = accum::Pair<Out>;
          *reinterpret_cast<typename Pair::type*>(p + tt) = Pair::of(x, y);
        }
      } else {
        if (tt < t) p[tt] = accum::Cast<Out>::from(x);
        if (tt + 1 < t) p[tt + 1] = accum::Cast<Out>::from(y);
      }
    }
  }
}

// Opt the kernel in to `bytes` of dynamic shared memory and launch it with
// kThreads threads.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, size_t bytes, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The streaming multiprocessors of the current device.
inline int sm_count() {
  int dev = 0;
  int n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 1;
  }
  return n;
}

}  // namespace wgmma_gemm
