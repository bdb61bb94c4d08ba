// The product main loop shared by coded_fused.cu (kernel 1) and
// block_matmul.cu (kernel 5), for Hopper (sm_90a).
//
// One block of 256 threads (8 warps) owns a 128x128 tile of C = A^T B.  Both
// operands lie in shared memory contraction-first, a_s[k][m] and b_s[k][n]:
// the transposed LHS is read as it lies in device memory, with no transpose.
// The pitch is 132 elements: the 4-element pad puts the four k rows that one
// tensor-core fragment reads on different banks (at a pitch of 128 they share
// them), and keeps every row 16-byte aligned for the copies.
//
// FP64 runs on the FP64 tensor cores: each warp owns a 64x32 sub-tile as 4x4
// fragments of mma.sync.m16n8k8.f64 (SASS DMMA), 64 accumulator doubles per
// thread, accumulated in IEEE FP64 (integer partial sums below 2^53 stay
// exact).  m16n8k8 is the smallest f64 shape that reaches the card's FP64
// tensor peak: on an H100 the older m8n8k4 issues at half of it.  What bounds
// the product then is feeding the tensor cores: 24 fragment loads from shared
// memory per 16 DMMA, and one block per SM (the ring fills shared memory), so
// the copy ring, not other blocks, hides the device-memory latency.
// FP32 has no tensor-core path without TF32, which stays off, so each thread
// accumulates an 8x8 micro-tile with FMAs on the CUDA cores.  bf16 and f16
// in the one-element copy form run here on the tensor cores (mma.sync
// m16n8k16, FP32 accumulators, the fragments read by ldmatrix.trans), and
// the tile is written in the output type, rounded to nearest even; their
// 16-byte form runs the Hopper loop of wgmma_gemm.cuh instead.  Their shared-memory pitch is 136 elements
// (272 bytes): 16-byte aligned rows, and the eight rows of an 8x8 matrix on
// distinct banks.
//
// Tiles arrive through cp.async into a multi-stage ring that the kernels
// own.  The copies are 16 bytes wide where the base pointer, every block
// offset and every row stride are 16-byte multiples, one element wide
// otherwise (template parameter kVec, picked by the Python wrapper); rows past
// v and columns past the operand's width are zero-filled by the copy itself
// (source size 0 or short), so ragged edges need no padding.  cp.async has
// no 2-byte copy, so one-element tiles of bf16/f16 are plain loads and
// shared stores (made visible by the barrier that precedes their use).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "accum.cuh"
#include "async_copy.cuh"

namespace dmma_gemm {

constexpr int kBM = 128;          // output rows (r) per block
constexpr int kBN = 128;          // output cols (t) per block
constexpr int kPitch = kBM + 4;   // shared-memory row pitch, in elements
constexpr int kThreads = 256;
static_assert(kBM == kBN, "one tile loader serves both operands");

// The pitch of a shared tile of T: 132 for 8- and 4-byte elements, 136 for
// 2-byte ones (132 of them would be 264 bytes, not a 16-byte multiple).
template <typename T>
constexpr int kPitchOf = sizeof(T) == 2 ? kBM + 8 : kPitch;

// Start copying a (kRows x kBM) tile whose element (0, 0) is `src` (row
// stride ld, unit column stride) into dst[kRows][kPitchOf<T>]: rows at or
// past rows_left and columns at or past cols_left read as zero.  kVec
// elements per copy.
template <typename T, int kVec, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          long long rows_left, long long cols_left,
                                          int tid) {
  constexpr int kPerRow = kBM / kVec;
  constexpr int kCopies = kRows * kPerRow;
  static_assert(kCopies % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kCopies / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    long long n = cols_left - col;
    n = row >= rows_left || n < 0 ? 0 : (n > kVec ? kVec : n);
    if constexpr (kVec * sizeof(T) < 4) {
      static_assert(sizeof(T) == 2 && kVec == 1, "2-byte elements one at a time");
      const auto* s = reinterpret_cast<const unsigned short*>(src);
      reinterpret_cast<unsigned short*>(dst)[row * kPitchOf<T> + col] =
          n ? s[row * ld + col] : static_cast<unsigned short>(0);
    } else {
      async_copy::copy_zfill<static_cast<int>(kVec * sizeof(T))>(
          dst + row * kPitchOf<T> + col, n ? src + row * ld + col : src,
          static_cast<int>(n * sizeof(T)));
    }
  }
}

// ---- the tile product ------------------------------------------------------

template <typename T>
struct Tile;

// FP64 on the tensor cores: warp (wm, wn) of a 2x4 grid owns rows wm*64 +
// [0, 64) and columns wn*32 + [0, 32) of the tile as kMI x kNI m16n8
// fragments.  Fragment layouts (PTX ISA, mma.m16n8k8 .f64), with g = lane/4
// and q = lane%4: A a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4);
// B b0 (q, g), b1 (q+4, g); C c0,c1 (g, 2q+{0,1}), c2,c3 (g+8, 2q+{0,1}).
template <>
struct Tile<double> {
  static constexpr int kMI = 4;
  static constexpr int kNI = 4;
  double c[kMI][kNI][4];
  int m0, n0, g, q;

  __device__ explicit Tile(int tid) {
    const int warp = tid / 32;
    const int lane = tid % 32;
    m0 = (warp / 4) * 64;
    n0 = (warp % 4) * 32;
    g = lane / 4;
    q = lane % 4;
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0;
  }

  __device__ static __forceinline__ void mma(double (&d)[4], const double (&a)[4],
                                             const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }

  // c += a_s^T b_s over kK contraction rows (a_s, b_s: [kK][kPitch]), one
  // 8-row step at a time: unrolled, the steps' fragments spill registers.
  template <int kK>
  __device__ __forceinline__ void multiply(const double* a_s, const double* b_s) {
    static_assert(kK % 8 == 0, "m16n8k8 steps");
#pragma unroll 1
    for (int k0 = 0; k0 < kK; k0 += 8) {
      const double* ap = a_s + (k0 + q) * kPitch + m0 + g;
      const double* bp = b_s + (k0 + q) * kPitch + n0 + g;
      double a[kMI][4];
      double b[kNI][2];
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        a[i][0] = ap[i * 16];
        a[i][1] = ap[i * 16 + 8];
        a[i][2] = ap[4 * kPitch + i * 16];
        a[i][3] = ap[4 * kPitch + i * 16 + 8];
      }
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        b[j][0] = bp[j * 8];
        b[j][1] = bp[4 * kPitch + j * 8];
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma(c[i][j], a[i], b[j]);
    }
  }

  // Write the tile at (r0, t0) of the contiguous (r, t) output, masking the
  // edge.
  template <typename Out>
  __device__ __forceinline__ void store(Out* __restrict__ out, long long r0,
                                        long long t0, long long r, long long t) const {
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long rr = r0 + m0 + i * 16 + g + 8 * h;
        if (rr >= r) continue;
#pragma unroll
        for (int j = 0; j < kNI; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long tt = t0 + n0 + j * 8 + 2 * q + e;
            if (tt < t) out[rr * t + tt] = accum::Cast<Out>::from(c[i][j][2 * h + e]);
          }
      }
  }
};

// FP32 on the CUDA cores: thread (ty, tx) of a 16x16 grid owns rows
// {0, 64} + ty*4 + [0, 4) and columns {0, 64} + tx*4 + [0, 4), read from
// shared memory as float4.
template <>
struct Tile<float> {
  float c[8][8];
  int ty, tx;

  __device__ explicit Tile(int tid) : ty(tid / 16), tx(tid % 16) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;
  }

  __device__ static __forceinline__ void fetch(float (&x)[8], const float* row, int at) {
    const float4 lo = *reinterpret_cast<const float4*>(row + at);
    const float4 hi = *reinterpret_cast<const float4*>(row + 64 + at);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  }

  template <int kK>
  __device__ __forceinline__ void multiply(const float* a_s, const float* b_s) {
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      float a[8];
      float b[8];
      fetch(a, a_s + kk * kPitch, ty * 4);
      fetch(b, b_s + kk * kPitch, tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] += a[i] * b[j];
    }
  }

  template <typename Out>
  __device__ __forceinline__ void store(Out* __restrict__ out, long long r0,
                                        long long t0, long long r, long long t) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long rr = r0 + (i / 4) * 64 + ty * 4 + i % 4;
      if (rr >= r) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long tt = t0 + (j / 4) * 64 + tx * 4 + j % 4;
        if (tt < t) out[rr * t + tt] = accum::Cast<Out>::from(c[i][j]);
      }
    }
  }
};

// bf16 / f16 on the tensor cores: the warp grid of Tile<double> (warp (wm,
// wn) of 2x4 owns rows wm*64 + [0, 64) and columns wn*32 + [0, 32)) as 4x4
// fragments of mma.sync.m16n8k16 with FP32 accumulators (64 a thread).  The
// operands lie contraction-first (a_s[k][m], b_s[k][n]), so each fragment is
// four 8x8 matrices read by ldmatrix.trans: lane l names row l % 8 of matrix
// l / 8, and the transposed load hands thread (g, q) = (l / 4, l % 4) the
// pair (k 2q, 2q + 1) at m (or n) g that the MMA's A and B registers hold.
// A pitch of 136 puts the eight 16-byte rows of a matrix on distinct banks.
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16/.f16): A a0 (g, 2q..2q+1),
// a1 (g+8, ..), a2 (g, 2q+8..), a3 (g+8, 2q+8..); B b0 (2q..2q+1, g), b1
// (2q+8.., g); C c0,c1 (g, 2q+{0,1}), c2,c3 (g+8, 2q+{0,1}).
template <typename T>
struct HalfTile {
  static constexpr int kMI = 4;
  static constexpr int kNI = 4;
  float c[kMI][kNI][4];
  int m0, n0, g, q, lane;

  __device__ explicit HalfTile(int tid) {
    const int warp = tid / 32;
    lane = tid % 32;
    m0 = (warp / 4) * 64;
    n0 = (warp % 4) * 32;
    g = lane / 4;
    q = lane % 4;
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0f;
  }

  // Four transposed 8x8 matrices of 2-byte elements; `row` is this lane's
  // row of its matrix.
  __device__ static __forceinline__ void load_trans(unsigned (&r)[4], const T* row) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
  }

  __device__ static __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    if constexpr (std::is_same_v<T, __half>) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    } else {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }

  // c += a_s^T b_s over kK contraction rows (a_s, b_s: [kK][kPitchOf<T>]).
  template <int kK>
  __device__ __forceinline__ void multiply(const T* a_s, const T* b_s) {
    static_assert(kK % 16 == 0, "m16n8k16 steps");
    constexpr int kP = kPitchOf<T>;
    const int mat = lane / 8;   // this lane names a row of matrix `mat`
    const int row = lane % 8;
#pragma unroll 1
    for (int k0 = 0; k0 < kK; k0 += 16) {
      unsigned a[kMI][4];
      unsigned b[kNI][2];
      // A: matrices (k +0, m +0), (k +0, m +8), (k +8, m +0), (k +8, m +8)
      const T* ap = a_s + (k0 + (mat / 2) * 8 + row) * kP + m0 + (mat % 2) * 8;
#pragma unroll
      for (int i = 0; i < kMI; ++i) load_trans(a[i], ap + i * 16);
      // B: matrices (k +0, n +0), (k +8, n +0), (k +0, n +8), (k +8, n +8)
      const T* bp = b_s + (k0 + (mat % 2) * 8 + row) * kP + n0 + (mat / 2) * 8;
#pragma unroll
      for (int j = 0; j < kNI / 2; ++j) {
        unsigned r[4];
        load_trans(r, bp + j * 16);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma(c[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // Write the tile at (r0, t0) of the contiguous (r, t) output in Out,
  // rounded to nearest even, masking the edge.
  template <typename Out>
  __device__ __forceinline__ void store(Out* __restrict__ out, long long r0,
                                        long long t0, long long r, long long t) const {
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long rr = r0 + m0 + i * 16 + g + 8 * h;
        if (rr >= r) continue;
#pragma unroll
        for (int j = 0; j < kNI; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long tt = t0 + n0 + j * 8 + 2 * q + e;
            if (tt < t) out[rr * t + tt] = accum::Cast<Out>::from(c[i][j][2 * h + e]);
          }
      }
  }
};

template <>
struct Tile<__nv_bfloat16> : HalfTile<__nv_bfloat16> {
  using HalfTile::HalfTile;
};
template <>
struct Tile<__half> : HalfTile<__half> {
  using HalfTile::HalfTile;
};

// Opt the kernel in to `bytes` of dynamic shared memory (above the 48 KB
// default) and launch it.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, size_t bytes, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dmma_gemm
