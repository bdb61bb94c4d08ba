// Coded-matmul ENCODE kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/coded_encode.py::encode_pallas.  Worker k's coded
// block is the coefficient-weighted sum of the P raw blocks,
//
//     out[k] = sum_p coeff[k, p] * block_p          coeff (K, P), block_p (rows, cols)
//
// a skinny (K, P) @ (P, E) product with tiny K and P and huge E = rows * cols.
//
// bf16 / f16 blocks are summed in FP32 (the panel kept in the input type in
// shared memory, each value widened as it is used) and written in the
// coefficient type, rounded to nearest even.
//
// What bounds it: device-memory bytes.  It reads each raw element once and
// writes K coded elements for 2*K*P operations, about K/8 operations per byte
// read, far below the card's balance.  The design keeps the (K, P) panel in
// shared memory and the K sums of one element in registers, and streams the
// blocks with coalesced loads (neighbouring threads on neighbouring columns),
// the loads of up to 8 blocks issued together before the sums consume them.
// The blocks arrive as a base pointer, one element offset per block and a
// shared row stride, so the strided views block_decompose returns are read in
// place: no (P, E) stack is copied first (the reference package's reshape
// copies 512 MB per operand at the paper's 8000^2 geometry).  The output is
// the contiguous (K, rows, cols) coded stack.

#include <cuda_runtime.h>

#include "accum.cuh"

namespace {

using accum::acc_t;

constexpr int kThreads = 256;
constexpr int kOutRows = 16;     // coded outputs held in registers per pass
constexpr int kLoads = 8;        // raw blocks loaded together
constexpr int kMaxBlocks = 64;   // block offsets travel by value
constexpr unsigned kMaxGridX = 1024;
constexpr unsigned kMaxGridY = 65535;
constexpr size_t kMaxPanelBytes = 48 * 1024;

struct BlockOffsets {
  long long v[kMaxBlocks];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ coeff, const T* __restrict__ blocks,
              T* __restrict__ out, BlockOffsets offsets, int K, int P,
              long long rows, long long cols, long long row_stride) {
  using Acc = acc_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c_s = reinterpret_cast<T*>(smem_raw);                         // (K, P)
  for (int i = threadIdx.x; i < K * P; i += blockDim.x) c_s[i] = coeff[i];
  __shared__ long long off_s[kMaxBlocks];
  if (threadIdx.x < P) off_s[threadIdx.x] = offsets.v[threadIdx.x];
  __syncthreads();

  const long long plane = rows * cols;
  const long long col_stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    for (long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         col < cols; col += col_stride) {
      const T* src = blocks + row * row_stride + col;
      T* dst = out + row * cols + col;
      for (int k0 = 0; k0 < K; k0 += kOutRows) {
        Acc acc[kOutRows];
#pragma unroll
        for (int u = 0; u < kOutRows; ++u) acc[u] = Acc(0);
        for (int p0 = 0; p0 < P; p0 += kLoads) {
          Acc x[kLoads];
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            x[j] = p0 + j < P ? accum::widen(src[off_s[p0 + j]]) : Acc(0);
          }
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            if (p0 + j >= P) break;
#pragma unroll
            for (int u = 0; u < kOutRows; ++u) {
              if (k0 + u < K) acc[u] += accum::widen(c_s[(k0 + u) * P + p0 + j]) * x[j];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kOutRows; ++u) {
          if (k0 + u < K) dst[(k0 + u) * plane] = accum::Cast<T>::from(acc[u]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* coeff_, const void* blocks_, void* out_, const long long* offsets,
           int K, int P, long long rows, long long cols, long long row_stride,
           void* stream) {
  const T* coeff = static_cast<const T*>(coeff_);
  const T* blocks = static_cast<const T*>(blocks_);
  T* out = static_cast<T*>(out_);
  const size_t smem = static_cast<size_t>(K) * P * sizeof(T);
  if (K < 1 || P < 1 || P > kMaxBlocks || rows < 1 || cols < 1 ||
      smem > kMaxPanelBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockOffsets off{};
  for (int p = 0; p < P; ++p) off.v[p] = offsets[p];
  long long gx = (cols + kThreads - 1) / kThreads;
  if (gx > kMaxGridX) gx = kMaxGridX;
  const long long gy = rows < kMaxGridY ? rows : kMaxGridY;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  encode_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coeff, blocks, out, off, K, P, rows, cols, row_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeff (K, P) contiguous; block p starts at blocks + offsets[p] (in elements)
// with row stride row_stride and unit column stride; out (K, rows, cols)
// contiguous.  offsets is a HOST array of P entries (P <= 64).  Returns the
// cudaError_t of the launch.  The _bf16 / _f16 entries sum in FP32 and
// write the coefficient type, rounded to nearest even.
#define REPRO_ENCODE(NAME, T)                                                      \
  extern "C" int NAME(const void* coeff, const void* blocks, void* out,            \
                      const long long* offsets, int K, int P, long long rows,      \
                      long long cols, long long row_stride, void* stream) {        \
    return launch<T>(coeff, blocks, out, offsets, K, P, rows, cols, row_stride,    \
                     stream);                                                      \
  }

REPRO_ENCODE(repro_encode_f64, double)
REPRO_ENCODE(repro_encode_f32, float)
REPRO_ENCODE(repro_encode_bf16, __nv_bfloat16)
REPRO_ENCODE(repro_encode_f16, __half)
