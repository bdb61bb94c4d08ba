// Coded-matmul ENCODE kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/coded_encode.py::encode_pallas.  Worker k's coded
// block is the coefficient-weighted sum of the P raw blocks,
//
//     out[k] = sum_p coeff[k, p] * block_p          coeff (K, P), block_p (rows, cols)
//
// a skinny (K, P) @ (P, E) product with tiny K and P and huge E = rows * cols.
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

namespace {

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
        T acc[kOutRows];
#pragma unroll
        for (int u = 0; u < kOutRows; ++u) acc[u] = T(0);
        for (int p0 = 0; p0 < P; p0 += kLoads) {
          T x[kLoads];
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            x[j] = p0 + j < P ? src[off_s[p0 + j]] : T(0);
          }
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            if (p0 + j >= P) break;
#pragma unroll
            for (int u = 0; u < kOutRows; ++u) {
              if (k0 + u < K) acc[u] += c_s[(k0 + u) * P + p0 + j] * x[j];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kOutRows; ++u) {
          if (k0 + u < K) dst[(k0 + u) * plane] = acc[u];
        }
      }
    }
  }
}

template <typename T>
int launch(const T* coeff, const T* blocks, T* out, const long long* offsets,
           int K, int P, long long rows, long long cols, long long row_stride,
           void* stream) {
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
// cudaError_t of the launch.
extern "C" int repro_encode_f64(const double* coeff, const double* blocks,
                                double* out, const long long* offsets, int K,
                                int P, long long rows, long long cols,
                                long long row_stride, void* stream) {
  return launch<double>(coeff, blocks, out, offsets, K, P, rows, cols,
                        row_stride, stream);
}

extern "C" int repro_encode_f32(const float* coeff, const float* blocks,
                                float* out, const long long* offsets, int K,
                                int P, long long rows, long long cols,
                                long long row_stride, void* stream) {
  return launch<float>(coeff, blocks, out, offsets, K, P, rows, cols,
                       row_stride, stream);
}
