// Coded-matmul DECODE kernels with fused digit extraction, for Hopper (sm_90a).
//
// decode_kernel replaces src/repro/kernels/coded_decode.py::decode_pallas.
// It computes
//
//     X = W @ Y                       W (mn, K) panel, Y (K, E) worker outputs
//     R = rint(X)                     half-to-even, like jnp.round/torch.round
//     C = R - floor(R / s) * s        mod s into [0, s)
//     C = C > s/2 ? C - s : C         recentre into (-s/2, s/2]
//
// (with extract == 0 only the rounding applies: the baseline polynomial code).
//
// decode_partial_kernel replaces
// src/repro/kernels/coded_decode.py::decode_partial_pallas: the same decode
// per output-row chunk, chunk q's columns through chunk q's panel W_stack[q].
// The TPU kernel needs equal chunk widths (a (Q, K, Ec) stack); here each
// chunk is a base offset into Y and into the output plus a width, so the
// runtime hands over Y (K, E) as it holds it, with chunks that differ by a
// row, and the kernel writes the (mn, E) result in place: no stacking copy
// and no concatenation.  The (Q, K, Ec) stack is the equal-width case.
//
// What bounds both: device-memory bytes.  They read Y once (K*E values) and
// write C once (mn*E values) for only 2*mn*K operations per column, far below
// the card's operations-per-byte balance.  The design streams Y with
// coalesced loads (neighbouring threads on neighbouring columns, 8 worker
// rows in flight per thread), keeps the small panel resident in shared
// memory and the mn partial sums in registers, and runs the extraction in
// registers, so X never reaches device memory.  Panels, the base s and the
// extract flag are runtime data: a new erasure or progress pattern is a new
// panel and never a rebuild.  Both kernels run one column through the same
// device function, so a chunk decodes bit for bit as decode_kernel would.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;        // useful rows held in registers per pass
constexpr int kLoads = 8;        // worker rows of Y loaded together
constexpr int kMaxGrid = 4096;   // blocks; a grid-stride loop covers the rest
constexpr int kMaxChunks = 128;  // chunk offsets travel by value (< 4 KB)
constexpr size_t kMaxPanelBytes = 48 * 1024;

struct ChunkOffsets {
  long long y[kMaxChunks];      // element offset of chunk q's column 0 in Y
  long long out[kMaxChunks];    // ... and in the output
  long long width[kMaxChunks];  // columns in chunk q
};

// Round half to even (never CUDA round(), which rounds halves away from 0).
__device__ __forceinline__ double round_even(double x) { return rint(x); }
__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }

// One output column: y[k * ys] for the K workers -> out[u * os] for the mn
// useful rows, with the panel w_s (mn, K) in shared memory.
template <typename T>
__device__ __forceinline__ void decode_column(const T* w_s,
                                              const T* __restrict__ y,
                                              long long ys,
                                              T* __restrict__ out,
                                              long long os, int mn, int K,
                                              T s, T half, int extract) {
  for (int u0 = 0; u0 < mn; u0 += kRows) {
    T x[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) x[u] = T(0);
    for (int k0 = 0; k0 < K; k0 += kLoads) {
      // kLoads independent loads in flight before the sums consume them
      T yv[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        yv[j] = k0 + j < K ? y[static_cast<long long>(k0 + j) * ys] : T(0);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        if (k0 + j >= K) break;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (u0 + u < mn) x[u] += w_s[(u0 + u) * K + k0 + j] * yv[j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (u0 + u < mn) {
        T c = round_even(x[u]);
        if (extract) {
          c = c - floor_of(c / s) * s;
          if (c > half) c -= s;
        }
        out[static_cast<long long>(u0 + u) * os] = c;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ W, const T* __restrict__ Y,
              T* __restrict__ out, int mn, int K, long long E, T s,
              int extract) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < mn * K; i += blockDim.x) w_s[i] = W[i];
  __syncthreads();

  const T half = s / T(2);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < E; e += stride) {
    decode_column(w_s, Y + e, E, out + e, E, mn, K, s, half, extract);
  }
}

// Grid (x: columns of a chunk, y: chunk q).  Each block holds only its own
// chunk's panel in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ W_stack, const T* __restrict__ Y,
                      T* __restrict__ out, int mn, int K, ChunkOffsets chunks,
                      long long ys, long long os, T s, int extract) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  const int q = blockIdx.y;
  const T* W = W_stack + static_cast<long long>(q) * mn * K;
  for (int i = threadIdx.x; i < mn * K; i += blockDim.x) w_s[i] = W[i];
  __syncthreads();

  const T half = s / T(2);
  const T* yq = Y + chunks.y[q];
  T* oq = out + chunks.out[q];
  const long long width = chunks.width[q];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < width; e += stride) {
    decode_column(w_s, yq + e, ys, oq + e, os, mn, K, s, half, extract);
  }
}

template <typename T>
int launch(const T* W, const T* Y, T* out, int mn, int K, long long E, T s,
           int extract, void* stream) {
  const size_t smem = static_cast<size_t>(mn) * K * sizeof(T);
  if (mn < 1 || K < 1 || E < 1 || smem > kMaxPanelBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (E + kThreads - 1) / kThreads;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  decode_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(W, Y, out, mn, K, E,
                                                          s, extract);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_partial(const T* W_stack, const T* Y, T* out, int Q, int mn, int K,
                   const long long* y_off, const long long* out_off,
                   const long long* width, long long ys, long long os, T s,
                   int extract, void* stream) {
  const size_t smem = static_cast<size_t>(mn) * K * sizeof(T);
  if (Q < 1 || Q > kMaxChunks || mn < 1 || K < 1 || smem > kMaxPanelBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChunkOffsets chunks{};
  long long widest = 0;
  for (int q = 0; q < Q; ++q) {
    chunks.y[q] = y_off[q];
    chunks.out[q] = out_off[q];
    chunks.width[q] = width[q];
    if (width[q] > widest) widest = width[q];
  }
  if (widest < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (widest + kThreads - 1) / kThreads;
  const long long cap = kMaxGrid / Q > 0 ? kMaxGrid / Q : 1;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(Q));
  decode_partial_kernel<T><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      W_stack, Y, out, mn, K, chunks, ys, os, s, extract);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// W (mn, K), Y (K, E), out (mn, E), all contiguous on the device.
// Returns the cudaError_t of the launch.
extern "C" int repro_decode_f64(const double* W, const double* Y, double* out,
                                int mn, int K, long long E, double s,
                                int extract, void* stream) {
  return launch<double>(W, Y, out, mn, K, E, s, extract, stream);
}

extern "C" int repro_decode_f32(const float* W, const float* Y, float* out,
                                int mn, int K, long long E, double s,
                                int extract, void* stream) {
  return launch<float>(W, Y, out, mn, K, E, static_cast<float>(s), extract,
                       stream);
}

// W_stack (Q, mn, K) contiguous on the device.  Chunk q reads worker k's
// column e at Y[y_off[q] + k * ys + e] and writes useful row u at
// out[out_off[q] + u * os + e], for e < width[q].  y_off / out_off / width are
// HOST arrays of Q entries (Q <= 128).  Returns the cudaError_t of the launch.
extern "C" int repro_decode_partial_f64(const double* W_stack, const double* Y,
                                        double* out, int Q, int mn, int K,
                                        const long long* y_off,
                                        const long long* out_off,
                                        const long long* width, long long ys,
                                        long long os, double s, int extract,
                                        void* stream) {
  return launch_partial<double>(W_stack, Y, out, Q, mn, K, y_off, out_off,
                                width, ys, os, s, extract, stream);
}

extern "C" int repro_decode_partial_f32(const float* W_stack, const float* Y,
                                        float* out, int Q, int mn, int K,
                                        const long long* y_off,
                                        const long long* out_off,
                                        const long long* width, long long ys,
                                        long long os, double s, int extract,
                                        void* stream) {
  return launch_partial<float>(W_stack, Y, out, Q, mn, K, y_off, out_off,
                               width, ys, os, static_cast<float>(s), extract,
                               stream);
}
