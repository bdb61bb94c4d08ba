// Coded-matmul DECODE kernel with fused digit extraction, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/coded_decode.py::decode_pallas.  Computes
//
//     X = W @ Y                       W (mn, K) panel, Y (K, E) worker outputs
//     R = rint(X)                     half-to-even, like jnp.round/torch.round
//     C = R - floor(R / s) * s        mod s into [0, s)
//     C = C > s/2 ? C - s : C         recentre into (-s/2, s/2]
//
// (with extract == 0 only the rounding applies: the baseline polynomial code).
//
// What bounds it: device-memory bytes.  It reads Y once (K*E values) and
// writes C once (mn*E values) for only 2*mn*K operations per column, far
// below the card's operations-per-byte balance.  The design streams Y with
// coalesced loads (neighbouring threads on neighbouring columns), keeps the
// small panel W resident in shared memory and the mn partial sums in
// registers, and runs the extraction in registers, so X never reaches device
// memory.  The panel, the base s and the extract flag are runtime data: a new
// erasure pattern is a new W and never a rebuild.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;       // useful rows held in registers per pass
constexpr int kLoads = 8;       // worker rows of Y loaded together
constexpr int kMaxGrid = 4096;  // blocks; a grid-stride loop covers the rest

// Round half to even (never CUDA round(), which rounds halves away from 0).
__device__ __forceinline__ double round_even(double x) { return rint(x); }
__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }

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
    for (int u0 = 0; u0 < mn; u0 += kRows) {
      T x[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) x[u] = T(0);
      for (int k0 = 0; k0 < K; k0 += kLoads) {
        // kLoads independent loads in flight before the sums consume them
        T y[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          y[j] = k0 + j < K ? Y[static_cast<long long>(k0 + j) * E + e] : T(0);
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          if (k0 + j >= K) break;
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            if (u0 + u < mn) x[u] += w_s[(u0 + u) * K + k0 + j] * y[j];
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
          out[static_cast<long long>(u0 + u) * E + e] = c;
        }
      }
    }
  }
}

template <typename T>
int launch(const T* W, const T* Y, T* out, int mn, int K, long long E, T s,
           int extract, void* stream) {
  const size_t smem = static_cast<size_t>(mn) * K * sizeof(T);
  if (mn < 1 || K < 1 || E < 1 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (E + kThreads - 1) / kThreads;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  decode_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(W, Y, out, mn, K, E,
                                                          s, extract);
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
