// Coded-matmul ENCODE kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/coded_encode.py::encode_pallas.  Worker k's coded
// block is the coefficient-weighted sum of the P raw blocks,
//
//     out[k] = sum_p coeff[k, p] * block_p          coeff (K, P), block_p (rows, cols)
//
// a skinny (K, P) @ (P, E) product with tiny K and P and huge E = rows * cols.
//
// bf16 / f16 blocks are summed in FP32 and written in the coefficient type,
// rounded to nearest even.
//
// What bounds it: device-memory bytes.  It reads each raw element once and
// writes K coded elements for 2*K*P operations, about K/8 operations per byte
// read, far below the card's balance.  The blocks arrive as a base pointer,
// one element offset per block and a shared row stride, so the strided views
// block_decompose returns are read in place: no (P, E) stack is copied first
// (the reference package's reshape copies 512 MB per operand at the paper's
// 8000^2 geometry).  The output is the contiguous (K, rows, cols) coded stack.
//
// Two forms, chosen by the wrapper from the layout (coded_fused.encode_width)
// and re-checked here:
//
// - the 16-byte form (bf16 / f16; every block pointer, offset and row stride
//   a 16-byte multiple and cols % 8 == 0): a persistent grid walks the
//   (row, 8-element vector) pairs with its stride.  A thread issues the
//   16-byte loads of all P raw vectors (read-only path) before any sum
//   consumes them, then for each worker forms the 8 FP32 sums (accum.cuh's
//   encode chain, the arithmetic of kernel 1's encode, so the fused product
//   equals the staged one bit for bit) and writes them as one 16-byte
//   streaming store.  The panel sits in shared memory as FP32,
//   widened once per block.  Above kLoads raw blocks the loads go in groups
//   of kLoads, the sums of kWideWorkers workers at once in registers.
// - the one-element form (every other layout, and float64 / float32): one
//   column a thread, the panel in shared memory in the input type, the
//   loads of up to 8 blocks issued together, kOutRows coded outputs summed
//   in registers per pass.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "accum.cuh"

namespace {

using accum::acc_t;

constexpr int kThreads = 256;
constexpr int kOutRows = 16;     // coded outputs held in registers per pass
constexpr int kLoads = 8;        // raw blocks loaded together
constexpr int kMaxBlocks = 64;   // block offsets by value; more come from device memory
constexpr unsigned kMaxGridX = 1024;
constexpr unsigned kMaxGridY = 65535;
constexpr int kVec = 8;           // elements of a 16-byte vector (16-byte form)
constexpr int kWideWorkers = 4;   // workers summed together above kLoads blocks

struct BlockOffsets {
  long long v[kMaxBlocks];
};

// Rows of the 16-byte form's FP32 panel: K, or K rounded up to
// kWideWorkers for kN = 0 (zero rows past K).
__host__ __device__ constexpr int panel_rows(int K, int kN) {
  return kN == 0 ? (K + kWideWorkers - 1) / kWideWorkers * kWideWorkers : K;
}

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// The dynamic shared memory of a launch: the panel (`panel_bytes`), then
// the P block offsets (where the kernel keeps them there).
__host__ __device__ constexpr size_t smem_for(size_t panel_bytes, int P, bool offsets) {
  return round16(panel_bytes) + (offsets ? static_cast<size_t>(P) * sizeof(long long) : 0);
}

// kStatic: the block offsets (P <= kMaxBlocks, by value) in static shared
// memory, at a compile-time address, as the main path reads them; else
// (from `offs`) after the panel in dynamic shared memory, whose run-time
// address slowed the float64 kernel on an H100.
template <typename T, bool kStatic>
__global__ void __launch_bounds__(kThreads)
encode_element_kernel(const T* __restrict__ coeff, const T* __restrict__ blocks,
                      T* __restrict__ out, BlockOffsets offsets,
                      const long long* __restrict__ offs, int K, int P,
                      long long rows, long long cols, long long row_stride) {
  using Acc = acc_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c_s = reinterpret_cast<T*>(smem_raw);                         // (K, P)
  for (int i = threadIdx.x; i < K * P; i += blockDim.x) c_s[i] = coeff[i];
  __shared__ long long static_off[kStatic ? kMaxBlocks : 1];
  long long* off_s;
  if constexpr (kStatic) {
    off_s = static_off;
    if (threadIdx.x < P) off_s[threadIdx.x] = offsets.v[threadIdx.x];
  } else {
    off_s = reinterpret_cast<long long*>(
        smem_raw + round16(static_cast<size_t>(K) * P * sizeof(T)));  // (P,)
    for (int i = threadIdx.x; i < P; i += blockDim.x) off_s[i] = offs[i];
  }
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

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));  // ld.global.nc.v4
}

__device__ __forceinline__ void store16(void* p, uint4 v) {
  __stcs(static_cast<uint4*>(p), v);  // st.global.cs.v4: evict first
}

// The 16-byte form.  kN (1 to kLoads) raw blocks are all loaded at once and
// stay in registers while the loop runs over the K workers; kN = 0 takes any
// P in groups of kLoads blocks, kWideWorkers workers a pass.  c_s holds the
// panel in FP32, (panel_rows, P).
template <typename T, int kN>
__global__ void __launch_bounds__(kThreads, 2)
encode_vector_kernel(const T* __restrict__ coeff, const T* __restrict__ blocks,
                     T* __restrict__ out, BlockOffsets offsets,
                     const long long* __restrict__ offs, int K, int P, int rows,
                     int vecs, long long row_stride, long long plane) {
  extern __shared__ __align__(16) float c_s[];
  const int panel = panel_rows(K, kN) * P;
  // kN = 0: the P block offsets after the panel (kN > 0 reads them by value)
  long long* off_s = reinterpret_cast<long long*>(
      reinterpret_cast<unsigned char*>(c_s) + round16(static_cast<size_t>(panel) * sizeof(float)));
  for (int i = threadIdx.x; i < panel; i += blockDim.x) {
    c_s[i] = i < K * P ? accum::widen(coeff[i]) : 0.0f;
  }
  if (kN == 0) {
    for (int i = threadIdx.x; i < P; i += blockDim.x) off_s[i] = offs ? offs[i] : offsets.v[i];
  }
  __syncthreads();

  // (row, vec) walks the rows' vectors with the grid's stride, carried
  // without a division per step
  const int stride = gridDim.x * blockDim.x;
  const int step_rows = stride / vecs;
  const int step_vecs = stride % vecs;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int row = first / vecs;
  int vec = first % vecs;
  const long long cols = static_cast<long long>(vecs) * kVec;
  while (row < rows) {
    const T* src = blocks + row * row_stride + vec * kVec;
    T* dst = out + row * cols + vec * kVec;
    if constexpr (kN > 0) {
      uint4 x[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) x[j] = load16(src + offsets.v[j]);
      for (int k = 0; k < K; ++k, dst += plane) {
        const float* c = c_s + k * kN;
        float s[1][8];
#pragma unroll
        for (int l = 0; l < 8; ++l) s[0][l] = 0.0f;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float cj[1] = {c[j]};
          accum::fma8<T, 1>(s, cj, x[j]);
        }
        uint4 y[1];
        accum::round8<T, 1>(s, y);
        store16(dst, y[0]);
      }
    } else {
      for (int k0 = 0; k0 < K; k0 += kWideWorkers) {
        float s[kWideWorkers][8];
#pragma unroll
        for (int w = 0; w < kWideWorkers; ++w)
#pragma unroll
          for (int l = 0; l < 8; ++l) s[w][l] = 0.0f;
        for (int p0 = 0; p0 < P; p0 += kLoads) {
          uint4 x[kLoads];
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            if (p0 + j < P) x[j] = load16(src + off_s[p0 + j]);
          }
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            if (p0 + j >= P) break;
            float c[kWideWorkers];
#pragma unroll
            for (int w = 0; w < kWideWorkers; ++w) c[w] = c_s[(k0 + w) * P + p0 + j];
            accum::fma8<T, kWideWorkers>(s, c, x[j]);
          }
        }
        uint4 y[kWideWorkers];
        accum::round8<T, kWideWorkers>(s, y);
#pragma unroll
        for (int w = 0; w < kWideWorkers; ++w) {
          if (k0 + w < K) store16(dst + (k0 + w) * plane, y[w]);
        }
      }
    }
    vec += step_vecs;
    row += step_rows;
    if (vec >= vecs) {
      vec -= vecs;
      ++row;
    }
  }
}

// A persistent launch of one 16-byte-form instance: as many blocks as fit on
// the card at once, or fewer if the vectors run out first.
template <typename T, int kN>
int launch_vector(const T* coeff, const T* blocks, T* out, const BlockOffsets& off,
                  const long long* offs, int K, int P, long long rows, long long cols,
                  long long row_stride, cudaStream_t stream) {
  const size_t smem =
      smem_for(static_cast<size_t>(panel_rows(K, kN)) * P * sizeof(float), P, kN == 0);
  auto kernel = encode_vector_kernel<T, kN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vecs = cols / kVec;
  const long long needed = (rows * vecs + kThreads - 1) / kThreads;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(needed < fit ? needed : fit);
  kernel<<<grid, kThreads, smem, stream>>>(coeff, blocks, out, off, offs, K, P,
                                           static_cast<int>(rows), static_cast<int>(vecs),
                                           row_stride, rows * cols);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte form's instance for P raw blocks.
template <typename T>
int launch_vector_for(int P, const T* coeff, const T* blocks, T* out, const BlockOffsets& off,
                      const long long* offs, int K, long long rows, long long cols,
                      long long row_stride, cudaStream_t stream) {
  static_assert(kLoads == 8, "one instance per block count");
  switch (P) {
#define REPRO_ENCODE_CASE(N) \
  case N:                    \
    return launch_vector<T, N>(coeff, blocks, out, off, offs, K, P, rows, cols, row_stride, \
                               stream);
    REPRO_ENCODE_CASE(1)
    REPRO_ENCODE_CASE(2)
    REPRO_ENCODE_CASE(3)
    REPRO_ENCODE_CASE(4)
    REPRO_ENCODE_CASE(5)
    REPRO_ENCODE_CASE(6)
    REPRO_ENCODE_CASE(7)
    REPRO_ENCODE_CASE(8)
#undef REPRO_ENCODE_CASE
    default:
      return launch_vector<T, 0>(coeff, blocks, out, off, offs, K, P, rows, cols, row_stride,
                                 stream);
  }
}

// p and p + elems elements of `item` bytes both on 16 bytes.
bool aligned16(const void* p, long long elems, size_t item) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         elems * static_cast<long long>(item) % 16 == 0;
}

// One launch per slab of the K workers (all of them unless the panel
// exceeds the card's per-block shared memory): a worker's coded block is
// the same sum in any slab.  Adds the launches made to *launches.
template <typename T>
int launch(const void* coeff_, const void* blocks_, void* out_, const long long* offsets,
           const long long* offs_dev, int K, int P, long long rows, long long cols,
           long long row_stride, int width, int* launches, void* stream_) {
  const T* coeff = static_cast<const T*>(coeff_);
  const T* blocks = static_cast<const T*>(blocks_);
  T* out = static_cast<T*>(out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (K < 1 || P < 1 || rows < 1 || cols < 1 || (P > kMaxBlocks && offs_dev == nullptr) ||
      (width != 16 && width != static_cast<int>(sizeof(T)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* offs = P > kMaxBlocks ? offs_dev : nullptr;
  BlockOffsets off{};
  for (int p = 0; p < P && p < kMaxBlocks; ++p) off.v[p] = offsets[p];
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vector = width == 16;
  // panel bytes a worker: FP32 in the 16-byte form, T in the element form;
  // slabs of the 16-byte form are whole groups of kWideWorkers
  const size_t per_worker = static_cast<size_t>(P) * (vector ? sizeof(float) : sizeof(T));
  // the offsets: P of them in dynamic shared memory, or kMaxBlocks in the
  // element form's static array
  const size_t head = smem_for(0, P > kMaxBlocks ? P : kMaxBlocks, true) + 16;
  const size_t room = static_cast<size_t>(smem_max) > head ? smem_max - head : 0;
  long long slab = static_cast<long long>(room / per_worker);
  if (vector) slab = slab / kWideWorkers * kWideWorkers;
  if (slab < 1) return static_cast<int>(cudaErrorInvalidValue);  // P alone exceeds it
  const long long plane = rows * cols;
  if (vector) {
    if constexpr (sizeof(T) == 2) {
      if (rows > INT_MAX / 2 || cols / kVec > INT_MAX / 2) {  // the walk counts in int
        return static_cast<int>(cudaErrorInvalidValue);
      }
      bool ok = cols % kVec == 0 && aligned16(blocks, row_stride, sizeof(T)) &&
                aligned16(out, 0, sizeof(T));
      for (int p = 0; p < P; ++p) ok = ok && aligned16(blocks, offsets[p], sizeof(T));
      if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
      for (long long k0 = 0; k0 < K; k0 += slab) {
        const int n = static_cast<int>(K - k0 < slab ? K - k0 : slab);
        err = static_cast<cudaError_t>(launch_vector_for<T>(
            P, coeff + k0 * P, blocks, out + k0 * plane, off, offs, n, rows, cols,
            row_stride, stream));
        if (err != cudaSuccess) return static_cast<int>(err);
        ++*launches;
      }
      return static_cast<int>(cudaSuccess);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  long long gx = (cols + kThreads - 1) / kThreads;
  if (gx > kMaxGridX) gx = kMaxGridX;
  const long long gy = rows < kMaxGridY ? rows : kMaxGridY;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  for (long long k0 = 0; k0 < K; k0 += slab) {
    const int n = static_cast<int>(K - k0 < slab ? K - k0 : slab);
    const bool dynamic = offs != nullptr;
    const size_t smem = smem_for(static_cast<size_t>(n) * P * sizeof(T), P, dynamic);
    auto kernel = dynamic ? encode_element_kernel<T, false> : encode_element_kernel<T, true>;
    // a panel near or above 48 KB: opt in
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        coeff + k0 * P, blocks, out + k0 * plane, off, offs, n, P, rows, cols, row_stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// coeff (K, P) contiguous; block p starts at blocks + offsets[p] (in elements)
// with row stride row_stride and unit column stride; out (K, rows, cols)
// contiguous.  offsets is a HOST array of P entries; offs_dev (DEVICE, or
// null) holds the same and is read instead when P > 64.  width is the
// form: 16 (bf16 / f16 only; cudaErrorMisalignedAddress unless every block
// pointer and the row stride are 16-byte multiples and cols % 8 == 0) or the
// element size (one element a thread).  Adds the kernel launches made (one
// per slab of workers) to *launches (HOST).  Returns the cudaError_t of the
// launches.  The _bf16 / _f16 entries sum in FP32 and write the coefficient
// type, rounded to nearest even.
#define REPRO_ENCODE(NAME, T)                                                      \
  extern "C" int NAME(const void* coeff, const void* blocks, void* out,            \
                      const long long* offsets, const long long* offs_dev, int K,  \
                      int P, long long rows, long long cols, long long row_stride, \
                      int width, int* launches, void* stream) {                    \
    return launch<T>(coeff, blocks, out, offsets, offs_dev, K, P, rows, cols,      \
                     row_stride, width, launches, stream);                         \
  }

REPRO_ENCODE(repro_encode_f64, double)
REPRO_ENCODE(repro_encode_f32, float)
REPRO_ENCODE(repro_encode_bf16, __nv_bfloat16)
REPRO_ENCODE(repro_encode_f16, __half)
