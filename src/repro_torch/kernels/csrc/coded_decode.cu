// Coded-matmul DECODE kernels with fused digit extraction, for Hopper (sm_90a).
//
// decode_kernel (kernel 2) replaces
// src/repro/kernels/coded_decode.py::decode_pallas.  It computes
//
//     X = W @ Y                       W (mn, K) panel, Y (K, E) worker outputs
//     R = rint(X)                     half-to-even, like jnp.round/torch.round
//     C = R - floor(R / s) * s        mod s into [0, s)
//     C = C > s/2 ? C - s : C         recentre into (-s/2, s/2]
//
// (with extract == 0 only the rounding applies: the baseline polynomial code).
//
// decode_partial_kernel (kernel 3) replaces
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
// the card's operations-per-byte balance.  Every row of Y is read, also a
// row whose panel column is 0: the caller zeroes erased rows first, and a NaN
// there must still reach C, as in the reference.  Both kernels keep the small
// panel in shared memory, the mn sums in registers and the extraction in
// registers, so X never reaches device memory.  Panels, the base s and the
// extract flag are runtime data: a new erasure or progress pattern is a new
// panel and never a rebuild.
//
// Kernel 2 streams Y with coalesced loads, a thread a column, 8 worker rows
// in flight per thread.  Kernel 3 keeps more bytes in flight per SM:
//  - persistent blocks (as many as fit on the card at once) walk one flat
//    list of column tiles over all chunks, so unequal chunks leave no SM
//    idle and there is no wave tail; the tile -> chunk map is a prefix count
//    of tiles passed by value beside the chunk offsets;
//  - one thread feeds a ring of kStages shared-memory stages with bulk
//    copies (cp.async.bulk, SASS UBLKCP), one per row segment of a tile,
//    each stage completing on an mbarrier armed with its byte count; a large
//    K arrives as several row groups of one tile, in ascending k: at most 5
//    rows a stage for mn <= 4, else as many as the stages fit, so that
//    where mn takes several register passes a tile's K rows mostly stay
//    resident and every pass re-reads them from shared memory;
//  - a thread owns 16 bytes of adjacent columns (2 float64 or 4 float32),
//    reads them from the stage with one 16-byte shared load per row and
//    writes C with 16-byte streaming stores (C is never read back);
//  - it sums up to 16 useful rows per pass in registers, but only 4 when
//    mn <= 4 (the paper's 2x2 grids): the unused rows of a 16-row pass
//    still cost their guards in every step, and at mn = 4 that instruction
//    stream, not the copies, set the pace (0.80 against 0.62 ms at the
//    main path's shape; PERF.md).
// Bulk copies and 16-byte stores need 16-byte aligned addresses and sizes;
// the wrapper (coded_decode.py::bulk_copies) picks that form per launch, and
// otherwise the same tiles and sums run on plain one-element loads and
// stores.  Each output element is kernel 2's chain: x = 0, then
// x = fma(W[u, k], Y[k, e], x) for k ascending, then the extraction, so a
// chunk decodes bit for bit as decode_kernel would.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;        // useful rows held in registers per pass
constexpr int kLoads = 8;        // worker rows of Y loaded together (kernel 2)
constexpr int kMaxGrid = 4096;   // blocks; a grid-stride loop covers the rest
constexpr int kMaxChunks = 128;  // chunk offsets a launch takes by value (< 4 KB)
// kernel 3: the ring's depth, its most rows of Y a stage for mn <=
// kShortPass (see launch_partial), threads a block, the useful rows summed
// per register pass for mn <= kShortPass (else kRows), and the blocks an
// SM the registers of the short-pass instances must allow
constexpr int kStages = 3;
constexpr int kStageRows = 5;
constexpr int kPartialThreads = 256;
constexpr int kShortPass = 4;
constexpr int kShortPassBlocks = 3;
constexpr int kHeadBytes = 128;  // the ring's mbarriers, ahead of the panel
static_assert(kStages >= 2 && kStages * 8 <= kHeadBytes, "ring depth");

struct ChunkOffsets {
  long long y[kMaxChunks];      // element offset of chunk q's column 0 in Y
  long long out[kMaxChunks];    // ... and in the output
  long long width[kMaxChunks];  // columns in chunk q
  int tile_end[kMaxChunks];     // column tiles of chunks 0..q together
};

// Round half to even (never CUDA round(), which rounds halves away from 0).
__device__ __forceinline__ double round_even(double x) { return rint(x); }
__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }

// One decoded sum -> its output: rint, then (with extract) mod s into
// [0, s) and recentring into (-s/2, s/2].  Kernels 2 and 3 both end here.
template <typename T>
__device__ __forceinline__ T extract_digit(T x, T s, T half, int extract) {
  T c = round_even(x);
  if (extract) {
    c = c - floor_of(c / s) * s;
    if (c > half) c -= s;
  }
  return c;
}

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
        out[static_cast<long long>(u0 + u) * os] = extract_digit(x[u], s, half, extract);
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

// ---- kernel 3 ----------------------------------------------------------------

// 16 bytes of adjacent columns: the unit a thread of kernel 3 owns.
template <typename T>
struct Vec;
template <>
struct Vec<double> {
  static constexpr int n = 2;
  using type = double2;
  __device__ static void unpack(const double2& v, double* x) { x[0] = v.x; x[1] = v.y; }
  __device__ static double2 pack(const double* x) { return make_double2(x[0], x[1]); }
};
template <>
struct Vec<float> {
  static constexpr int n = 4;
  using type = float4;
  __device__ static void unpack(const float4& v, float* x) {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static float4 pack(const float* x) { return make_float4(x[0], x[1], x[2], x[3]); }
};

template <typename T>
__host__ __device__ constexpr int tile_cols() { return kPartialThreads * Vec<T>::n; }

__host__ __device__ constexpr size_t round_up(size_t n, size_t to) {
  return (n + to - 1) / to * to;
}

// Grid: as many blocks as the card holds at once.  Block b decodes tiles b,
// b + gridDim.x, ... of the flat list (chunk 0's tiles first); a tile is
// tile_cols() columns of one chunk, the last tile of a chunk ragged.  kBulk:
// Y arrives through the bulk-copy ring (every address, offset, stride and
// width a 16-byte multiple); else through one-element loads.  The stage
// holds group_rows rows of the tile (bulk form; the element form passes K).
template <typename T, bool kBulk, int kPassRows>
__global__ void __launch_bounds__(kPartialThreads,
                                  kPassRows == kShortPass ? kShortPassBlocks : 1)
decode_partial_kernel(const T* __restrict__ W_stack, const T* __restrict__ Y,
                      T* __restrict__ out, int mn, int K, long long panel_stride,
                      int group_rows, ChunkOffsets chunks, int Q, long long ys,
                      long long os, T s, int extract) {
  using V = Vec<T>;
  constexpr int kVec = V::n;
  constexpr int kTile = tile_cols<T>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // one per stage
  T* w_s = reinterpret_cast<T*>(smem_raw + kHeadBytes);
  T* ring = reinterpret_cast<T*>(
      smem_raw + kHeadBytes + round_up(static_cast<size_t>(mn) * K * sizeof(T), 128));
  const long long stage_elems = static_cast<long long>(group_rows) * kTile;

  const int tid = threadIdx.x;
  const int tiles = chunks.tile_end[Q - 1];
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int groups = (K + group_rows - 1) / group_rows;
  const int passes = (mn + kPassRows - 1) / kPassRows;
  // ring items per tile: one stage read by every pass, or a stage per
  // (pass, row group) when K takes several row groups
  const int per_tile = groups == 1 ? 1 : passes * groups;
  const long long items = static_cast<long long>(my_tiles) * per_tile;

  // tile -> (chunk, first column, columns); `q` only moves forward
  auto locate = [&](int tile, int& q, long long& first, int& cols) {
    while (tile >= chunks.tile_end[q]) ++q;
    first = static_cast<long long>(tile - (q ? chunks.tile_end[q - 1] : 0)) * kTile;
    const long long left = chunks.width[q] - first;
    cols = left < kTile ? static_cast<int>(left) : kTile;
  };

  // the producer (thread 0): ring item -> the bulk copies of its row group
  int pq = 0;
  auto issue = [&](long long item) {
    const int tile = static_cast<int>(blockIdx.x) + static_cast<int>(item / per_tile) * gridDim.x;
    const int g = static_cast<int>(item % per_tile) % groups;
    long long first;
    int cols;
    locate(tile, pq, first, cols);
    const int k0 = g * group_rows;
    const int rows = min(group_rows, K - k0);
    const uint32_t bytes = static_cast<uint32_t>(cols) * sizeof(T);
    const int stage = static_cast<int>(item % kStages);
    T* dst = ring + stage * stage_elems;
    const T* src = Y + chunks.y[pq] + static_cast<long long>(k0) * ys + first;
    async_copy::fence_proxy_async();
    async_copy::arrive_expect_bytes(&full[stage], bytes * rows);
    for (int r = 0; r < rows; ++r) {
      async_copy::bulk_copy(dst + r * kTile, src + r * ys, bytes, &full[stage]);
    }
  };
  // every thread: done with `item`'s stage; the producer refills it
  auto release = [&](long long item) {
    __syncthreads();
    if (tid == 0 && item + kStages < items) issue(item + kStages);
  };

  if constexpr (kBulk) {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) async_copy::barrier_init(&full[i]);
      async_copy::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (long long i = 0; i < kStages && i < items; ++i) issue(i);
    }
  }

  const T half = s / T(2);
  const int c = tid * kVec;   // this thread's first column in a tile
  int q = 0;
  int panel_q = -1;           // the chunk whose panel w_s holds
  long long item = 0;
  for (int i = 0; i < my_tiles; ++i) {
    long long first;
    int cols;
    locate(static_cast<int>(blockIdx.x) + i * gridDim.x, q, first, cols);
    if (q != panel_q) {       // the same for every thread of the block
      panel_q = q;
      __syncthreads();        // every thread done with the last panel
      const T* W = W_stack + static_cast<long long>(q) * panel_stride;
      for (int j = tid; j < mn * K; j += kPartialThreads) w_s[j] = W[j];
      __syncthreads();
    }
    const bool active = c < cols;
    const T* yq = Y + chunks.y[q] + first + c;
    T* oq = out + chunks.out[q] + first + c;
    for (int u0 = 0; u0 < mn; u0 += kPassRows) {
      T x[kPassRows][kVec];
#pragma unroll
      for (int u = 0; u < kPassRows; ++u)
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[u][j] = T(0);
      for (int g = 0; g < groups; ++g) {
        const int k0 = g * group_rows;
        const int rows = min(group_rows, K - k0);
        const T* st = nullptr;
        if constexpr (kBulk) {
          const int stage = static_cast<int>(item % kStages);
          async_copy::barrier_wait(&full[stage], static_cast<uint32_t>((item / kStages) & 1));
          st = ring + stage * stage_elems + c;
        }
        if (active) {
#pragma unroll 4
          for (int r = 0; r < rows; ++r) {
            T yv[kVec];
            if constexpr (kBulk) {
              V::unpack(*reinterpret_cast<const typename V::type*>(st + r * kTile), yv);
            } else {
              const T* yr = yq + static_cast<long long>(k0 + r) * ys;
#pragma unroll
              for (int j = 0; j < kVec; ++j) yv[j] = c + j < cols ? yr[j] : T(0);
            }
            const T* w = w_s + u0 * K + k0 + r;
#pragma unroll
            for (int u = 0; u < kPassRows; ++u) {
              if (u0 + u < mn) {
                const T wu = w[u * K];
#pragma unroll
                for (int j = 0; j < kVec; ++j) x[u][j] = fma(wu, yv[j], x[u][j]);
              }
            }
          }
        }
        if (kBulk && groups > 1) release(item++);
      }
      if (active) {
#pragma unroll
        for (int u = 0; u < kPassRows; ++u) {
          if (u0 + u < mn) {
            T d[kVec];
#pragma unroll
            for (int j = 0; j < kVec; ++j) d[j] = extract_digit(x[u][j], s, half, extract);
            T* o = oq + static_cast<long long>(u0 + u) * os;
            if constexpr (kBulk) {
              __stcs(reinterpret_cast<typename V::type*>(o), V::pack(d));
            } else {
#pragma unroll
              for (int j = 0; j < kVec; ++j) {
                if (c + j < cols) __stcs(o + j, d[j]);
              }
            }
          }
        }
      }
    }
    if (kBulk && groups == 1) release(item++);
  }
}

// The card's per-block shared-memory limit (opt-in), in bytes.
inline cudaError_t smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  return err;
}

// Kernel 2.  The panel lives in dynamic shared memory, opted in above the
// 48 KB default up to the card's per-block limit; a panel larger than that
// is decoded in slabs of its rows, one launch each.  A row's sum is the
// same chain of FMAs in any slab, so the output does not depend on the
// split.  Adds the launches made to *launches.
template <typename T>
int launch(const T* W, const T* Y, T* out, int mn, int K, long long E, T s,
           int extract, int* launches, void* stream) {
  if (mn < 1 || K < 1 || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  int smem_max = 0;
  cudaError_t err = smem_optin(&smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t row_bytes = static_cast<size_t>(K) * sizeof(T);
  const int slab = static_cast<int>(static_cast<size_t>(smem_max) / row_bytes < static_cast<size_t>(mn)
                                        ? static_cast<size_t>(smem_max) / row_bytes
                                        : static_cast<size_t>(mn));
  if (slab < 1) return static_cast<int>(cudaErrorInvalidValue);  // one row of K exceeds it
  err = cudaFuncSetAttribute(decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(slab * row_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (E + kThreads - 1) / kThreads;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  for (int u0 = 0; u0 < mn; u0 += slab) {
    const int rows = mn - u0 < slab ? mn - u0 : slab;
    decode_kernel<T><<<static_cast<unsigned>(blocks), kThreads, rows * row_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
        W + static_cast<long long>(u0) * K, Y, out + static_cast<long long>(u0) * E, rows, K,
        E, s, extract);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return static_cast<int>(cudaSuccess);
}

// One launch of kernel 3: chunks [0, Q) with Q <= kMaxChunks, each chunk's
// panel rows [0, mn) at W_stack + q * panel_stride (the caller offsets
// W_stack, out and the chunk offsets to a group of chunks or a slab of rows).
// Adds one to *launches if it launched (a group of empty chunks does not).
template <typename T>
int launch_partial_group(const T* W_stack, long long panel_stride, const T* Y, T* out,
                         int Q, int mn, int K, const long long* y_off,
                         const long long* out_off, const long long* width, long long ys,
                         long long os, T s, int extract, int bulk, int smem_max, int sms,
                         int* launches, cudaStream_t stream) {
  constexpr int kTile = tile_cols<T>();
  const size_t panel = static_cast<size_t>(mn) * K * sizeof(T);
  ChunkOffsets chunks{};
  long long tiles = 0;
  for (int q = 0; q < Q; ++q) {
    chunks.y[q] = y_off[q];
    chunks.out[q] = out_off[q];
    chunks.width[q] = width[q];
    tiles += (width[q] + kTile - 1) / kTile;
    chunks.tile_end[q] = static_cast<int>(tiles);
  }
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles < 1) return static_cast<int>(cudaSuccess);  // every chunk of the group is empty

  // the stage: K in balanced row groups, in ascending k.  The short-pass
  // instance (several blocks an SM) takes at most kStageRows rows a stage;
  // the 16-row instance (one block an SM by its registers) as many as
  // kStages stages fit in shared memory, so where mn takes several passes
  // and K fits, a tile's rows stay resident and every pass re-reads them
  // from shared memory (else each pass copies its row groups again)
  const size_t head = kHeadBytes + round_up(panel, 128);
  const size_t row_bytes = static_cast<size_t>(kTile) * sizeof(T);
  const size_t room = static_cast<size_t>(smem_max) > head ? smem_max - head : 0;
  const size_t fit = room / (kStages * row_bytes);
  if (bulk && fit < 1) return static_cast<int>(cudaErrorInvalidValue);  // the caller slabs first
  const int max_rows = mn <= kShortPass ? kStageRows
                       : fit < 1        ? 1
                                        : static_cast<int>(fit);
  const int groups = (K + max_rows - 1) / max_rows;
  const int group_rows = bulk ? (K + groups - 1) / groups : K;
  const size_t smem = head + (bulk ? kStages * static_cast<size_t>(group_rows) * row_bytes : 0);
  auto kernel = mn <= kShortPass
                    ? (bulk ? decode_partial_kernel<T, true, kShortPass>
                            : decode_partial_kernel<T, false, kShortPass>)
                    : (bulk ? decode_partial_kernel<T, true, kRows>
                            : decode_partial_kernel<T, false, kRows>);
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPartialThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = static_cast<long long>(sms) * per_sm < tiles
                               ? static_cast<long long>(sms) * per_sm
                               : tiles;
  kernel<<<static_cast<unsigned>(blocks), kPartialThreads, smem, stream>>>(
      W_stack, Y, out, mn, K, panel_stride, group_rows, chunks, Q, ys, os, s, extract);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return static_cast<int>(err);
}

// Kernel 3.  Chunks go kMaxChunks to a launch, each group with its own
// offsets and tile prefix.  A panel that leaves no room in shared memory
// for the ring beside it is decoded in slabs of its rows, one launch per
// (slab, group); every output element is the same chain of FMAs in any
// split, so the bits do not depend on it.  Adds the launches made to
// *launches.
template <typename T>
int launch_partial(const T* W_stack, const T* Y, T* out, int Q, int mn, int K,
                   const long long* y_off, const long long* out_off,
                   const long long* width, long long ys, long long os, T s,
                   int extract, int bulk, int* launches, void* stream) {
  constexpr int kVec = Vec<T>::n;
  constexpr int kTile = tile_cols<T>();
  if (Q < 1 || mn < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the bulk form's contract: every address, offset, stride and width
  // 16 bytes wide (the wrapper checks it first; this guards the C entry)
  bool aligned = reinterpret_cast<uintptr_t>(Y) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % 16 == 0 && ys % kVec == 0 &&
                 os % kVec == 0;
  long long tiles = 0;
  for (int q = 0; q < Q; ++q) {
    if (width[q] < 0) return static_cast<int>(cudaErrorInvalidValue);
    tiles += (width[q] + kTile - 1) / kTile;
    aligned = aligned && y_off[q] % kVec == 0 && out_off[q] % kVec == 0 &&
              width[q] % kVec == 0;
  }
  if (tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bulk && !aligned) return static_cast<int>(cudaErrorMisalignedAddress);

  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) err = smem_optin(&smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);

  // rows of the panel a launch holds: all of them when the panel leaves
  // room for a ring of one-row stages (bulk form) or fits (element form)
  const size_t row_bytes = static_cast<size_t>(K) * sizeof(T);
  const size_t ring = bulk ? kStages * static_cast<size_t>(kTile) * sizeof(T) : 0;
  const size_t usable = static_cast<size_t>(smem_max) > kHeadBytes + 128 + ring
                            ? smem_max - kHeadBytes - 128 - ring
                            : 0;
  const int slab = usable / row_bytes < static_cast<size_t>(mn)
                       ? static_cast<int>(usable / row_bytes)
                       : mn;
  if (slab < 1) return static_cast<int>(cudaErrorInvalidValue);  // one row of K exceeds it
  const long long panel_stride = static_cast<long long>(mn) * K;
  long long y_g[kMaxChunks], out_g[kMaxChunks];
  for (int u0 = 0; u0 < mn; u0 += slab) {
    const int rows = mn - u0 < slab ? mn - u0 : slab;
    for (int q0 = 0; q0 < Q; q0 += kMaxChunks) {
      const int n = Q - q0 < kMaxChunks ? Q - q0 : kMaxChunks;
      for (int q = 0; q < n; ++q) {
        y_g[q] = y_off[q0 + q];
        out_g[q] = out_off[q0 + q] + static_cast<long long>(u0) * os;
      }
      err = static_cast<cudaError_t>(launch_partial_group<T>(
          W_stack + q0 * panel_stride + static_cast<long long>(u0) * K, panel_stride, Y, out,
          n, rows, K, y_g, out_g, width + q0, ys, os, s, extract, bulk, smem_max, sms,
          launches, static_cast<cudaStream_t>(stream)));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// W (mn, K), Y (K, E), out (mn, E), all contiguous on the device.  Adds
// the kernel launches made (one per slab of rows) to *launches (HOST).
// Returns the cudaError_t of the launches.
extern "C" int repro_decode_f64(const double* W, const double* Y, double* out,
                                int mn, int K, long long E, double s,
                                int extract, int* launches, void* stream) {
  return launch<double>(W, Y, out, mn, K, E, s, extract, launches, stream);
}

extern "C" int repro_decode_f32(const float* W, const float* Y, float* out,
                                int mn, int K, long long E, double s,
                                int extract, int* launches, void* stream) {
  return launch<float>(W, Y, out, mn, K, E, static_cast<float>(s), extract,
                       launches, stream);
}

// W_stack (Q, mn, K) contiguous on the device.  Chunk q reads worker k's
// column e at Y[y_off[q] + k * ys + e] and writes useful row u at
// out[out_off[q] + u * os + e], for e < width[q].  y_off / out_off / width are
// HOST arrays of Q entries (any Q: a launch takes kMaxChunks of them).  bulk = 1
// takes the bulk-copy form and needs Y, out, every offset, width and both
// strides 16-byte aligned
// (cudaErrorMisalignedAddress otherwise); bulk = 0 takes one-element loads.
// Adds the kernel launches made (one per group of chunks and slab of rows)
// to *launches (HOST).  Returns the cudaError_t of the launches.
extern "C" int repro_decode_partial_f64(const double* W_stack, const double* Y,
                                        double* out, int Q, int mn, int K,
                                        const long long* y_off,
                                        const long long* out_off,
                                        const long long* width, long long ys,
                                        long long os, double s, int extract,
                                        int bulk, int* launches, void* stream) {
  return launch_partial<double>(W_stack, Y, out, Q, mn, K, y_off, out_off,
                                width, ys, os, s, extract, bulk, launches, stream);
}

extern "C" int repro_decode_partial_f32(const float* W_stack, const float* Y,
                                        float* out, int Q, int mn, int K,
                                        const long long* y_off,
                                        const long long* out_off,
                                        const long long* width, long long ys,
                                        long long os, double s, int extract,
                                        int bulk, int* launches, void* stream) {
  return launch_partial<float>(W_stack, Y, out, Q, mn, K, y_off, out_off,
                               width, ys, os, static_cast<float>(s), extract,
                               bulk, launches, stream);
}
