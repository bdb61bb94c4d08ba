// Asynchronous global-to-shared copies (cp.async) for the scan kernels,
// wkv_scan.cu (kernel 7) and mamba_scan.cu (kernel 6): each thread issues its
// share of a tile's copies, commits them as one group, and waits for the
// group before a barrier makes the tile visible to the block, so the copies
// of the next tile run while the block steps through this one.
#pragma once

#include <cuda_runtime.h>

namespace async_copy {

// Start copying kBytes (4 or 16; 16 needs both addresses 16-byte aligned).
template <int kBytes>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(s), "l"(src) : "memory");
  } else {
    static_assert(kBytes == 4, "4- or 16-byte copies");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start copying `rows` rows of `width` floats (a multiple of kVec) from src
// (row stride src_ld) into dst (row pitch dst_ld), kVec floats per copy,
// spread over nthreads threads.
template <int kVec>
__device__ __forceinline__ void copy_rows(float* dst, int dst_ld, const float* src,
                                          long long src_ld, int rows, int width,
                                          int tid, int nthreads) {
  const int per_row = width / kVec;
  for (int e = tid; e < rows * per_row; e += nthreads) {
    const int row = e / per_row;
    const int col = (e - row * per_row) * kVec;
    copy<4 * kVec>(dst + row * dst_ld + col, src + row * src_ld + col);
  }
}

// copy_rows with the copy width picked at run time: 4 floats (16 bytes) or 1.
__device__ __forceinline__ void copy_rows(int vec, float* dst, int dst_ld, const float* src,
                                          long long src_ld, int rows, int width, int tid,
                                          int nthreads) {
  if (vec == 4) {
    copy_rows<4>(dst, dst_ld, src, src_ld, rows, width, tid, nthreads);
  } else {
    copy_rows<1>(dst, dst_ld, src, src_ld, rows, width, tid, nthreads);
  }
}

}  // namespace async_copy
