// Asynchronous global-to-shared copies, the one home of these primitives for
// every kernel of the port.
//
// cp.async (scan kernels wkv_scan.cu and mamba_scan.cu, and the product
// main loop dmma_gemm.cuh of kernels 1 and 5): each thread issues its share
// of a tile's copies, commits them as one group, and waits for the group
// before a barrier makes the tile visible to the block, so the copies of the
// next tile run while the block works on this one.
//
// Bulk copies (coded_decode.cu, kernel 3): one thread asks the copy engine
// for whole row segments (cp.async.bulk, SASS UBLKCP); an mbarrier armed
// with the stage's byte count completes when they have landed, and the
// other threads wait on its phase.
//
// Tensor copies (wgmma_gemm.cuh, the 16-bit form of kernels 1 and 5): one
// thread asks the Tensor Memory Accelerator for a box of a tensor map
// (cp.async.bulk.tensor, SASS UTMALDG), completing on an mbarrier as the
// bulk copies do.  The map is encoded on the host through
// cudaGetDriverEntryPoint, so nothing links libcuda.
//
// Stores into another block of the cluster (coded_fused.cu's float64
// cluster form): st.async to a shared::cluster address (SASS STAS),
// completing on that block's mbarrier as the bulk copies do.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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

// Start copying src_bytes (<= kBytes; kBytes 4, 8 or 16) from global to
// shared memory, zero-filling the rest of the kBytes.
template <int kBytes>
__device__ __forceinline__ void copy_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(s), "l"(src), "n"(kBytes), "r"(src_bytes) : "memory");
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

// ---- bulk copies completing on an mbarrier ---------------------------------

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread sets up a barrier that completes a phase on `count` arrivals
// (one, by default, plus the bytes it announces); then a fence and a block
// barrier publish it.
__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_address(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's earlier generic-proxy accesses of shared memory (the
// block's reads of a stage, made visible to it by a block barrier) before
// the bulk copies it issues next into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrive on the barrier and announce the bytes this phase's copies bring.
__device__ __forceinline__ void arrive_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_address(bar)), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; the barrier counts them off as they land.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_address(dst)), "l"(src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

// Copy the box at coordinates c[0..rank) (innermost first; 2 <= rank <= 5)
// of the tensor map `map` (the address of a __grid_constant__ kernel
// parameter) into dst; the barrier counts its bytes off as they land.  Box
// elements outside the map's dimensions arrive as zeros.
__device__ __forceinline__ void tensor_copy(void* dst, const void* map, uint64_t* bar,
                                            int rank, const int (&c)[5]) {
  const uint32_t d = smem_address(dst);
  const uint32_t b = smem_address(bar);
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  switch (rank) {
    case 2:
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%3, %4}], [%2];\n"
          ::"r"(d), "l"(m), "r"(b), "r"(c[0]), "r"(c[1]) : "memory");
      break;
    case 3:
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%3, %4, %5}], [%2];\n"
          ::"r"(d), "l"(m), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2]) : "memory");
      break;
    case 4:
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
          ::"r"(d), "l"(m), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
          : "memory");
      break;
    default:
      asm volatile(
          "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
          ::"r"(d), "l"(m), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]),
            "r"(c[4]) : "memory");
      break;
  }
}

// Bring a tensor map (a __grid_constant__ kernel parameter) into the TMA
// unit's descriptor cache ahead of its first copy.
__device__ __forceinline__ void prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One arrival on the barrier (a consumer releasing a stage).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_address(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_address(bar)), "r"(parity) : "memory");
  }
}

// ---- thread-block clusters: another block's shared memory -------------------
//
// The blocks of a cluster (coded_fused.cu's float64 cluster form) store into
// each other's shared memory through shared::cluster addresses: asynchronous
// stores that the receiving block's mbarrier counts off by their bytes, as
// it counts a bulk copy's.

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// The shared::cluster address of `p` (in this block's shared memory) at the
// same offset in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t peer_address(const void* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr) : "r"(smem_address(p)), "r"(rank));
  return addr;
}

// Store two doubles (16 bytes, 16-byte aligned) at a shared::cluster address
// of another block; its barrier at `bar` (a shared::cluster address in the
// same block) counts the 16 bytes off when they have landed, as it counts a
// bulk copy's.
__device__ __forceinline__ void store_peer(uint32_t addr, double x, double y, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];\n"
      ::"r"(addr), "d"(x), "d"(y), "r"(bar) : "memory");
}

// Every thread of every block of the cluster: arrive (release), then wait
// (acquire).  Split, so that work which touches no other block can run
// between the two.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace async_copy
