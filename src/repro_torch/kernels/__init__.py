"""Hand-written CUDA kernels (sm_90a) for the coded-matmul and LM hot spots.

Each stage of the paper's pipeline has a plain PyTorch version in ``ref``
and a wrapper in ``ops`` that runs the plain version for CPU tensors and
launches the kernel for CUDA tensors:

  coded_fused   - encode + all-K worker products in ONE kernel: coded tiles
                  are formed in shared memory inside the product tiling, so
                  A~/B~ never touch device memory (csrc/coded_fused.cu; the
                  "fused" backend)
  coded_encode  - the staged backend's encode, (K, P) @ (P, E) with the
                  panel in shared memory, read from strided block views
                  (csrc/coded_encode.cu)
  block_matmul  - the staged backend's per-worker product A~^T B~
                  (csrc/block_matmul.cu; its FP64 tensor-core main loop,
                  dmma_gemm.cuh, is shared with coded_fused)
  coded_decode  - decode panel @ worker outputs with FUSED digit extraction
                  (round/mod-s/recentre), whole-product and per-chunk
                  (partial stragglers); X never reaches device memory
                  (csrc/coded_decode.cu)
  wkv_scan      - the RWKV-6 WKV recurrence from a zero state (prefill),
                  one block per (batch, head, 32 value columns), each
                  column's rows split over lanes, the state in registers
                  (csrc/wkv_scan.cu)
  mamba_scan    - the Mamba selective scan from a zero state (prefill),
                  one thread per channel, the state in registers, one
                  MUFU op per exponential (csrc/mamba_scan.cu)

The two scans stage their inputs with cp.async (csrc/async_copy.cuh).

The CUDA sources are built with nvcc at first use (``_build``); importing
this package builds nothing.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
