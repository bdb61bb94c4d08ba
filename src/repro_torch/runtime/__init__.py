"""Runtime: the unified coded-matmul executor API.

``CodedMatmul`` is the single entry point for every backend ("fused" and
"staged": the CUDA kernels; "reference": plain PyTorch; "mesh": one rank
per worker over ``torch.distributed``);
``ErasurePattern`` normalises every erasure convention and
``PartialPattern`` its fractional generalisation (per-worker sub-task
progress); executors are pluggable via ``with_backend``.
"""
from repro_torch.runtime.erasure import ErasurePattern
from repro_torch.runtime.partial import (
    PartialPattern,
    chunk_bounds,
    chunk_coverage,
    chunk_masks_for,
)
from repro_torch.runtime.executors import (
    BACKENDS,
    Executor,
    FusedKernelExecutor,
    LocalExecutor,
    MeshExecutor,
    ReferenceExecutor,
    StagedKernelExecutor,
    resolve_executor,
)
from repro_torch.runtime.facade import CacheGroup, CodedMatmul, plan_token

__all__ = [
    "CodedMatmul",
    "CacheGroup",
    "plan_token",
    "ErasurePattern",
    "PartialPattern",
    "chunk_bounds",
    "chunk_coverage",
    "chunk_masks_for",
    "Executor",
    "LocalExecutor",
    "ReferenceExecutor",
    "StagedKernelExecutor",
    "FusedKernelExecutor",
    "MeshExecutor",
    "resolve_executor",
    "BACKENDS",
]
