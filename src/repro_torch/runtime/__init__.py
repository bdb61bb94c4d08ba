"""Runtime: the unified coded-matmul executor API.

``CodedMatmul`` is the single entry point for every ported backend
("fused": the CUDA kernels; "reference": plain PyTorch);
``ErasurePattern`` normalises every erasure convention; executors are
pluggable via ``with_backend``.
"""
from repro_torch.runtime.erasure import ErasurePattern
from repro_torch.runtime.executors import (
    BACKENDS,
    Executor,
    FusedKernelExecutor,
    LocalExecutor,
    ReferenceExecutor,
    resolve_executor,
)
from repro_torch.runtime.facade import CacheGroup, CodedMatmul, plan_token

__all__ = [
    "CodedMatmul",
    "CacheGroup",
    "plan_token",
    "ErasurePattern",
    "Executor",
    "LocalExecutor",
    "ReferenceExecutor",
    "FusedKernelExecutor",
    "resolve_executor",
    "BACKENDS",
]
