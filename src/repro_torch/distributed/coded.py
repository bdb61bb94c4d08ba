"""On-mesh coded matmul: thin delegates over the unified runtime.

The pipeline (ENCODE -> WORKER -> ERASE -> DECODE, one worker per rank, a
lost rank absorbed within the step) lives in
``repro_torch.runtime.executors.MeshExecutor``.  This module keeps the
legacy ``coded_matmul_mesh`` signature as a deprecation shim and the
``CodedLinearPlan`` layer as a thin wrapper over the ``CodedMatmul``
facade, as the reference package's ``distributed/coded.py`` does.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.core.api import CodedMatmulPlan, runtime_facade
from repro_torch.core.decoding import DecodePanelCache
from repro_torch.runtime import CodedMatmul

__all__ = ["coded_matmul_mesh", "CodedLinearPlan"]


def coded_matmul_mesh(
    A,
    B,
    plan: CodedMatmulPlan,
    mesh,
    mask=None,
    *,
    axis: str = "model",
    use_kernels: bool = True,
    fused: bool = True,
    panel_cache: Optional[DecodePanelCache] = None,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """DEPRECATED: use ``repro_torch.runtime.CodedMatmul(plan, "mesh", mesh=...)``.

    C = A^T B on the mesh, tolerating up to K - tau erased workers; every
    rank of ``mesh`` makes the same call.  ``mask``: (K,) 0/1 survivors
    (default all alive); the mesh axis size must equal plan.K (one worker
    per rank).  The mask decodes through a host-factored panel.  A passed
    ``panel_cache`` is adopted by the shared facade so its ``builds``
    counter keeps tracking factorisations.
    """
    warnings.warn(
        "coded_matmul_mesh is deprecated; use repro_torch.runtime.CodedMatmul "
        "with backend='mesh'",
        DeprecationWarning, stacklevel=2)
    cm = runtime_facade(plan, "mesh", dtype, panel_cache=panel_cache,
                        device=device, mesh=mesh, axis=axis,
                        use_kernels=use_kernels, fused=fused)
    return cm(A, B, mask=mask)


def _quant_scale(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """Scale so round(x / scale) lands on the integer grid [-qmax, qmax].

    All-zero (or denormal-tiny) inputs get scale 1 instead of an additive
    epsilon: with ``max|x| = 0`` the quantised tensor is exactly zero
    either way, but for ``max|x|`` below such an epsilon every entry would
    collapse to zero; dividing by the true max keeps the full quantisation
    range at any magnitude.
    """
    mx = x.abs().max()
    return torch.where(mx > 0, mx / qmax, torch.ones_like(mx))


class CodedLinearPlan:
    """Straggler-tolerant linear layer y = x @ W via the coded pipeline.

    Maps y = x W onto the paper's C = A^T B with A = x^T (d, N), B = W
    (d, V): the contraction (d) is the coded dimension, so each worker
    holds 1/(mp) of the activations and 1/(np) of the weight - the paper's
    memory model - and any tau of K workers determine the output.

    For float inputs the layer quantises x and W onto integer grids
    (scale-and-round, the paper's footnote 1), runs the exact integer coded
    matmul at ``dtype``, and rescales.  ``quant_bits`` bounds the grids so
    the digit stack fits the dtype (bounds.plan_p_prime is the policy).

    The layer delegates to a ``CodedMatmul`` facade on the "mesh" backend,
    which owns the ``DecodePanelCache`` (decode weights factored once per
    erasure pattern) and the pipeline memo (one pipeline for every mask).
    """

    def __init__(self, plan: CodedMatmulPlan, mesh, *, axis: str = "model",
                 quant_bits: int = 4, fused: bool = True,
                 dtype=torch.float32, device=None):
        self.plan = plan
        self.mesh = mesh
        self.axis = axis
        self.quant_bits = quant_bits
        self.fused = fused
        self.dtype = dtype
        self.matmul = CodedMatmul(plan, "mesh", mesh=mesh, axis=axis,
                                  fused=fused, dtype=dtype, device=device)
        self.panel_cache = self.matmul.panel_cache

    def __call__(self, x: torch.Tensor, W: torch.Tensor,
                 mask=None) -> torch.Tensor:
        qmax = 2 ** (self.quant_bits - 1) - 1
        sx = _quant_scale(x, qmax)
        sw = _quant_scale(W, qmax)
        xi = torch.round(x / sx)
        wi = torch.round(W / sw)
        yi = self.matmul(xi.T, wi, mask=mask)
        return (yi * (sx * sw).to(yi.device)).to(x.dtype)
