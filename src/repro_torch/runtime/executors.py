"""Pluggable backends for the coded-matmul pipeline.

Every executor turns (A, B, erasure) into the decoded product C through the
same four stages (encode -> worker products -> erase -> decode); what varies
is HOW the worker products (and the decode) are computed:

  reference  plain PyTorch einsums and matmul (ground truth, complex ok)
  fused      the fused encode+product CUDA kernel for all K workers, then
             the decode CUDA kernel with fused digit extraction

Executors expose ``make_pipeline(plan, kind, dtype)`` returning the
function the ``CodedMatmul`` facade memoises:

  kind == "concrete":  fn(A, B, mask, W)  with W the (mn, K) decode panel

The erasure pattern is DATA (mask and W), so one pipeline serves every
pattern.  The reference package's other backends and kinds ("staged",
"mesh", "traced", the partial-straggler and split-stage kinds) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

import torch

from repro_torch.core.api import (
    CodedMatmulPlan,
    encode_blocks,
    fused_worker_products,
    worker_products,
)
from repro_torch.core.decoding import decode_with_weights
from repro_torch.core.partition import block_decompose, block_recompose, unpad
from repro_torch.kernels import ops as kops

__all__ = [
    "Executor",
    "LocalExecutor",
    "ReferenceExecutor",
    "FusedKernelExecutor",
    "resolve_executor",
    "BACKENDS",
    "NOT_PORTED",
]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; the ported "
        f"backends are {sorted(BACKENDS)} with concrete erasure patterns")


@runtime_checkable
class Executor(Protocol):
    """Backend protocol: a name plus a pipeline builder per erasure kind."""

    name: str

    def make_pipeline(
        self, plan: CodedMatmulPlan, kind: str, dtype
    ) -> Callable:  # pragma: no cover - protocol
        """A (A, B, mask, W) -> C pipeline for one erasure kind."""
        ...

    def cache_token(self):  # pragma: no cover - protocol
        """Hashable identity for the pipeline memo."""
        ...


class LocalExecutor:
    """Shared single-host pipeline; subclasses provide the worker stage and
    the decode."""

    name = "local"

    def cache_token(self):
        """Pipeline-memo identity (the name: local executors are config-free)."""
        return self.name

    def worker_products(self, plan: CodedMatmulPlan, a_blocks: torch.Tensor,
                        b_blocks: torch.Tensor) -> torch.Tensor:
        """(p, m, bv, br), (p, n, bv, bt) -> all-K worker outputs (K, br, bt)."""
        raise NotImplementedError

    def decode(self, plan: CodedMatmulPlan, W: torch.Tensor,
               Y: torch.Tensor) -> torch.Tensor:
        """(mn, K) panel, (K, br, bt) masked products -> (m, n, br, bt)."""
        raise NotImplementedError

    def make_pipeline(self, plan: CodedMatmulPlan, kind, dtype) -> Callable:
        """The single-host 4-stage pipeline for the ``"concrete"`` kind.

        Raises:
            NotImplementedError: for any other kind (not ported yet).
        """
        if kind != "concrete":
            raise _not_ported(f"pipeline kind {kind!r}")
        g = plan.scheme.grid

        def fn(A, B, mask, W):
            a_blocks = block_decompose(A.to(dtype), g.p, g.m)
            b_blocks = block_decompose(B.to(dtype), g.p, g.n)
            Y = self.worker_products(plan, a_blocks, b_blocks)  # (K, br, bt)
            # stage 3 ERASE: zero failed workers' outputs, in place (Y is
            # this call's own buffer).  W's zero columns annihilate them as
            # well; the multiply keeps the reference's NaN/garbage semantics.
            Y.mul_(mask.to(Y.dtype)[:, None, None])
            C_blocks = self.decode(plan, W, Y)
            return unpad(block_recompose(C_blocks),
                         (A.shape[1], B.shape[1])).to(dtype)

        return fn


class ReferenceExecutor(LocalExecutor):
    """Plain PyTorch einsums and matmul: the oracle every backend must match."""

    name = "reference"

    def worker_products(self, plan, a_blocks, b_blocks):
        """Encode + per-worker products as plain einsums (the oracle path)."""
        a_tilde, b_tilde = encode_blocks(plan, a_blocks, b_blocks)
        return worker_products(a_tilde, b_tilde)

    def decode(self, plan, W, Y):
        """Plain matmul + digit extraction (``decode_with_weights``)."""
        return decode_with_weights(plan.scheme, W, Y, plan.s)


class FusedKernelExecutor(LocalExecutor):
    """Fused encode+product kernel, then the decode kernel."""

    name = "fused"

    def worker_products(self, plan, a_blocks, b_blocks):
        """One fused encode+product kernel launch for all K workers."""
        return fused_worker_products(plan, a_blocks, b_blocks)

    def decode(self, plan, W, Y):
        """One decode kernel launch with fused digit extraction."""
        g = plan.scheme.grid
        Xc = kops.decode(W, Y.reshape(Y.shape[0], -1), plan.s,
                         extract=plan.scheme.needs_digit_extraction)
        return Xc.reshape(g.m, g.n, *Y.shape[1:])


BACKENDS = {
    "reference": ReferenceExecutor,
    "fused": FusedKernelExecutor,
}

# Backends of the reference package that later slices of the port add.
NOT_PORTED = ("staged", "mesh")


def resolve_executor(backend) -> Executor:
    """Executor instance from a backend name (or passthrough instance).

    Raises:
        NotImplementedError: for a backend that is not ported yet.
        ValueError: for an unknown backend name.
        TypeError: for an object that is not an ``Executor``.
    """
    if not isinstance(backend, str):
        if not isinstance(backend, Executor):
            raise TypeError(f"not an Executor: {type(backend).__name__}")
        return backend
    if backend in NOT_PORTED:
        raise _not_ported(f"the {backend!r} backend")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; options: {sorted(BACKENDS)}")
    return BACKENDS[backend]()
