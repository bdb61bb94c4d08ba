"""Pluggable backends for the coded-matmul pipeline.

Every executor turns (A, B, erasure) into the decoded product C through the
same four stages (encode -> worker products -> erase -> decode); what varies
is HOW the worker products (and the decode) are computed:

  reference  plain PyTorch einsums and matmul (ground truth, complex ok)
  staged     the encode CUDA kernel writes the coded A~ and B~ to device
             memory, one block-matmul CUDA kernel per worker multiplies
             them, then the decode CUDA kernel
  fused      the fused encode+product CUDA kernel for all K workers, then
             the decode CUDA kernel with fused digit extraction

Executors expose ``make_pipeline(plan, kind, dtype)`` returning the
function the ``CodedMatmul`` facade memoises:

  kind == "concrete":       fn(A, B, mask, W)   with W the (mn, K) panel
  kind == ("partial", Q):   fn(A, B, chunk_masks, W_stack)
                            chunk_masks (Q, K), W_stack (Q, mn, K)
  kind == "products":       fn(A, B) -> (K, br, bt) worker products
  kind == ("decode", r, t): fn(Y, mask, W) -> (r, t), stages 3+4 of a
                            "products" result

Partial-straggler kinds carry the sub-task count Q (``runtime/partial.py``):
each worker's output rows split into Q chunks and chunk c erases with its own
(K,) availability row and decodes with its own panel.  The erasure or
progress pattern is DATA (masks and panels), so one pipeline serves every
pattern of its kind.  The reference package's "mesh" backend and its
"traced" kinds (a jax tracer as mask) are not ported: PyTorch has no
tracers, and a mask tensor is read to the host.
"""
from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

import torch

from repro_torch.core.api import (
    CodedMatmulPlan,
    _coeffs,
    encode_blocks,
    fused_worker_products,
    worker_products,
)
from repro_torch.core.decoding import decode_with_weights
from repro_torch.core.partition import block_decompose, block_recompose, unpad
from repro_torch.kernels import ops as kops
from repro_torch.runtime.partial import chunk_bounds

__all__ = [
    "Executor",
    "LocalExecutor",
    "ReferenceExecutor",
    "StagedKernelExecutor",
    "FusedKernelExecutor",
    "resolve_executor",
    "local_backend_names",
    "BACKENDS",
    "NOT_PORTED",
]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; the ported "
        f"backends are {sorted(BACKENDS)}")


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
    the decodes."""

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

    def decode_partial(self, plan: CodedMatmulPlan, W_stack: torch.Tensor,
                       Y: torch.Tensor, bounds: tuple) -> torch.Tensor:
        """(Q, mn, K) panels, (K, br, bt) products masked per chunk, Q + 1
        row bounds -> (m, n, br, bt), rows of chunk c decoded by panel c."""
        raise NotImplementedError

    def make_pipeline(self, plan: CodedMatmulPlan, kind, dtype) -> Callable:
        """The single-host pipeline for one ``kind`` (see the module doc).

        Raises:
            ValueError: for an unknown kind.
        """
        g = plan.scheme.grid

        def products(A, B):
            a_blocks = block_decompose(A.to(dtype), g.p, g.m)
            b_blocks = block_decompose(B.to(dtype), g.p, g.n)
            return self.worker_products(plan, a_blocks, b_blocks)  # (K, br, bt)

        def finish(C_blocks, r, t):
            return unpad(block_recompose(C_blocks), (r, t)).to(dtype)

        if kind == "products":
            # stages 1+2 only, for split-stage serving: the (K, br, bt)
            # output feeds a ("decode", r, t) pipeline later.
            return products

        if kind == "concrete":

            def fn(A, B, mask, W):
                Y = products(A, B)
                # stage 3 ERASE: zero failed workers' outputs, in place (Y
                # is this call's own buffer).  W's zero columns annihilate
                # them as well; the multiply keeps the reference's
                # NaN/garbage semantics.
                Y.mul_(mask.to(Y.dtype)[:, None, None])
                return finish(self.decode(plan, W, Y), A.shape[1], B.shape[1])

            return fn

        if isinstance(kind, tuple) and len(kind) == 2 and kind[0] == "partial":
            Q = kind[1]

            def fn(A, B, chunk_masks, W_stack):
                Y = products(A, B)
                bounds = chunk_bounds(Y.shape[1], Q)
                # per-chunk ERASE, in place: chunk c keeps the workers whose
                # completed prefix covers it.
                for c in range(Q):
                    Y[:, bounds[c]:bounds[c + 1], :].mul_(
                        chunk_masks[c].to(Y.dtype)[:, None, None])
                return finish(self.decode_partial(plan, W_stack, Y, bounds),
                              A.shape[1], B.shape[1])

            return fn

        if isinstance(kind, tuple) and len(kind) == 3 and kind[0] == "decode":
            _, r, t = kind

            def fn(Y, mask, W):
                # a new buffer: Y is the caller's and may be decoded again
                Ym = Y * mask.to(Y.dtype)[:, None, None]
                return finish(self.decode(plan, W, Ym), r, t)

            return fn

        raise ValueError(
            f"unknown pipeline kind {kind!r}; the kinds are 'concrete', "
            f"('partial', Q), 'products' and ('decode', r, t)")


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

    def decode_partial(self, plan, W_stack, Y, bounds):
        """``decode_with_weights`` per chunk, concatenated along the rows."""
        return torch.cat([
            decode_with_weights(plan.scheme, W_stack[c],
                                Y[:, bounds[c]:bounds[c + 1], :], plan.s)
            for c in range(W_stack.shape[0])], dim=2)


class _KernelDecodeExecutor(LocalExecutor):
    """Decodes through the decode CUDA kernels (whole-product and per-chunk)."""

    def decode(self, plan, W, Y):
        """One decode kernel launch with fused digit extraction."""
        g = plan.scheme.grid
        Xc = kops.decode(W, Y.reshape(Y.shape[0], -1), plan.s,
                         extract=plan.scheme.needs_digit_extraction)
        return Xc.reshape(g.m, g.n, *Y.shape[1:])

    def decode_partial(self, plan, W_stack, Y, bounds):
        """One per-chunk decode kernel launch for all chunks: chunk c is the
        columns ``bounds[c] * bt : bounds[c + 1] * bt`` of the flat (K, E)
        products, and the kernel writes the (mn, E) result in place."""
        g = plan.scheme.grid
        bt = Y.shape[2]
        Xc = kops.decode_partial(W_stack, Y.reshape(Y.shape[0], -1), plan.s,
                                 extract=plan.scheme.needs_digit_extraction,
                                 bounds=[b * bt for b in bounds])
        return Xc.reshape(g.m, g.n, *Y.shape[1:])


class StagedKernelExecutor(_KernelDecodeExecutor):
    """Encode kernel -> device memory -> one block-matmul kernel per worker."""

    name = "staged"

    def worker_products(self, plan, a_blocks, b_blocks):
        """Two encode launches (A~ and B~ into device memory, read from the
        strided block views), then one block-matmul launch per worker."""
        p, m = a_blocks.shape[:2]
        n = b_blocks.shape[1]
        ca = _coeffs(plan.coeff_a.reshape(plan.K, p * m), a_blocks, plan)
        cb = _coeffs(plan.coeff_b.reshape(plan.K, p * n), b_blocks, plan)
        a_tilde = kops.encode(ca, a_blocks)                     # (K, bv, br)
        b_tilde = kops.encode(cb, b_blocks)                     # (K, bv, bt)
        # Each worker's product is written straight into its slot Y[k] of
        # one preallocated buffer: the same tensor torch.stack of the K
        # products would give, without K temporaries and a copy.
        Y = torch.empty((plan.K, a_tilde.shape[2], b_tilde.shape[2]),
                        dtype=torch.promote_types(a_tilde.dtype, b_tilde.dtype),
                        device=a_tilde.device)
        for k in range(plan.K):
            kops.matmul_t(a_tilde[k], b_tilde[k], out=Y[k])
        return Y


class FusedKernelExecutor(_KernelDecodeExecutor):
    """Fused encode+product kernel, then the decode kernel."""

    name = "fused"

    def worker_products(self, plan, a_blocks, b_blocks):
        """One fused encode+product kernel launch for all K workers."""
        return fused_worker_products(plan, a_blocks, b_blocks)


BACKENDS = {
    "reference": ReferenceExecutor,
    "staged": StagedKernelExecutor,
    "fused": FusedKernelExecutor,
}

# Backends of the reference package that later slices of the port add.
NOT_PORTED = ("mesh",)


def local_backend_names() -> str:
    """Comma-joined names of the local (split-stage capable) backends."""
    return ", ".join(sorted(BACKENDS))


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
