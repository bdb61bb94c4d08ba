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
  mesh       one rank per worker along a ``DeviceMesh`` dimension: each
             rank computes its own worker product, erases it by its mask
             entry, all-gathers the K products over ``torch.distributed``
             and decodes the replicated C (``launch/mesh.py`` starts ranks)

Executors expose ``make_pipeline(plan, kind, dtype, *, ridge=0.0)``
returning the function the ``CodedMatmul`` facade memoises:

  kind == "concrete":       fn(A, B, mask, W)   with W the (mn, K) panel
  kind == "traced":         fn(A, B, mask)      panel built on the device
  kind == ("partial", Q):   fn(A, B, chunk_masks, W_stack)
                            chunk_masks (Q, K), W_stack (Q, mn, K)
  kind == ("partial-traced", Q): fn(A, B, progress)  progress (K,)
  kind == "products":       fn(A, B) -> (K, br, bt) worker products
  kind == ("decode", r, t): fn(Y, mask, W) -> (r, t), stages 3+4 of a
                            "products" result
  kind == ("decode-traced", r, t): fn(Y, mask)

The local pipelines mark their stages with ``repro_torch.obs`` spans:
``stage.worker`` around the worker products (encode and the K products,
``worker_products``) and ``stage.decode`` around the erase, the decode and
the recompose; a recording ``torch.profiler`` sees them as ranges.

Partial-straggler kinds carry the sub-task count Q (``runtime/partial.py``):
each worker's output rows split into Q chunks and chunk c erases with its own
(K,) availability row and decodes with its own panel.  The erasure or
progress pattern is DATA (masks and panels), so one pipeline serves every
pattern of its kind.  The traced kinds take a mask or progress tensor that
the host never reads (``runtime/erasure.py``): the reference backend solves
the masked normal equations in the body (``decode_masked``), as the
reference package does; the kernel backends build the panel W (or the
(Q, mn, K) stack) on the device (``core.decoding.masked_panel``, with the
panel cache's ``ridge``) and hand it to the decode kernels, which take W as
runtime data.  A traced pipeline copies nothing from the host once its
first call has kept the plan's tables on the device (``PlanTables``), so it
can be captured into a CUDA graph and replayed under any survivor set.
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol, runtime_checkable

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.api import (
    CodedMatmulPlan,
    PlanTables,
    encode_blocks,
    fused_worker_products,
    worker_products,
)
from repro_torch.core.decoding import decode_masked, decode_with_weights, masked_panel
from repro_torch.core.numerics import resolve_device
from repro_torch.core.partition import block_decompose, block_recompose, unpad
from repro_torch.kernels import ops as kops
from repro_torch.runtime.partial import chunk_bounds, chunk_masks_traced

__all__ = [
    "Executor",
    "LocalExecutor",
    "ReferenceExecutor",
    "StagedKernelExecutor",
    "FusedKernelExecutor",
    "MeshExecutor",
    "resolve_executor",
    "local_backend_names",
    "BACKENDS",
]


@runtime_checkable
class Executor(Protocol):
    """Backend protocol: a name plus a pipeline builder per erasure kind."""

    name: str

    def make_pipeline(
        self, plan: CodedMatmulPlan, kind: str, dtype, *, ridge: float = 0.0
    ) -> Callable:  # pragma: no cover - protocol
        """A (A, B, mask, W) -> C pipeline for one erasure kind (``ridge``
        for the traced kinds' device panels)."""
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
                        b_blocks: torch.Tensor,
                        tables: Optional[PlanTables] = None) -> torch.Tensor:
        """(p, m, bv, br), (p, n, bv, bt) -> all-K worker outputs (K, br, bt),
        with the coefficients kept in ``tables`` (default: uploaded for this
        call)."""
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

    def decode_traced(self, plan: CodedMatmulPlan, z: torch.Tensor,
                      mask: torch.Tensor, Y: torch.Tensor,
                      ridge: float) -> torch.Tensor:
        """(K,) points, (K,) device mask, (K, br, bt) masked products ->
        (m, n, br, bt): the panel built on the device, then :meth:`decode`."""
        return self.decode(plan, masked_panel(plan.scheme, z, mask, ridge), Y)

    def decode_partial_traced(self, plan: CodedMatmulPlan, z: torch.Tensor,
                              chunk_masks: torch.Tensor, Y: torch.Tensor,
                              bounds: tuple, ridge: float) -> torch.Tensor:
        """The per-chunk twin of :meth:`decode_traced`: chunk_masks (Q, K)
        on the device give the (Q, mn, K) stack for :meth:`decode_partial`."""
        return self.decode_partial(
            plan, masked_panel(plan.scheme, z, chunk_masks, ridge), Y, bounds)

    def make_pipeline(self, plan: CodedMatmulPlan, kind, dtype, *,
                      ridge: float = 0.0) -> Callable:
        """The single-host pipeline for one ``kind`` (see the module doc);
        ``ridge`` regularises the traced kinds' normal equations.

        Raises:
            ValueError: for an unknown kind.
        """
        g = plan.scheme.grid
        tables = PlanTables(plan)

        def products(A, B):
            a_blocks = block_decompose(A.to(dtype), g.p, g.m)
            b_blocks = block_decompose(B.to(dtype), g.p, g.n)
            with obs.span("stage.worker"):
                return self.worker_products(plan, a_blocks, b_blocks, tables)

        def points(Y):
            # the evaluation points in the decode dtype, kept on Y's device
            return tables.get("z_points", Y.dtype, Y.device)

        def finish(C_blocks, r, t):
            return unpad(block_recompose(C_blocks), (r, t)).to(dtype)

        if kind == "products":
            # stages 1+2 only, for split-stage serving: the (K, br, bt)
            # output feeds a ("decode", r, t) pipeline later.
            return products

        def decode(Y, mask, W):
            # W is None for the traced kinds: the decode hooks take the
            # device mask instead of a host panel
            if W is None:
                return self.decode_traced(plan, points(Y), mask, Y, ridge)
            return self.decode(plan, W, Y)

        def binary(A, B, mask, W):
            Y = products(A, B)
            with obs.span("stage.decode"):
                # stage 3 ERASE: zero failed workers' outputs, in place (Y is
                # this call's own buffer).  W's zero columns annihilate them as
                # well; the multiply keeps the reference's NaN/garbage semantics.
                Y.mul_(mask.to(Y.dtype)[:, None, None])
                return finish(decode(Y, mask, W), A.shape[1], B.shape[1])

        def per_chunk(A, B, chunk_masks, W_stack, Q):
            Y = products(A, B)
            with obs.span("stage.decode"):
                bounds = _erase_chunks(Y, chunk_masks, Q)
                if W_stack is None:
                    C_blocks = self.decode_partial_traced(plan, points(Y), chunk_masks,
                                                          Y, bounds, ridge)
                else:
                    C_blocks = self.decode_partial(plan, W_stack, Y, bounds)
                return finish(C_blocks, A.shape[1], B.shape[1])

        def stage(Y, mask, W, r, t):
            with obs.span("stage.decode"):
                # a new buffer: Y is the caller's and may be decoded again
                Ym = Y * mask.to(Y.dtype)[:, None, None]
                return finish(decode(Ym, mask, W), r, t)

        if kind == "concrete":
            return binary
        if kind == "traced":
            return lambda A, B, mask: binary(A, B, mask, None)
        if isinstance(kind, tuple) and len(kind) == 2 and kind[0] == "partial":
            Q = kind[1]
            return lambda A, B, chunk_masks, W_stack: per_chunk(A, B, chunk_masks,
                                                                W_stack, Q)
        if isinstance(kind, tuple) and len(kind) == 2 and kind[0] == "partial-traced":
            Q = kind[1]
            return lambda A, B, progress: per_chunk(
                A, B, chunk_masks_traced(progress, Q), None, Q)
        if isinstance(kind, tuple) and len(kind) == 3 and kind[0] == "decode":
            _, r, t = kind
            return lambda Y, mask, W: stage(Y, mask, W, r, t)
        if isinstance(kind, tuple) and len(kind) == 3 and kind[0] == "decode-traced":
            _, r, t = kind
            return lambda Y, mask: stage(Y, mask, None, r, t)

        raise ValueError(
            f"unknown pipeline kind {kind!r}; the kinds are 'concrete', "
            f"'traced', ('partial', Q), ('partial-traced', Q), 'products', "
            f"('decode', r, t) and ('decode-traced', r, t)")


def _erase_chunks(Y: torch.Tensor, chunk_masks: torch.Tensor, Q: int) -> list:
    """Per-chunk ERASE of (K, br, bt) products, in place: chunk c keeps the
    workers whose completed prefix covers it.  Returns the Q + 1 row
    bounds."""
    bounds = chunk_bounds(Y.shape[1], Q)
    for c in range(Q):
        Y[:, bounds[c]:bounds[c + 1], :].mul_(
            chunk_masks[c].to(Y.dtype)[:, None, None])
    return bounds


class ReferenceExecutor(LocalExecutor):
    """Plain PyTorch einsums and matmul: the oracle every backend must match."""

    name = "reference"

    def worker_products(self, plan, a_blocks, b_blocks, tables=None):
        """Encode + per-worker products as plain einsums (the oracle path)."""
        a_tilde, b_tilde = encode_blocks(plan, a_blocks, b_blocks, tables)
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

    def decode_traced(self, plan, z, mask, Y, ridge):
        """The masked normal equations solved in the body
        (``decode_masked``), as the reference package's traced kind does."""
        return decode_masked(plan.scheme, z, Y, mask.to(Y.real.dtype), plan.s, ridge)

    def decode_partial_traced(self, plan, z, chunk_masks, Y, bounds, ridge):
        """``decode_masked`` per chunk with its own mask, concatenated."""
        return torch.cat([
            decode_masked(plan.scheme, z, Y[:, bounds[c]:bounds[c + 1], :],
                          chunk_masks[c].to(Y.real.dtype), plan.s, ridge)
            for c in range(chunk_masks.shape[0])], dim=2)


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

    def worker_products(self, plan, a_blocks, b_blocks, tables=None):
        """Two encode launches (A~ and B~ into device memory, read from the
        strided block views), then one block-matmul launch per worker."""
        ca, cb = (tables or PlanTables(plan)).coeffs(a_blocks, b_blocks)
        a_tilde = kops.encode(ca.reshape(plan.K, -1), a_blocks)   # (K, bv, br)
        b_tilde = kops.encode(cb.reshape(plan.K, -1), b_blocks)   # (K, bv, bt)
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

    def worker_products(self, plan, a_blocks, b_blocks, tables=None):
        """One fused encode+product kernel launch for all K workers."""
        return fused_worker_products(plan, a_blocks, b_blocks, tables)


# ---------------------------------------------------------------------------
# Mesh backend: one rank per worker, the pipeline run by every rank.
# ---------------------------------------------------------------------------


class MeshExecutor:
    """One worker per rank along a mesh dimension; erasure is a runtime mask.

    The reference runs one single-controller ``shard_map`` program over the
    mesh.  PyTorch has no single controller: every rank of ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh``) runs the same facade call
    on the same operands, so worker k is the rank whose coordinate on
    ``axis`` is k.  Each rank computes its own worker product (stages 1+2),
    erases it by its mask entry (binary kinds), all-gathers the K products
    on the axis's process group and decodes the replicated C, as every
    device of the reference keeps its C.  With ``use_kernels`` the product
    is the fused encode+product kernel at K = 1 (``fused``) or the encode
    kernel twice and the block-matmul kernel; the decode is the decode
    kernel (binary) or the per-chunk decode kernel (partial), where the
    reference's body decodes with a plain einsum and digit extraction (the
    same function).  Without ``use_kernels`` every stage is plain PyTorch.

    The transport of the gather follows the group's backend: NCCL gathers
    device tensors; gloo gathers host tensors, so on a card (ranks sharing
    one card, where NCCL refuses two ranks of a communicator) each rank
    stages its product and the gathered Y through pinned host memory,
    while the products and the decode stay on the card.  With obs on the
    gather records the span ``mesh.all_gather``.
    """

    name = "mesh"

    def __init__(self, mesh, *, axis: str = "model", use_kernels: bool = True,
                 fused: bool = True):
        if mesh is None:
            raise ValueError("MeshExecutor requires a mesh (backend='mesh')")
        self.mesh = mesh
        self.axis = axis
        self.use_kernels = use_kernels
        self.fused = fused
        self._decoder = (_KernelDecodeExecutor() if use_kernels
                         else ReferenceExecutor())
        self._host_buffers: dict = {}

    def cache_token(self):
        """Pipeline-memo identity: name + mesh + axis + kernel flags."""
        return (self.name, self.mesh, self.axis, self.use_kernels, self.fused)

    @property
    def device(self) -> torch.device:
        """This rank's device (``resolve_device(None, mesh)``)."""
        return resolve_device(None, self.mesh)

    @property
    def transport(self) -> str:
        """How the worker products travel, from the axis group's backend."""
        backend = dist.get_backend(self.mesh.get_group(self.axis))
        if self.mesh.device_type == "cpu":
            return f"{backend}, host tensors"
        if backend == "nccl":
            return "nccl, device tensors"
        return f"{backend}, staged through pinned host memory"

    def _axis_size(self) -> int:
        names = self.mesh.mesh_dim_names or ()
        if self.axis not in names:
            raise ValueError(f"mesh axis {self.axis!r} is not a dimension of "
                             f"the mesh {tuple(names)}")
        return int(self.mesh.shape[names.index(self.axis)])

    def make_pipeline(self, plan: CodedMatmulPlan, kind, dtype, *,
                      ridge: float = 0.0) -> Callable:
        """This rank's part of the mesh pipeline for ``kind`` (the local
        pipelines' signatures): ``"concrete"``, ``"traced"``,
        ``("partial", Q)`` or ``("partial-traced", Q)``.  The traced kinds
        build the panel (or the per-chunk stack) on every rank from the
        replicated mask or progress, on the rank's device, as the
        reference's body does.

        Raises:
            NotImplementedError: for split-stage kinds ("products" /
                ("decode", r, t) / ("decode-traced", r, t)): encode, worker
                products and decode run fused in one pipeline per rank,
                leaving no seam to pipeline across.
            ValueError: for an unknown kind, a mesh axis whose size is not
                the plan's K, or a complex (unit-circle) plan.
        """
        is_stage = (kind == "products"
                    or (isinstance(kind, tuple) and kind
                        and kind[0] in ("decode", "decode-traced")))
        if is_stage:
            raise NotImplementedError(
                f"mesh backend does not support split-stage serving (kind "
                f"{kind!r}): encode, worker products, and decode run fused "
                f"inside one pipeline on every rank, so there is no seam to "
                f"pipeline across. Split worker/decode stages are supported "
                f"by the local backends: {local_backend_names()}.")
        if kind not in ("concrete", "traced") and (
                not isinstance(kind, tuple) or len(kind) != 2
                or kind[0] not in ("partial", "partial-traced")):
            raise ValueError(f"unknown mesh pipeline kind {kind!r}")
        K = self._axis_size()
        if K != plan.K:
            raise ValueError(
                f"plan built for K={plan.K}, mesh axis {self.axis!r} has {K}")
        if plan.is_complex:
            raise ValueError(
                "mesh backend does not support complex (unit-circle) plans; "
                "use chebyshev/equispaced points or a local backend")
        g = plan.scheme.grid
        k = self.mesh.get_local_rank(self.axis)
        # worker k's (1, P) coefficient rows and the points, once per pipeline
        ca = torch.as_tensor(plan.coeff_a.reshape(K, -1)[k:k + 1], dtype=dtype,
                             device=self.device)
        cb = torch.as_tensor(plan.coeff_b.reshape(K, -1)[k:k + 1], dtype=dtype,
                             device=self.device)
        z = torch.as_tensor(plan.z_points, dtype=dtype, device=self.device)

        def product(A, B):
            a_blocks = block_decompose(A.to(dtype), g.p, g.m)
            b_blocks = block_decompose(B.to(dtype), g.p, g.n)
            return self._local_product(ca, cb, a_blocks, b_blocks)

        def finish(C_blocks, r, t):
            return unpad(block_recompose(C_blocks), (r, t)).to(dtype)

        def binary(A, B, mask, W):
            y = product(A, B)
            # stage 3 ERASE on the rank, before the gather
            y.mul_(mask[k].to(y.dtype))
            Y = self._all_gather(y, K)
            if W is None:
                W = masked_panel(plan.scheme, z, mask, ridge)
            return finish(self._decoder.decode(plan, W, Y), A.shape[1], B.shape[1])

        def per_chunk(A, B, chunk_masks, W_stack, Q):
            # gather the UNMASKED products: a slow worker's finished
            # prefix still contributes, chunk by chunk
            Y = self._all_gather(product(A, B), K)
            bounds = _erase_chunks(Y, chunk_masks, Q)
            if W_stack is None:
                W_stack = masked_panel(plan.scheme, z, chunk_masks, ridge)
            return finish(self._decoder.decode_partial(plan, W_stack, Y, bounds),
                          A.shape[1], B.shape[1])

        if kind == "concrete":
            return binary
        if kind == "traced":
            return lambda A, B, mask: binary(A, B, mask, None)
        Q = kind[1]
        if kind[0] == "partial":
            return lambda A, B, chunk_masks, W_stack: per_chunk(A, B, chunk_masks,
                                                                W_stack, Q)
        return lambda A, B, progress: per_chunk(
            A, B, chunk_masks_traced(progress.to(dtype), Q), None, Q)

    def _local_product(self, ca, cb, a_blocks, b_blocks) -> torch.Tensor:
        """Stages 1+2 on this rank: worker k's coded blocks, multiplied.

        ca (1, p*m), cb (1, p*n); a_blocks (p, m, bv, br), b_blocks (p, n,
        bv, bt) replicated -> the (br, bt) product this rank contributes.
        """
        if self.use_kernels and self.fused:
            return kops.fused_worker(ca, cb, a_blocks, b_blocks)[0]
        if self.use_kernels:
            return kops.matmul_t(kops.encode(ca, a_blocks)[0],
                                 kops.encode(cb, b_blocks)[0])
        a_tilde = torch.einsum("pm,pmvr->vr", ca.reshape(a_blocks.shape[:2]),
                               a_blocks)
        b_tilde = torch.einsum("pn,pnvt->vt", cb.reshape(b_blocks.shape[:2]),
                               b_blocks)
        return a_tilde.T @ b_tilde

    def _all_gather(self, y: torch.Tensor, K: int) -> torch.Tensor:
        """(br, bt) on every rank -> (K, br, bt), row k from the axis's
        rank k, on this rank's device."""
        group = self.mesh.get_group(self.axis)
        y = y.contiguous()
        Y = y.new_empty((K, *y.shape))
        with obs.span("mesh.all_gather", lane="mesh"):
            if dist.get_backend(group) == "nccl":
                dist.all_gather_into_tensor(Y, y, group=group)
            elif y.is_cuda:
                host_y, host_Y = self._host_staging(y, K)
                host_y.copy_(y)
                dist.all_gather(list(host_Y.unbind(0)), host_y, group=group)
                Y.copy_(host_Y)
            else:
                dist.all_gather(list(Y.unbind(0)), y, group=group)
        return Y

    def _host_staging(self, y: torch.Tensor, K: int) -> tuple:
        """Pinned host buffers for one product and the gathered K, kept
        per shape and dtype across calls."""
        key = (tuple(y.shape), y.dtype)
        bufs = self._host_buffers.get(key)
        if bufs is None:
            bufs = (torch.empty(y.shape, dtype=y.dtype, pin_memory=True),
                    torch.empty((K, *y.shape), dtype=y.dtype, pin_memory=True))
            self._host_buffers[key] = bufs
        return bufs


BACKENDS = {
    "reference": ReferenceExecutor,
    "staged": StagedKernelExecutor,
    "fused": FusedKernelExecutor,
    "mesh": MeshExecutor,
}

# The split-stage (products / decode) seam only exists on local backends;
# computed once from the registry so error messages cannot drift from it.
_LOCAL_BACKEND_NAMES = ", ".join(sorted(
    name for name, cls in BACKENDS.items() if issubclass(cls, LocalExecutor)))


def local_backend_names() -> str:
    """Comma-joined names of the local (split-stage capable) backends."""
    return _LOCAL_BACKEND_NAMES


def resolve_executor(backend, *, mesh=None, axis: str = "model",
                     use_kernels: bool = True, fused: bool = True) -> Executor:
    """Executor instance from a backend name (or passthrough instance).

    Raises:
        ValueError: for an unknown backend name, or "mesh" without a mesh.
        TypeError: for an object that is not an ``Executor``.
    """
    if not isinstance(backend, str):
        if not isinstance(backend, Executor):
            raise TypeError(f"not an Executor: {type(backend).__name__}")
        return backend
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; options: {sorted(BACKENDS)}")
    if backend == "mesh":
        return MeshExecutor(mesh, axis=axis, use_kernels=use_kernels,
                            fused=fused)
    return BACKENDS[backend]()
