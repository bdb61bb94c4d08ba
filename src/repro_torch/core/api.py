"""Plan construction + the encode/product building blocks.

``CodedMatmulPlan`` freezes everything static about one coded matmul; it is
host data (numpy), so a plan built by the reference package carries across
field by field (:func:`plan_from_arrays`).  ``encode_blocks`` /
``worker_products`` / ``fused_worker_products`` are the stage primitives
the runtime executors are built from; they run on the device of the tensors
they are given.  ``PlanTables`` keeps a plan's tables on a device, so a
request that reuses them copies nothing from the host (and can be captured
into a CUDA graph).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bounds as bounds_mod
from repro_torch.core.decoding import DecodePanelCache
from repro_torch.core.numerics import (
    capturing,
    complex_dtype,
    resolve_device,
    resolve_dtype,
    tracing,
)
from repro_torch.core.points import extend_points, make_points
from repro_torch.core.schemes import Scheme, make_scheme

__all__ = ["CodedMatmulPlan", "PlanTables", "make_plan", "plan_from_arrays",
           "extend_plan", "shrink_plan", "encode_blocks", "worker_products",
           "fused_worker_products", "uncoded_matmul", "runtime_facade",
           "coded_matmul"]


@dataclasses.dataclass(frozen=True)
class CodedMatmulPlan:
    """Everything static about one coded matmul configuration."""

    scheme: Scheme
    K: int
    s: float
    z_points: np.ndarray          # (K,)
    coeff_a: np.ndarray           # (K, p, m) encode coefficients for A blocks
    coeff_b: np.ndarray           # (K, p, n)

    @property
    def tau(self) -> int:
        return self.scheme.tau

    @property
    def is_complex(self) -> bool:
        return np.iscomplexobj(self.z_points)

    def make_panel_cache(self, ridge: float = 0.0) -> DecodePanelCache:
        """Per-mask decode-panel cache (LU of the masked normal equations).

        Build ONE cache per plan and reuse it across steps: panels are
        factored on the host on first sight of an erasure pattern and
        amortised to a dict lookup afterwards.
        """
        return DecodePanelCache(self.scheme, self.z_points, ridge)


def make_plan(
    kind: str,
    p: int,
    m: int,
    n: int,
    K: int,
    L: int,
    *,
    p_prime: int = 1,
    points: str = "equispaced",
    s: Optional[float] = None,
    z_points: Optional[np.ndarray] = None,
) -> CodedMatmulPlan:
    """Freeze one coded-matmul configuration into a plan.

    kind:    scheme family - "bec" (Sec. III-B), "tradeoff" (Sec. IV, with
             ``p_prime``), or "polycode" (the Yu et al. baseline).
    p, m, n: block grid - A is split p x m, B is split p x n.
    K:       number of workers (evaluation points); must be >= the scheme's
             recovery threshold tau.
    L:       entry-product bound (Sec. III-D): every C entry and every
             interference product must have magnitude < L.
    points:  evaluation-point family ("equispaced" / "chebyshev" /
             "unit_circle").  Unit-circle points make a complex plan, which
             runs on the plain complex PyTorch path, never the kernels.
    s:       the digit base; default ``bounds.choose_s(L)`` - the smallest
             power of two >= 2L.  An explicit ``s`` must be >= 2.
    z_points: explicit (K,) evaluation points, overriding ``points``.
    """
    scheme = make_scheme(kind, p, m, n, p_prime=p_prime)
    if K < scheme.tau:
        raise ValueError(f"K={K} below recovery threshold tau={scheme.tau}")
    if z_points is not None:
        z = np.asarray(z_points)
        if z.shape != (K,):
            raise ValueError(f"z_points shape {z.shape} != ({K},)")
    else:
        z = make_points(points, K)
    s_val = float(s) if s is not None else float(bounds_mod.choose_s(L))
    if s_val < 2:
        raise ValueError(f"digit base s={s_val} must be >= 2 (and >= 2L={2 * L} "
                         "for exact digit extraction)")
    ca, cb = scheme.encode_coeffs(z, s_val)
    return CodedMatmulPlan(scheme=scheme, K=K, s=s_val, z_points=z,
                           coeff_a=ca, coeff_b=cb)


def plan_from_arrays(kind: str, p: int, m: int, n: int, p_prime: int, K: int,
                     s: float, z_points, coeff_a, coeff_b) -> CodedMatmulPlan:
    """A plan from another package's plan fields, given as plain values.

    ``kind`` is a scheme family name as for :func:`make_plan`; the arrays
    are copied as numpy arrays, unchanged, so a plan built elsewhere
    decodes here with bit-identical tables.

    Raises:
        ValueError: if the array shapes disagree with (K, p, m, n).
    """
    scheme = make_scheme(kind, p, m, n, p_prime=p_prime)
    z = np.array(z_points)
    ca = np.array(coeff_a)
    cb = np.array(coeff_b)
    if z.shape != (K,) or ca.shape != (K, p, m) or cb.shape != (K, p, n):
        raise ValueError(
            f"plan arrays z {z.shape}, coeff_a {ca.shape}, coeff_b {cb.shape} "
            f"do not match K={K}, p={p}, m={m}, n={n}")
    if K < scheme.tau:
        raise ValueError(f"K={K} below recovery threshold tau={scheme.tau}")
    return CodedMatmulPlan(scheme=scheme, K=int(K), s=float(s), z_points=z,
                           coeff_a=ca, coeff_b=cb)


def extend_plan(plan: CodedMatmulPlan, g: int,
                z_new: Optional[np.ndarray] = None) -> CodedMatmulPlan:
    """Grow a plan by ``g`` workers via incremental point extension.

    Evaluation points extend by greedy Leja selection
    (``core.points.extend_points``) and ONLY the ``g`` new coefficient rows
    are computed, so the first K rows of the result are bit-identical to
    ``plan``'s.  ``z_new`` optionally supplies the already-extended
    ``(K + g,)`` point set (it must extend ``plan``'s points bit-exactly).
    """
    if g < 0:
        raise ValueError(f"g must be >= 0, got {g}")
    if g == 0:
        return plan
    if z_new is not None:
        z = np.asarray(z_new)
        if z.shape != (plan.K + g,) or not np.array_equal(
                z[:plan.K], np.asarray(plan.z_points)):
            raise ValueError(
                f"z_new must extend the plan's {plan.K} points by {g}")
    else:
        z = extend_points(plan.z_points, g)
    ca_new, cb_new = plan.scheme.encode_coeffs(z[plan.K:], plan.s)
    return CodedMatmulPlan(
        scheme=plan.scheme, K=plan.K + g, s=plan.s, z_points=z,
        coeff_a=np.concatenate([plan.coeff_a, ca_new], axis=0),
        coeff_b=np.concatenate([plan.coeff_b, cb_new], axis=0))


def shrink_plan(plan: CodedMatmulPlan, keep: Sequence[int]) -> CodedMatmulPlan:
    """Shrink a plan to the ``keep`` workers (pool-local indices, in order).

    Survivors keep their evaluation points and coefficient rows (sliced,
    not re-encoded - bit-identical).

    Raises:
        ValueError: if ``keep`` has duplicates, indexes outside the pool,
            or leaves fewer than ``tau`` workers (undecodable).
    """
    idx = np.asarray(keep, dtype=np.intp)
    if idx.ndim != 1 or len(set(idx.tolist())) != idx.size:
        raise ValueError(f"keep must be 1-D and duplicate-free, got {keep!r}")
    if idx.size and (idx.min() < 0 or idx.max() >= plan.K):
        raise ValueError(f"keep indexes outside the pool of {plan.K} workers")
    if idx.size < plan.tau:
        raise ValueError(
            f"shrinking to {idx.size} workers breaks tau={plan.tau}")
    return CodedMatmulPlan(
        scheme=plan.scheme, K=int(idx.size), s=plan.s,
        z_points=plan.z_points[idx],
        coeff_a=plan.coeff_a[idx], coeff_b=plan.coeff_b[idx])


def _coeff_dtype(x: torch.Tensor, plan: CodedMatmulPlan) -> torch.dtype:
    if plan.is_complex:
        return complex_dtype(x.dtype)
    return x.dtype


class PlanTables:
    """A plan's host tables (``coeff_a``, ``coeff_b``, ``z_points``) as
    tensors, uploaded once per (table, dtype, device) and kept.

    A pipeline holds one, so only its first eager call copies from the host;
    a CUDA graph captured after that call reads the kept tensors.  Under a
    dispatch mode (a ``make_fx`` or fake-tensor trace) each table is made
    anew as a constant of the trace and not kept: a kept real tensor cannot
    enter a fake trace, nor a fake one a later eager call.
    """

    def __init__(self, plan: CodedMatmulPlan):
        self.plan = plan
        self._kept: dict = {}

    def get(self, name: str, dtype: torch.dtype, device) -> torch.Tensor:
        """The table ``name`` of the plan as a tensor of ``dtype`` on ``device``.

        Raises:
            RuntimeError: when the table is not kept yet while a CUDA stream
                is being captured (a capture cannot copy from the host): make
                one eager call of the same pipeline first.
        """
        def upload():
            return torch.as_tensor(getattr(self.plan, name), dtype=dtype,
                                   device=device)

        if tracing():
            return upload()
        key = (name, dtype, torch.device(device))
        table = self._kept.get(key)
        if table is None:
            if capturing():
                raise RuntimeError(
                    f"the plan's {name} table is not on {device} yet and a CUDA "
                    f"graph capture cannot copy it from the host: run the same "
                    f"call once eagerly before capturing it")
            table = self._kept[key] = upload()
        return table

    def coeffs(self, a_blocks: torch.Tensor, b_blocks: torch.Tensor) -> tuple:
        """(coeff_a (K, p, m), coeff_b (K, p, n)), each in its operand's
        coefficient dtype (complex for a complex plan) on its device."""
        return (self.get("coeff_a", _coeff_dtype(a_blocks, self.plan), a_blocks.device),
                self.get("coeff_b", _coeff_dtype(b_blocks, self.plan), b_blocks.device))


def encode_blocks(plan: CodedMatmulPlan, a_blocks: torch.Tensor,
                  b_blocks: torch.Tensor, tables: Optional[PlanTables] = None):
    """a_blocks: (p, m, bv, br), b_blocks: (p, n, bv, bt)
    -> (K, bv, br), (K, bv, bt) coded matrices per worker.  ``tables``
    keeps the coefficients on the device across calls (default: uploaded
    for this call)."""
    ca, cb = (tables or PlanTables(plan)).coeffs(a_blocks, b_blocks)
    a_tilde = torch.einsum("kpm,pmvr->kvr", ca, a_blocks.to(ca.dtype))
    b_tilde = torch.einsum("kpn,pnvt->kvt", cb, b_blocks.to(cb.dtype))
    return a_tilde, b_tilde


def worker_products(a_tilde: torch.Tensor, b_tilde: torch.Tensor) -> torch.Tensor:
    """Per-worker products Y_k = A~_k^T B~_k: (K, bv, br), (K, bv, bt) -> (K, br, bt)."""
    return torch.einsum("kvr,kvt->krt", a_tilde, b_tilde)


def fused_worker_products(plan: CodedMatmulPlan, a_blocks: torch.Tensor,
                          b_blocks: torch.Tensor,
                          tables: Optional[PlanTables] = None) -> torch.Tensor:
    """All worker products via the fused encode+product kernel.

    a_blocks: (p, m, bv, br), b_blocks: (p, n, bv, bt) -> (K, br, bt).
    Equivalent to encode_blocks + worker_products, but on the card the
    coded matrices A~, B~ are formed only tile-wise in shared memory.  The
    block views go to the kernel as they are (offsets + row stride), with
    no copy into a (p*m, bv, br) stack.  ``tables`` as for
    :func:`encode_blocks`.
    """
    from repro_torch.kernels import ops as kops

    ca, cb = (tables or PlanTables(plan)).coeffs(a_blocks, b_blocks)
    return kops.fused_worker(ca.reshape(plan.K, -1), cb.reshape(plan.K, -1),
                             a_blocks, b_blocks)


# ---------------------------------------------------------------------------
# Legacy entry point: deprecation shim over the unified runtime.
# ---------------------------------------------------------------------------

_RUNTIME_FACADES: dict = {}
_RUNTIME_FACADES_MAX = 64


def runtime_facade(plan: CodedMatmulPlan, backend: str = "fused",
                   dtype=torch.float64, *, panel_cache=None, device=None,
                   **opts):
    """Module-level memo of ``repro_torch.runtime.CodedMatmul`` facades.

    Keyed by plan VALUE (scheme geometry + points + base), not identity, so
    equal plans share one facade - and therefore one decode-panel cache and
    one pipeline memo - across shim calls.  The key also holds the dtype,
    the backend, the device (``None`` resolves to the card, as every entry
    point does, or on mesh to the rank's device), the facade keywords in
    ``opts`` (the mesh, axis and kernel flags) and a caller-supplied
    ``panel_cache`` by identity: callers
    with their own caches get their own facades instead of clobbering the
    shared one.  The memo is FIFO-bounded so long-lived processes churning
    through many distinct plans cannot pin pipelines without limit.
    """
    from repro_torch.runtime import CodedMatmul

    dev = resolve_device(device, opts.get("mesh"))
    dt = resolve_dtype(dtype)
    key = (plan.scheme, plan.K, plan.s,
           tuple(np.asarray(plan.z_points).ravel().tolist()),
           str(dt), backend, str(dev),
           None if panel_cache is None else id(panel_cache),
           tuple(sorted(opts.items(), key=lambda kv: kv[0])))
    cm = _RUNTIME_FACADES.get(key)
    if cm is None:
        cm = CodedMatmul(plan, backend, dtype=dt, device=dev, **opts)
        if panel_cache is not None:
            # the facade holds the reference, so id(panel_cache) stays
            # valid for as long as this memo entry lives
            cm.panel_cache = panel_cache
        while len(_RUNTIME_FACADES) >= _RUNTIME_FACADES_MAX:
            _RUNTIME_FACADES.pop(next(iter(_RUNTIME_FACADES)))
        _RUNTIME_FACADES[key] = cm
    return cm


def coded_matmul(
    A,
    B,
    plan: CodedMatmulPlan,
    *,
    erased: Optional[Sequence[int]] = None,
    survivors: Optional[Sequence[int]] = None,
    dtype=torch.float64,
    fused: bool = False,
    device=None,
) -> torch.Tensor:
    """DEPRECATED: use ``repro_torch.runtime.CodedMatmul`` instead.

    Compute C = A^T B through the coded pipeline.  A: (v, r), B: (v, t).
    ``erased`` lists worker ids treated as stragglers; alternatively pass an
    explicit ``survivors`` set (decoding weights ALL listed survivors, so
    order does not matter).  Exact for integer matrices within the plan's
    numeric bounds.  ``fused=True`` selects the fused kernel backend,
    ``fused=False`` the plain reference backend.  ``device`` defaults to
    the card (``"cpu"`` runs the plain versions).
    """
    warnings.warn(
        "coded_matmul is deprecated; use repro_torch.runtime.CodedMatmul "
        "(plan facade with pluggable backends and pipeline caching)",
        DeprecationWarning, stacklevel=2)
    if erased is not None and survivors is not None:
        raise ValueError("pass only one of erased/survivors")
    cm = runtime_facade(plan, "fused" if fused else "reference", dtype,
                        device=device)
    return cm(A, B, erased=erased, survivors=survivors)


def uncoded_matmul(A: torch.Tensor, B: torch.Tensor,
                   dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Direct C = A^T B reference; leading batch dims broadcast on either side."""
    return torch.einsum("...vr,...vt->...rt", A.to(dtype), B.to(dtype))
