"""``CodedMatmul``: one executor-agnostic entry point for coded matmuls.

The facade owns:

* the ``DecodePanelCache`` (host-LU decode weights per erasure pattern);
* erasure normalisation (``erased=`` / ``survivors=`` / 0/1 ``mask``) into
  one ``ErasurePattern``, concrete or traced: a mask or progress tensor the
  host must not read (any tensor while a CUDA graph is being captured, or
  a tensor of a ``make_fx`` / fake-tensor trace) takes the traced kinds,
  whose panels are built on the device, so a captured request replays
  under every survivor set written into its mask buffer;
* partial stragglers: ``sub_tasks=Q`` / ``progress=`` / ``PartialPattern``
  decode each of Q row chunks from the workers whose completed prefix
  covers it (``runtime/partial.py``); ``Q = 1`` with a binary spec is the
  binary path, bit for bit;
* split stages: ``worker_stage`` (encode + worker products) and
  ``decode_stage`` (erase + decode), whose composition equals the one-shot
  call;
* batching: leading batch dimensions on A and/or B (a loop over the
  flattened batch, one erasure pattern for the whole batch);
* a pipeline memo keyed by (plan, backend, shapes, dtype, device, kind)
  with build/hit counters, so repeated serving calls - including calls with
  NEW erasure or progress patterns - reuse one pipeline.  PyTorch runs
  eagerly, so a "build" makes the pipeline closure; nothing compiles per
  pattern (the CUDA libraries are built once per process, at first use).
  With ``repro_torch.obs`` on, the memo counts
  ``runtime.executable.{hit,compile}{kind}`` and records a
  ``runtime.executable.build`` span, under the reference's names;
* spans at its layer boundaries: ``runtime.call`` (a whole call, the root
  of every span it makes) holds ``runtime.prepare`` (the pattern, its
  checks, the memo, the panel lookup ``decode.panel.get`` and the
  uploads), then the pipeline's ``stage.worker`` and ``stage.decode``
  (``runtime/executors.py``).  Each host-to-device copy of a call (mask
  and panel W, or chunk masks and panel stack) is a ``runtime.upload``
  span and counts ``runtime.upload{what}``.  They reach a recording
  ``torch.profiler`` as ranges even with obs off.

Usage::

    cm = CodedMatmul(plan)                      # fused kernels, on the card
    C  = cm(A, B, erased=[3])                   # or survivors=/mask=
    C1 = cm(A, B, progress=prog, sub_tasks=4)   # partial stragglers
    C2 = cm.with_backend("staged")(A, B)        # same caches, new backend
    C3 = CodedMatmul(plan, "mesh", mesh=mesh)(A, B)   # on every rank

    mask = torch.ones(plan.K, device="cuda")    # a device buffer
    g, C4 = cm.capture(A, B, mask=mask)         # one request in a CUDA graph
    mask.copy_(new_mask); g.replay()            # C4 under the new survivors
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.api import CodedMatmulPlan
from repro_torch.core.numerics import capturing, complex_dtype, resolve_device, resolve_dtype
from repro_torch.runtime.erasure import ErasurePattern
from repro_torch.runtime.executors import (
    Executor,
    MeshExecutor,
    local_backend_names,
    resolve_executor,
)
from repro_torch.runtime.partial import PartialPattern

__all__ = ["CodedMatmul", "CacheGroup", "plan_token"]


def _kind_label(kind) -> str:
    """Bounded-cardinality metric label for a pipeline kind."""
    return kind if isinstance(kind, str) else str(kind[0])


def _is_traced_kind(kind) -> bool:
    label = _kind_label(kind)
    return label == "traced" or label.endswith("-traced")


def plan_token(plan: CodedMatmulPlan):
    """Hashable identity of a plan's static configuration.

    Folds in everything a pipeline or decode panel depends on: the scheme
    (frozen geometry dataclass), worker count, digit base, and evaluation
    points.  Equal-valued plans share a token even when they are distinct
    objects.
    """
    return (plan.scheme, plan.K, plan.s,
            tuple(np.asarray(plan.z_points).ravel().tolist()))


class CacheGroup:
    """Cross-facade shared caches for a FAMILY of plans.

    ``CodedMatmul.with_backend`` already shares caches between sibling
    facades of ONE plan; a ``CacheGroup`` extends that to many plans.
    Pipeline keys fold in each facade's plan token, so distinct plans never
    alias a pipeline, while the build/hit counters span the whole group.
    Decode-panel caches remain per-plan (panels depend on the scheme and
    evaluation points) but live here so every facade of the same plan
    shares one.
    """

    def __init__(self):
        self.executables: dict = {}
        self.stats = {"builds": 0, "hits": 0}
        self._panel_caches: dict = {}

    def panel_cache_for(self, plan: CodedMatmulPlan, ridge: float = 0.0):
        """The group's shared ``DecodePanelCache`` for ``plan`` (built once
        per distinct plan token + ridge)."""
        key = (plan_token(plan), ridge)
        pc = self._panel_caches.get(key)
        if pc is None:
            pc = plan.make_panel_cache(ridge)
            self._panel_caches[key] = pc
        return pc

    def seed_extended_panels(self, old_plan: CodedMatmulPlan,
                             new_plan: CodedMatmulPlan,
                             ridge: float = 0.0) -> bool:
        """Seed ``new_plan``'s panel cache from ``old_plan``'s by extension.

        When ``new_plan``'s evaluation points extend ``old_plan``'s
        (bit-exact prefix), every cached decode panel transfers with zero
        columns for the new workers (``DecodePanelCache.extended``).
        Returns True when seeding happened; False when there was nothing to
        seed from, the new cache already exists, or the points do not extend.
        """
        old = self._panel_caches.get((plan_token(old_plan), ridge))
        new_key = (plan_token(new_plan), ridge)
        if old is None or new_key in self._panel_caches:
            return False
        try:
            self._panel_caches[new_key] = old.extended(
                np.asarray(new_plan.z_points))
        except ValueError:
            return False
        return True

    @property
    def panel_builds(self) -> int:
        """Total decode panels built across every member plan."""
        return sum(pc.builds for pc in self._panel_caches.values())

    def cache_info(self) -> dict:
        """Group-wide pipeline and decode-panel cache counters."""
        return {
            "builds": self.stats["builds"],
            "hits": self.stats["hits"],
            "entries": len(self.executables),
            "panel_builds": self.panel_builds,
            "plans": len(self._panel_caches),
        }


class CodedMatmul:
    """Coded C = A^T B with a pluggable execution backend.

    A: (*batch, v, r), B: (*batch, v, t) -> C: (*batch, r, t).  Leading
    batch dimensions must match on A and B, or be present on only one of
    them.  The erasure pattern applies to the whole batch (one survivor set
    per serving step).

    Backends: "fused" (default) | "staged" (the CUDA kernels on the card,
    their plain versions on the CPU) | "reference" (plain PyTorch) |
    "mesh" (pass ``mesh=``, a ``DeviceMesh``: one worker per rank along
    ``axis``, every rank making the same call; ``use_kernels`` and
    ``fused`` choose its worker product).  ``device`` defaults to the CUDA
    card (on mesh, to the rank's device: the CPU for a CPU mesh); without
    one, construction raises unless the caller passes ``device="cpu"``.
    ``dtype`` is float64 (default) or float32.  ``sub_tasks`` (Q) splits
    every worker's output rows into Q partial-straggler chunks.  All
    backends are bit-identical for integer inputs within the plan's bounds.
    """

    def __init__(self, plan: CodedMatmulPlan, backend="fused", *,
                 dtype=torch.float64, device=None, mesh=None,
                 axis: str = "model", use_kernels: bool = True,
                 fused: bool = True, panel_ridge: float = 0.0,
                 cache_group: Optional[CacheGroup] = None,
                 sub_tasks: int = 1, _shared=None):
        if sub_tasks < 1:
            raise ValueError(f"need sub_tasks >= 1, got {sub_tasks}")
        self.sub_tasks = int(sub_tasks)
        self.plan = plan
        self.dtype = resolve_dtype(dtype)
        self._mesh = mesh
        self._axis = axis
        self._use_kernels = use_kernels
        self._fused = fused
        self._plan_token = plan_token(plan)
        self._executor: Executor = resolve_executor(
            backend, mesh=mesh, axis=axis, use_kernels=use_kernels,
            fused=fused)
        if device is None and isinstance(self._executor, MeshExecutor):
            device = self._executor.device
        self.device = resolve_device(device)
        if cache_group is not None and _shared is not None:
            raise ValueError("pass cache_group or _shared, not both")
        if cache_group is not None:
            self.panel_cache = cache_group.panel_cache_for(plan, panel_ridge)
            self._executables = cache_group.executables
            self._stats = cache_group.stats
        elif _shared is not None:
            self.panel_cache, self._executables, self._stats = _shared
        else:
            self.panel_cache = plan.make_panel_cache(panel_ridge)
            self._executables = {}
            self._stats = {"builds": 0, "hits": 0}

    # -- backend plumbing ---------------------------------------------------
    @property
    def backend(self) -> str:
        """Name of the executor serving this facade's calls."""
        return self._executor.name

    def with_backend(self, backend, *, mesh=None, axis: Optional[str] = None,
                     use_kernels: Optional[bool] = None,
                     fused: Optional[bool] = None) -> "CodedMatmul":
        """A sibling facade on another backend, SHARING panel + pipeline
        caches; the mesh keywords default to this facade's."""
        return CodedMatmul(
            self.plan, backend, dtype=self.dtype, device=self.device,
            mesh=self._mesh if mesh is None else mesh,
            axis=self._axis if axis is None else axis,
            use_kernels=self._use_kernels if use_kernels is None else use_kernels,
            fused=self._fused if fused is None else fused,
            sub_tasks=self.sub_tasks,
            _shared=(self.panel_cache, self._executables, self._stats))

    def cache_info(self) -> dict:
        """Pipeline-memo and panel-cache counters (tests assert on these)."""
        return {
            "builds": self._stats["builds"],
            "hits": self._stats["hits"],
            "entries": len(self._executables),
            "panel_builds": self.panel_cache.builds,
        }

    def executable_cache_size(self) -> int:
        """Memoised pipeline closures (shared with sibling facades).

        The reference counts jit-compiled specialisations; PyTorch compiles
        nothing per call, so each memoised pipeline counts once.  New
        erasure or progress patterns leave it unchanged.
        """
        return len(self._executables)

    # -- the call -----------------------------------------------------------
    def __call__(self, A, B, erasure: Any = None, *,
                 erased: Optional[Sequence[int]] = None,
                 survivors: Optional[Sequence[int]] = None,
                 mask: Any = None, progress: Any = None,
                 sub_tasks: Optional[int] = None) -> torch.Tensor:
        """Coded C = A^T B under at most one erasure spec (none = all alive).

        Args:
            A: (*batch, v, r) left operand (tensor or array; moved to the
                facade's device).
            B: (*batch, v, t) right operand.
            erasure: positional spec - an ``ErasurePattern``, a
                ``PartialPattern``, a (K,) 0/1 mask (an eager tensor mask
                is read to the host; a traced one never is), or a list of
                erased worker ids.
            erased / survivors / mask: keyword alternatives.
            progress: (K,) fractional progress in [0, 1] (read to the host
                unless traced) - routes through the partial-straggler decode.
            sub_tasks: per-call override of the facade's sub-task count Q.
                ``Q > 1`` (or an explicit ``progress``/``PartialPattern``)
                selects the partial path; ``Q = 1`` with binary specs is
                the binary path, bit for bit.

        Returns:
            (*batch, r, t) decoded product on the facade's device.

        A traced mask or progress vector skips the panel cache and, as in
        the reference package, the survivor and span checks (they would
        read it): it must leave >= tau survivors on every chunk, or C is
        wrong, not refused.

        Raises:
            ValueError: on conflicting erasure specs, rank-<2 operands,
                contraction mismatch, fewer than tau survivors, or a partial
                progress vector that does not span the decoding system.
            RuntimeError: for a concrete pattern while a CUDA stream is
                being captured (its host panel cannot be copied in).
        """
        Q = self.sub_tasks if sub_tasks is None else int(sub_tasks)
        partial = Q > 1 or progress is not None or isinstance(erasure, PartialPattern)
        with obs.span("runtime.call", kind="partial" if partial else "binary", Q=Q):
            with obs.span("runtime.prepare"):
                if Q < 1:
                    raise ValueError(f"need sub_tasks >= 1, got {Q}")
                if partial:
                    pattern = PartialPattern.normalize(
                        self.plan.K, Q, erasure, progress=progress, erased=erased,
                        survivors=survivors, mask=mask)
                    fn, A, B, data = self._partial_call(A, B, pattern)
                else:
                    pattern = ErasurePattern.normalize(
                        self.plan.K, erasure, erased=erased, survivors=survivors,
                        mask=mask)
                    A, B = self._operands(A, B)
                    fn = self._get_executable(A, B, pattern.kind)
                    data = self._binary_data(pattern)
            return fn(A, B, *data)

    def capture(self, A, B, *, mask: Optional[torch.Tensor] = None,
                progress: Optional[torch.Tensor] = None) -> tuple:
        """Capture one request into a CUDA graph that reads its survivor set
        from a device tensor.

        ``mask`` is a (K,) 0/1 tensor, or ``progress`` a (K,) tensor of
        fractional progress (split into the facade's ``sub_tasks`` Q
        chunks), on the facade's CUDA device.  The request takes the traced kind
        (``"traced"`` or ``("partial-traced", Q)``): its decode panel is
        built on the card from the tensor, never read by the host.  One
        eager request of that kind runs first on a side stream, as
        ``torch.cuda.graphs`` asks: it builds the pipeline, keeps the plan's
        tables on the card and loads the kernels and the solver, which a
        capture cannot do.  The kernels' launch counts move at that request
        and at the capture, not at replays.

        Returns:
            ``(graph, C)``: ``graph.replay()`` recomputes C (the same
            tensor, rewritten) from what A, B and the mask or progress
            tensor hold then.  Write a new survivor set into the tensor in
            place and replay to serve it.  As in the reference's traced
            kinds, nothing checks that it leaves >= tau survivors on every
            chunk.  A and B are read at replay only if they already lay on
            the facade's device (else their copies made here are).

        Raises:
            ValueError: unless exactly one of ``mask`` / ``progress`` is
                given, as a (K,) CUDA tensor.
        """
        data = mask if progress is None else progress
        if ((mask is None) == (progress is None) or self.device.type != "cuda"
                or not isinstance(data, torch.Tensor) or not data.is_cuda
                or tuple(data.shape) != (self.plan.K,)):
            raise ValueError(f"capture needs a facade on a CUDA device and exactly "
                             f"one of mask= / progress=, a ({self.plan.K},) CUDA tensor")
        A, B = self._operands(A, B)
        if progress is None:
            pattern = ErasurePattern(self.plan.K, "traced", mask)
        else:
            pattern = PartialPattern(self.plan.K, self.sub_tasks, "traced", progress)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self(A, B, pattern)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            C = self(A, B, pattern)
        return graph, C

    # -- split-stage serving -------------------------------------------------
    def worker_stage(self, A, B) -> torch.Tensor:
        """Stages 1+2 only: encode + ALL-K worker products (no erase/decode).

        The returned (*batch, K, br, bt) padded block products are what the
        workers hand back before any erasure is applied; feed them to
        :meth:`decode_stage` (with the erasure pattern observed meanwhile)
        to finish the step.  The composition equals the one-shot call.
        """
        A, B = self._operands(A, B)
        return self._get_executable(A, B, "products")(A, B)

    def decode_stage(self, Y, rt, erasure: Any = None, *,
                     erased: Optional[Sequence[int]] = None,
                     survivors: Optional[Sequence[int]] = None,
                     mask: Any = None, progress: Any = None,
                     sub_tasks: Optional[int] = None) -> torch.Tensor:
        """Stages 3+4: erase + decode a :meth:`worker_stage` result.

        Args:
            Y: (*batch, K, br, bt) worker products from THIS facade's
                :meth:`worker_stage` (same plan, same operand shapes); it is
                not modified.
            rt: the original trailing dims ``(r, t)`` =
                ``(A.shape[-1], B.shape[-1])``, which the padded products no
                longer carry.
            erasure / erased / survivors / mask: binary erasure spec, as
                for ``__call__`` (a traced mask takes the
                ``("decode-traced", r, t)`` pipeline).
            progress / sub_tasks: rejected - partial-straggler specs have
                no split-stage path.

        Returns:
            (*batch, r, t) decoded product, equal to the one-shot call under
            the same pattern.

        Raises:
            ValueError: on conflicting specs or fewer than tau survivors.
            NotImplementedError: for partial/progress specs: split-stage
                decode has no per-chunk panel path - serve partial patterns
                one-shot via ``cm(A, B, progress=..., sub_tasks=Q)``.
        """
        if (progress is not None
                or (sub_tasks is not None and int(sub_tasks) != 1)
                or isinstance(erasure, PartialPattern)):
            raise NotImplementedError(
                "split-stage decode has no per-chunk panel path: "
                "decode_stage accepts only binary erasure specs "
                "(erasure= / erased= / survivors= / mask=). Serve partial "
                "patterns one-shot via cm(A, B, progress=..., sub_tasks=Q) "
                f"- supported on every ported backend: "
                f"{local_backend_names()}.")
        Y = torch.as_tensor(Y, device=self.device)
        r, t = int(rt[0]), int(rt[1])
        pattern = ErasurePattern.normalize(
            self.plan.K, erasure, erased=erased, survivors=survivors,
            mask=mask)
        style = "decode" if pattern.is_concrete else "decode-traced"
        fn = self._get_decode_executable(Y, (style, r, t))
        return fn(Y, *self._binary_data(pattern))

    # -- helpers -------------------------------------------------------------
    def _operands(self, A, B) -> tuple:
        A = torch.as_tensor(A, device=self.device)
        B = torch.as_tensor(B, device=self.device)
        if A.ndim < 2 or B.ndim < 2:
            raise ValueError(f"need >= 2-D operands, got {tuple(A.shape)} / "
                             f"{tuple(B.shape)}")
        if A.shape[-2] != B.shape[-2]:
            raise ValueError(f"contraction mismatch {tuple(A.shape)} vs "
                             f"{tuple(B.shape)}")
        a_batch, b_batch = A.ndim - 2, B.ndim - 2
        if a_batch and b_batch and A.shape[:-2] != B.shape[:-2]:
            raise ValueError(
                f"batch mismatch: A has leading dims {tuple(A.shape[:-2])}, "
                f"B has {tuple(B.shape[:-2])}; batch one operand or both "
                f"equally")
        return A, B

    def _binary_data(self, pattern: ErasurePattern) -> tuple:
        """(mask, W) for a concrete pattern, after the survivor-count check;
        (mask,) for a traced one, unchecked."""
        if not pattern.is_concrete:
            return (pattern.mask_array(self.dtype, self.device),)
        _refuse_host_panel_under_capture()
        if pattern.n_survivors < self.plan.tau:
            raise ValueError(
                f"only {pattern.n_survivors} survivors < "
                f"tau={self.plan.tau}: undecodable")
        panel = self.panel_cache.get(pattern.mask)
        return (self._upload("mask", pattern.mask, self.dtype),
                self._upload("panel", panel.W, self._decode_dtype()))

    def _partial_call(self, A, B, pattern: PartialPattern) -> tuple:
        """``(fn, A, B, data)`` of the partial-straggler decode path:
        per-chunk masks + panel stack (or, traced, the progress vector
        alone)."""
        A, B = self._operands(A, B)
        if not pattern.is_concrete:
            fn = self._get_executable(A, B, ("partial-traced", pattern.Q))
            return fn, A, B, (pattern.progress_array(self.dtype, self.device),)
        _refuse_host_panel_under_capture()
        pattern.require_decodable(self.plan.tau)
        fn = self._get_executable(A, B, ("partial", pattern.Q))
        cm = pattern.chunk_masks
        W_stack = self.panel_cache.get_partial(cm)
        return fn, A, B, (self._upload("chunk_masks", cm, self.dtype),
                          self._upload("panel_stack", W_stack, self._decode_dtype()))

    def _upload(self, what: str, host, dtype) -> torch.Tensor:
        """``host`` copied to the facade's device as ``dtype``: a
        ``runtime.upload`` span and one count of ``runtime.upload{what}``."""
        obs.count("runtime.upload", what=what)
        with obs.span("runtime.upload", what=what):
            return torch.as_tensor(host, dtype=dtype, device=self.device)

    # -- pipeline construction ---------------------------------------------
    def _memo(self, key, kind, build):
        kind = _kind_label(kind)
        fn = self._executables.get(key)
        if fn is not None:
            self._stats["hits"] += 1
            obs.count("runtime.executable.hit", kind=kind)
            return fn
        with obs.span("runtime.executable.build", kind=kind,
                      backend=self.backend):
            fn = build()
        self._executables[key] = fn
        self._stats["builds"] += 1
        obs.count("runtime.executable.compile", kind=kind)
        return fn

    def _get_executable(self, A, B, kind):
        # the token folds in the executor and the PLAN identity, so
        # CacheGroup members on different plans never alias a pipeline.
        key = (self._plan_token, self._executor.cache_token(), tuple(A.shape),
               tuple(B.shape), str(self.dtype), str(self.device),
               *self._kind_key(kind))
        return self._memo(key, kind, lambda: self._build(A.ndim - 2, B.ndim - 2, kind))

    def _get_decode_executable(self, Y, kind):
        # keyed on the PRODUCTS shape plus the static (r, t) in the kind;
        # leading dims beyond (K, br, bt) are batch dims of Y only.
        key = (self._plan_token, self._executor.cache_token(), tuple(Y.shape),
               str(self.dtype), str(self.device), *self._kind_key(kind))

        def build():
            base = self._make_pipeline(kind)
            if Y.ndim == 3:
                return base

            def batched(Y, *data):
                n = math.prod(Y.shape[:-3])
                Ys = Y.reshape(n, *Y.shape[-3:])
                return _stack_loop(n, lambda i: base(Ys[i], *data),
                                   Y.shape[:-3])

            return batched

        return self._memo(key, kind, build)

    def _kind_key(self, kind) -> tuple:
        # a traced pipeline builds its panels with the panel cache's ridge,
        # which facades sharing a memo (a CacheGroup) may set differently
        return (kind, self.panel_cache.ridge) if _is_traced_kind(kind) else (kind,)

    def _make_pipeline(self, kind):
        if _is_traced_kind(kind):
            return self._executor.make_pipeline(self.plan, kind, self.dtype,
                                                ridge=self.panel_cache.ridge)
        return self._executor.make_pipeline(self.plan, kind, self.dtype)

    def _build(self, a_batch: int, b_batch: int, kind):
        base = self._make_pipeline(kind)
        if not (a_batch or b_batch):
            return base

        # data operands after (A, B): (mask, W) / (chunk_masks, W_stack),
        # (mask,) / (progress,) for the traced kinds, or none for the split
        # worker stage; the pattern is one per batch.
        def batched(A, B, *data):
            batch = A.shape[:-2] if a_batch else B.shape[:-2]
            n = math.prod(batch)
            As = A.reshape(n, *A.shape[-2:]) if a_batch else A.expand(n, *A.shape)
            Bs = B.reshape(n, *B.shape[-2:]) if b_batch else B.expand(n, *B.shape)
            return _stack_loop(n, lambda i: base(As[i], Bs[i], *data), batch)

        return batched

    # -- dtype policy -------------------------------------------------------
    def _decode_dtype(self) -> torch.dtype:
        if self.plan.is_complex:
            return complex_dtype(self.dtype)
        return self.dtype


def _refuse_host_panel_under_capture() -> None:
    if capturing():
        raise RuntimeError(
            "a concrete erasure or progress pattern decodes with a host-built "
            "panel, which a CUDA graph capture cannot copy in: pass the mask "
            "or progress as a device tensor (the traced kinds)")


def _stack_loop(n: int, one, batch) -> torch.Tensor:
    """``one(i)`` for i < n, written into one (*batch, ...) result."""
    first = one(0)
    out = first.new_empty((n, *first.shape))
    out[0] = first
    for i in range(1, n):
        out[i] = one(i)
    return out.reshape(*batch, *first.shape)
