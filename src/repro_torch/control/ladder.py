"""``PlanLadder``: the paper's L <-> tau plan family as one switchable unit.

One ladder freezes the shared geometry ``(p, m, n, K)`` and entry bound
``L`` and instantiates every rung of the paper's tradeoff:

    bec                    tau = m n                (Sec. III-B, deepest digits)
    tradeoff(p' | p)       tau = m n p' + p' - 1    (Sec. IV, one per divisor)
    polycode               tau = p m n + p - 1      (Yu et al., no digits)

Every rung gets its own ``CodedMatmul`` facade on the ladder's device, but
all facades share ONE ``runtime.CacheGroup``: decode panels persist per
plan and the pipeline memo spans the family (keys fold in the plan token),
so after ``prewarm()`` builds each rung once, ``switch()`` builds nothing -
the group's build counter staying flat across switches is asserted by tests
and the control bench.

``prewarm(..., batch_sizes=...)`` extends the same contract to batched
serving: each listed size becomes a leading-dim BUCKET built per rung, and
a batched call is rounded UP to the smallest covering bucket (zero rows
padded onto A, sliced back off the result), so variable per-request batch
sizes hit the fixed set of prewarmed pipelines.  The facade serves a batch
one request at a time, so a padded bucket of 8 for a batch of 5 launches
the path's kernels 8 times: the reference's pad-to-bucket semantics, kept.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import bounds as bounds_mod
from repro_torch.core.api import CodedMatmulPlan, extend_plan, make_plan
from repro_torch.core.numerics import resolve_device, resolve_dtype
from repro_torch.core.points import make_points
from repro_torch.core.schemes import make_scheme
from repro_torch.runtime import CacheGroup, CodedMatmul

__all__ = ["PlanLadder"]


def _divisors(p: int) -> Tuple[int, ...]:
    return tuple(d for d in range(1, p + 1) if p % d == 0)


class PlanLadder:
    """The bec <-> tradeoff(p') <-> polycode family over shared (p, m, n, K).

    Rungs whose recovery threshold exceeds ``K`` are dropped at
    construction (they could never decode).  ``rungs`` lists the survivors
    in ascending-tau order; ``active`` starts at the lowest threshold.
    ``device`` defaults to the CUDA card (``resolve_device``), or with a
    ``mesh`` to the rank's device; the CPU runs only when the caller asks
    for it.  ``mesh`` goes to every facade the ladder builds (the "mesh"
    backend, one worker per rank): its "model" axis must hold K ranks, so a
    respecialisation to another K meets the facade's "mesh axis" refusal
    at its first call.
    """

    def __init__(self, p: int, m: int, n: int, K: int, L: int, *,
                 backend: str = "reference", dtype=torch.float64,
                 points: str = "chebyshev", device=None, mesh=None,
                 include: Optional[Sequence[str]] = None):
        self.grid = (p, m, n)
        self.K = K
        self.L = L
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device, mesh)
        self._mesh = mesh
        self.group = CacheGroup()
        self.switch_count = 0
        self.step_overhead_s: dict = {}
        self._buckets: Tuple[int, ...] = ()
        self._backend = backend
        self._prewarm_args: Optional[dict] = None

        specs = [("bec", dict(kind="bec"))]
        specs += [(f"tradeoff(p'={pp})", dict(kind="tradeoff", p_prime=pp))
                  for pp in _divisors(p) if 1 < pp < p]
        specs.append(("polycode", dict(kind="polycode")))
        self._specs = tuple(specs)

        # one shared point set for every rung: the pool IS the points, and
        # the elastic paths resize them as a unit (respecialize).
        self.z_points = make_points(points, K)
        self._plans: dict = {}
        self._facades: dict = {}
        for name, spec in specs:
            if include is not None and name not in include:
                continue
            if make_scheme(spec["kind"], p, m, n,
                           p_prime=spec.get("p_prime", 1)).tau > K:
                continue  # this rung can never decode with K workers
            plan = make_plan(spec["kind"], p, m, n, K=K, L=L,
                             p_prime=spec.get("p_prime", 1),
                             z_points=self.z_points)
            self._plans[name] = plan
            self._facades[name] = self._facade(plan)
        if not self._plans:
            raise ValueError(
                f"no rung of grid (p={p}, m={m}, n={n}) fits K={K} workers")
        self._order = tuple(sorted(self._plans, key=lambda r: self.tau(r)))
        # start on the lowest-threshold rung that can decode EXACTLY at this
        # entry bound (an infeasible-only ladder still constructs; selection
        # through ExpectedLatencyPolicy will refuse it).
        self._active = next((r for r in self._order if self.feasible(r)),
                            self._order[0])

    def _facade(self, plan: CodedMatmulPlan) -> CodedMatmul:
        return CodedMatmul(plan, self._backend, dtype=self.dtype,
                           device=self.device, mesh=self._mesh,
                           cache_group=self.group)

    # -- rung accessors -----------------------------------------------------
    @property
    def rungs(self) -> Tuple[str, ...]:
        """Rung names in ascending-tau order."""
        return self._order

    def plan(self, rung: str) -> CodedMatmulPlan:
        """The frozen ``CodedMatmulPlan`` backing ``rung``."""
        return self._plans[self._check(rung)]

    def facade(self, rung: str) -> CodedMatmul:
        """The rung's ``CodedMatmul`` facade (shares the ladder's caches)."""
        return self._facades[self._check(rung)]

    def tau(self, rung: str) -> int:
        """The rung's recovery threshold."""
        return self._plans[self._check(rung)].tau

    def budget(self, rung: str) -> int:
        """The rung's erasure budget K - tau."""
        return self.K - self.tau(rung)

    def feasible(self, rung: str) -> bool:
        """Exact decode possible at the ladder's entry bound L: the rung's
        digit stack must fit the dtype mantissa (paper Sec. III-D/IV).

        The ``torch.dtype`` itself goes to ``bounds.is_safe``: its string
        form (``"torch.float64"``) is no dtype name there."""
        plan = self._plans[self._check(rung)]
        return bounds_mod.is_safe(self.L, plan.s, plan.scheme.digit_depth,
                                  self.dtype, tau=plan.tau)

    def _check(self, rung: str) -> str:
        if rung not in self._plans:
            raise KeyError(f"unknown rung {rung!r}; have {list(self._plans)}")
        return rung

    # -- the switchable facade ---------------------------------------------
    @property
    def active(self) -> str:
        """Name of the rung currently serving calls."""
        return self._active

    def switch(self, rung: str) -> CodedMatmul:
        """Make ``rung`` the active scheme (no rebuild after prewarm)."""
        rung = self._check(rung)
        if rung != self._active:
            obs.count("ladder.switch", rung=rung)
            self._active = rung
            self.switch_count += 1
        return self._facades[rung]

    # -- elastic handoff ----------------------------------------------------
    def respecialize(self, z_new, *, prewarm: bool = True) -> dict:
        """Re-lower the rung family onto a resized worker pool.

        ``z_new`` is the new pool's evaluation points: a survivor SUBSET
        of the current points (shrink) or a Leja EXTENSION of them (grow,
        ``core.points.extend_points``).  Rungs whose tau exceeds the new
        K drop out; rungs that fit again rejoin.  Respecialisation
        deliberately ignores the construction-time ``include`` filter -
        the filter models the operator's preferred rungs, but a handoff's
        job is to keep the job decodable on whatever pool remains, and
        the paper's L <-> tau tradeoff is exactly what makes a
        lower-threshold rung available when the preferred one no longer
        fits.

        The shared ``CacheGroup`` is REUSED: pipeline keys fold in the
        plan token (worker count + points), so nothing built for the old
        pool is evicted or aliased.  On grow, plans extend incrementally
        (``extend_plan`` - surviving workers' coefficient rows are reused
        bit-exactly) and each surviving rung's decode panels seed the grown
        plan's cache by zero-column padding
        (``CacheGroup.seed_extended_panels``), so no old-pool pattern is
        ever refactored.  When ``prewarm`` is True and the ladder was
        prewarmed before, the same prewarm arguments re-run so the
        post-handoff pool is warm before serving resumes.

        Returns ``cache_info()`` for the post-handoff group.

        Raises:
            ValueError: on a non-1-D/empty ``z_new`` or a pool too small
                for every rung in the family.
        """
        z = np.asarray(z_new)
        if z.ndim != 1 or z.size < 1:
            raise ValueError(f"need 1-D non-empty points, got shape {z.shape}")
        K_new = int(z.size)
        growing = K_new > self.K and np.array_equal(z[:self.K], self.z_points)
        p, m, n = self.grid
        plans: dict = {}
        facades: dict = {}
        for name, spec in self._specs:
            if make_scheme(spec["kind"], p, m, n,
                           p_prime=spec.get("p_prime", 1)).tau > K_new:
                continue
            old = self._plans.get(name)
            if growing and old is not None:
                plan = extend_plan(old, K_new - self.K, z_new=z)
                self.group.seed_extended_panels(old, plan)
            else:
                plan = make_plan(spec["kind"], p, m, n, K=K_new, L=self.L,
                                 p_prime=spec.get("p_prime", 1), z_points=z)
            plans[name] = plan
            facades[name] = self._facade(plan)
        if not plans:
            raise ValueError(
                f"no rung of grid (p={p}, m={m}, n={n}) fits K={K_new} "
                "workers")
        self._plans = plans
        self._facades = facades
        self.K = K_new
        self.z_points = z
        self._order = tuple(sorted(plans, key=lambda r: self.tau(r)))
        if self._active not in plans or not self.feasible(self._active):
            self._active = next((r for r in self._order if self.feasible(r)),
                                self._order[0])
        obs.count("ladder.respecialize",
                  direction="grow" if growing else "shrink")
        if prewarm and self._prewarm_args is not None:
            self.prewarm(**self._prewarm_args)
        return self.cache_info()

    def _pad(self, A, B) -> Tuple[torch.Tensor, torch.Tensor, Optional[int]]:
        """(A padded up to its bucket, B, true batch or None) on the device."""
        A = torch.as_tensor(A, device=self.device)
        B = torch.as_tensor(B, device=self.device)
        padded = self._bucketed_batch(A, B)
        if padded is None:
            return A, B, None
        n, bucket = padded
        pad = torch.zeros((bucket - n,) + tuple(A.shape[1:]),
                          dtype=A.dtype, device=A.device)
        return torch.cat([A, pad], dim=0), B, n

    def __call__(self, A, B, **erasure) -> torch.Tensor:
        """Coded C = A^T B on the ACTIVE rung.

        A single leading batch dimension on A is served through the
        prewarmed batch buckets when any were built: the batch is
        zero-padded up to the smallest covering bucket and the pad rows are
        sliced off the result, so the call hits an existing pipeline.
        Batches with no covering bucket - and batched-B calls, which the
        buckets are not built for - run at their true size (building a new
        pipeline on first use).
        """
        A, B, n = self._pad(A, B)
        C = self._facades[self._active](A, B, **erasure)
        return C if n is None else C[:n]

    def worker_stage(self, A, B) -> Tuple[torch.Tensor, dict]:
        """Stages 1+2 (encode + worker products) on the ACTIVE rung.

        Applies the same bucket round-up padding as ``__call__``, then
        stops BEFORE erase/decode.  Returns ``(Y, ctx)``: the (*batch, K,
        br, bt) worker products and the context :meth:`decode_stage` needs
        to finish the step later - the rung that produced Y (so a rung
        switch between the stages decodes with the RIGHT plan), the
        original trailing dims, and the true batch size to slice back to.
        Composing the two stages is bit-identical to ``__call__``.
        """
        A, B, n = self._pad(A, B)
        rt = (int(A.shape[-1]), int(B.shape[-1]))
        Y = self._facades[self._active].worker_stage(A, B)
        return Y, {"rung": self._active, "rt": rt, "batch": n}

    def decode_stage(self, Y, ctx: dict, **erasure) -> torch.Tensor:
        """Stages 3+4 for a :meth:`worker_stage` result (+ bucket unslice).

        ``ctx`` is the context dict ``worker_stage`` returned; the erasure
        keywords are those of ``CodedMatmul.decode_stage`` (binary specs
        only).  Decodes on the rung that PRODUCED Y even if the ladder has
        since switched.
        """
        C = self._facades[ctx["rung"]].decode_stage(Y, ctx["rt"], **erasure)
        n = ctx["batch"]
        return C if n is None else C[:n]

    def _bucketed_batch(self, A, B) -> Optional[Tuple[int, int]]:
        """(batch size, covering bucket) when padding applies, else None.

        Padding applies only to the prewarmed shape family: batched A with
        UNBATCHED B (buckets are built for exactly that), and only when the
        batch is not already a bucket size.
        """
        if not self._buckets or A.ndim != 3 or B.ndim != 2:
            return None
        n = int(A.shape[0])
        bucket = self.bucket_for(n)
        return (n, bucket) if bucket is not None and bucket != n else None

    def bucket_for(self, batch: int) -> Optional[int]:
        """Smallest prewarmed batch bucket covering ``batch`` (None if none)."""
        covering = [b for b in self._buckets if b >= batch]
        return min(covering) if covering else None

    @property
    def batch_buckets(self) -> Tuple[int, ...]:
        """Prewarmed leading-dim bucket sizes, ascending."""
        return self._buckets

    # -- pipeline building --------------------------------------------------
    def synchronize(self) -> None:
        """Wait for the ladder's card (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prewarm(self, a_shape: Sequence[int], b_shape: Sequence[int],
                reps: int = 1, batch_sizes: Sequence[int] = (),
                sub_tasks: int = 1, stages: bool = False) -> dict:
        """Build every rung for one problem shape; measure warm step cost.

        One call per rung with the full-survivor concrete pattern builds the
        (plan, backend, shape, dtype, device, kind="concrete") pipeline; any
        later concrete mask is pure data against it, so subsequent
        ``switch()``es never rebuild.  The timed warm repetition per rung
        (host clock, ended by a synchronize of the card) is stored in
        ``step_overhead_s`` - the measured per-rung decode/step cost the
        latency policies add to their order-statistic estimates (on a mesh,
        rank 0's measurement, broadcast to every rank).

        Args:
            a_shape/b_shape: unbatched operand shapes ``(v, r)`` / ``(v, t)``.
            reps: warm repetitions per rung for the overhead measurement.
            batch_sizes: leading-dim BUCKETS to additionally build per
                rung (batched A, shared B).  Later batched calls round up
                to the smallest covering bucket, so serving stays
                rebuild-free across batch sizes up to the largest bucket.
            sub_tasks: when > 1, additionally build each rung's
                partial-straggler pipeline for Q = ``sub_tasks`` (and per
                bucket), so serving with fractional progress is as
                rebuild-free as binary serving.
            stages: when True, additionally build the SPLIT-STAGE
                pipelines per rung (and per bucket): the "products" worker
                stage and the ("decode", r, t) stage.

        Returns:
            ``cache_info()`` plus the measured ``overhead_s`` per rung.

        Raises:
            ValueError: if any batch bucket is < 1.
        """
        if any(b < 1 for b in batch_sizes):
            raise ValueError(f"batch buckets must be >= 1, got {batch_sizes}")
        # remembered so an elastic respecialize() can re-prewarm the
        # post-handoff pool with the same shape family.
        self._prewarm_args = dict(
            a_shape=tuple(a_shape), b_shape=tuple(b_shape), reps=reps,
            batch_sizes=tuple(batch_sizes), sub_tasks=sub_tasks,
            stages=stages)
        self._buckets = tuple(sorted(set(int(b) for b in batch_sizes)))
        zeros = lambda shape: torch.zeros(  # noqa: E731
            tuple(shape), dtype=self.dtype, device=self.device)
        A, B = zeros(a_shape), zeros(b_shape)
        rt = (int(a_shape[-1]), int(b_shape[-1]))
        with obs.span("ladder.prewarm", rungs=len(self._order),
                      buckets=len(self._buckets), stages=int(stages)):
            for rung in self._order:
                cm = self._facades[rung]
                with obs.span("ladder.prewarm.rung", rung=rung):
                    cm(A, B, erased=[])  # build
                    self.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        cm(A, B, erased=[])
                    self.synchronize()
                    self.step_overhead_s[rung] = (
                        time.perf_counter() - t0) / reps
                    for a in (A, *(zeros((b,) + tuple(a_shape))
                                   for b in self._buckets)):
                        if a is not A:
                            cm(a, B, erased=[])
                        if sub_tasks > 1:
                            cm(a, B, sub_tasks=sub_tasks)
                        if stages:
                            cm.decode_stage(cm.worker_stage(a, B), rt,
                                            erased=[])
                    self.synchronize()
        if self._mesh is not None:
            # every rank makes the same call, so every rank must price the
            # rungs alike: rank 0's measurement for all
            box = [self.step_overhead_s]
            dist.broadcast_object_list(box, src=0)
            self.step_overhead_s = box[0]
        info = self.cache_info()
        info["overhead_s"] = dict(self.step_overhead_s)
        info["batch_buckets"] = self._buckets
        return info

    def cache_info(self) -> dict:
        """Group-wide cache counters (builds flat after prewarm = no rebuilds)."""
        info = self.group.cache_info()
        info["switches"] = self.switch_count
        return info
