"""Declarative straggler-regime DSL compiled to deterministic time feeds.

A control plane validated against ONE hand-rolled shifted-exponential
feed proves little.  Related work treats stragglers as erasures with
heterogeneous, partial, and correlated behaviour (Yu et al.; Das &
Ramamoorthy), so this module makes regimes first-class: a ``Scenario`` is
a frozen dataclass describing WHAT the cluster does (who slows down, when,
by how much), and ``compile(K, seed)`` turns it into a stateless
``core.simulator.TimeFeed`` — ``(step, rng) -> (K,) seconds`` — that any
consumer of per-worker finish times can drink from: ``simulate_completion``
(its ``feed=`` parameter), ``WorkerHealthMonitor.record_step``, and
``AdaptiveServer(feed=...)``.

Determinism contract: a compiled feed derives every random choice from
``(seed, step)`` via ``numpy.random.SeedSequence`` — it ignores the rng
argument the ``TimeFeed`` protocol passes in — and draws jitter through
``LatencyModel.sample(..., stable=True)`` (inverse-CDF over the uniform
bitstream, the only sampling path NumPy guarantees across versions).  This module
is the JAX package's ``repro.chaos.scenarios``, copied: the port replays
the checked-in golden traces, so every draw must match it bit for bit.  The
same ``(scenario, K, seed)`` therefore reproduces the identical time
matrix on any machine, which is what lets ``repro_torch.chaos.trace`` check
golden traces into the repo.

Every scenario also exposes ``calm()``: the same regime with its stressor
switched off (the "S = 0" control the bench compares against).

Registry: concrete scenarios self-register under ``Scenario.name`` via the
``@register`` decorator; ``make_scenario(name, **overrides)`` instantiates
one and ``scenario_names()`` lists the catalog.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Tuple, Type

import numpy as np

from repro_torch.core.simulator import LatencyModel, TimeFeed

__all__ = [
    "Scenario",
    "IIDShiftedExponential",
    "HeavyTailMixture",
    "ParetoTail",
    "BurstySlowdown",
    "FlappingWorkers",
    "CorrelatedRackFailure",
    "PoolResize",
    "Crawler",
    "Degrading",
    "register",
    "make_scenario",
    "scenario_names",
    "trace_matrix",
]


def _rng(seed: int, *path: int) -> np.random.Generator:
    """A Generator keyed on ``(seed, *path)`` — stateless, step-addressable."""
    return np.random.default_rng(np.random.SeedSequence((int(seed),) + tuple(int(p) for p in path)))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative straggler regime.

    Subclasses define the regime's parameters as frozen dataclass fields
    and implement ``times(step, K, seed)`` (the per-step finish-time law)
    plus ``calm()`` (the stress-free control variant).  ``compile``
    wraps ``times`` into a validated ``TimeFeed``.
    """

    #: registry key; subclasses override.
    name: ClassVar[str] = "scenario"

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """The (K,) per-worker finish times of ``step`` under ``seed``."""
        raise NotImplementedError

    def calm(self) -> "Scenario":
        """The same scenario with its stressor disabled (the S=0 control)."""
        raise NotImplementedError

    def compile(self, K: int, seed: int = 0) -> TimeFeed:
        """A deterministic ``TimeFeed`` over ``K`` workers.

        The returned feed satisfies the ``core.simulator.TimeFeed``
        protocol but ignores the rng argument: all randomness is derived
        from ``(seed, step)``, so two compilations with the same arguments
        produce bit-identical streams.

        Raises:
            ValueError: if ``K < 1``.
        """
        if K < 1:
            raise ValueError(f"need K >= 1 workers, got {K}")

        def feed(step: int, rng=None) -> np.ndarray:
            t = np.asarray(self.times(int(step), K, seed), dtype=np.float64)
            if t.shape != (K,):
                raise ValueError(
                    f"{type(self).__name__}.times returned shape {t.shape}, "
                    f"need ({K},)")
            if not np.all(np.isfinite(t)) or np.any(t <= 0):
                raise ValueError(
                    f"{type(self).__name__} produced non-finite or "
                    f"non-positive times at step {step}")
            return t

        return feed

    # -- shared building blocks ---------------------------------------------
    def _pick(self, K: int, n: int, seed: int, *path: int) -> np.ndarray:
        """``n`` distinct worker ids, keyed on ``(seed, *path)``.

        Drawn by ranking K uniforms rather than ``Generator.choice``:
        NumPy guarantees only the raw uniform bitstream across versions
        (NEP 19), and the golden traces depend on these picks never
        drifting on a numpy upgrade.
        """
        n = min(int(n), K)
        if n <= 0:
            return np.empty(0, dtype=np.int64)
        ranks = np.argsort(_rng(seed, *path).random(K), kind="stable")
        return np.sort(ranks[:n])

    def _shifted_exp(self, step: int, K: int, seed: int, base: np.ndarray,
                     jitter: np.ndarray) -> np.ndarray:
        """Stable per-step shifted-exponential draw around ``base``."""
        model = LatencyModel(base=base, straggler_slowdown=1.0, jitter=jitter)
        return model.sample(K, (), _rng(seed, 9, step), stable=True)


SCENARIOS: Dict[str, Type[Scenario]] = {}


def register(cls: Type[Scenario]) -> Type[Scenario]:
    """Class decorator: add ``cls`` to the catalog under ``cls.name``."""
    if cls.name in SCENARIOS:
        raise ValueError(f"duplicate scenario name {cls.name!r}")
    SCENARIOS[cls.name] = cls
    return cls


def scenario_names() -> Tuple[str, ...]:
    """The registered scenario names, sorted."""
    return tuple(sorted(SCENARIOS))


def make_scenario(name: str, **overrides) -> Scenario:
    """Instantiate the registered scenario ``name`` with field overrides.

    Raises:
        KeyError: for an unregistered name (the message lists the catalog).
    """
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; have {scenario_names()}")
    return SCENARIOS[name](**overrides)


def trace_matrix(scenario: Scenario, K: int, steps: int,
                 seed: int = 0) -> np.ndarray:
    """The (steps, K) finish-time matrix of a compiled scenario.

    The static side of the bench (no monitor: a step waits for everyone)
    and reproducibility tests both consume this dense form.
    """
    feed = scenario.compile(K, seed=seed)
    return np.stack([feed(s, None) for s in range(steps)])


@register
@dataclasses.dataclass(frozen=True)
class IIDShiftedExponential(Scenario):
    """The paper's Fig. 1 regime: a resampled straggler set computing twice.

    ``num_stragglers`` workers (resampled every ``resample_every`` steps)
    run at ``slowdown`` x base; everyone carries light exponential jitter.
    """

    name: ClassVar[str] = "iid"
    base: float = 1.0
    slowdown: float = 2.0
    jitter: float = 0.02
    num_stragglers: int = 3
    resample_every: int = 8

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Per-worker times with the epoch's straggler set slowed down."""
        epoch = step // self.resample_every if self.resample_every else 0
        slow = self._pick(K, self.num_stragglers, seed, 0, epoch)
        base = np.full(K, self.base)
        base[slow] *= self.slowdown
        return self._shifted_exp(step, K, seed, base, np.full(K, self.jitter))

    def calm(self) -> "IIDShiftedExponential":
        """No stragglers; the iid jitter floor remains."""
        return dataclasses.replace(self, num_stragglers=0)


@register
@dataclasses.dataclass(frozen=True)
class HeavyTailMixture(Scenario):
    """A FIXED slow set with a fat exponential tail (the mean-vs-tail regime).

    The slow machines run at ``slowdown`` x base with ``heavy_jitter``
    exponential scale; the rest are near-deterministic.  This is the mix
    where mean and quantile rankings genuinely disagree.
    """

    name: ClassVar[str] = "heavy_tail"
    base: float = 1.0
    slowdown: float = 2.0
    healthy_jitter: float = 0.05
    heavy_jitter: float = 1.5
    num_stragglers: int = 3

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Per-worker times; the seed-fixed slow set keeps its fat tail."""
        slow = self._pick(K, self.num_stragglers, seed, 0)
        base = np.full(K, self.base)
        jitter = np.full(K, self.healthy_jitter)
        base[slow] *= self.slowdown
        jitter[slow] = self.heavy_jitter
        return self._shifted_exp(step, K, seed, base, jitter)

    def calm(self) -> "HeavyTailMixture":
        """No heavy-tailed workers; healthy jitter only."""
        return dataclasses.replace(self, num_stragglers=0)


@register
@dataclasses.dataclass(frozen=True)
class ParetoTail(Scenario):
    """Pareto-tailed stragglers: the regime the shifted-exp fit gets WRONG.

    ``num_stragglers`` seed-fixed workers finish at ``xm * U^(-1/alpha)``
    (Pareto with minimum ``xm``; ``alpha <= 2`` has infinite variance), the
    rest at base + light exponential jitter.  The monitor's method-of-
    moments shifted-exponential fit systematically underestimates this
    tail, so PREDICTED quantiles look safe while REALIZED violations pile
    up — the scenario the observed-violation feedback controller
    (``control.feedback``) exists for.
    """

    name: ClassVar[str] = "pareto"
    base: float = 1.0
    healthy_jitter: float = 0.05
    num_stragglers: int = 2
    xm: float = 2.0
    alpha: float = 1.5

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Healthy shifted-exp times with Pareto draws on the slow set."""
        slow = self._pick(K, self.num_stragglers, seed, 0)
        base = np.full(K, self.base)
        t = self._shifted_exp(step, K, seed, base,
                              np.full(K, self.healthy_jitter))
        if slow.size:
            u = _rng(seed, 8, step).random(slow.size)
            t[slow] = self.xm * np.power(1.0 - u, -1.0 / self.alpha)
        return t

    def calm(self) -> "ParetoTail":
        """No Pareto workers; healthy jitter only."""
        return dataclasses.replace(self, num_stragglers=0)


@register
@dataclasses.dataclass(frozen=True)
class BurstySlowdown(Scenario):
    """Time-correlated bursts: a fraction of the cluster slows together.

    Every ``period`` steps a burst of ``burst_len`` steps begins; during a
    burst, a per-burst resampled fraction of workers runs at ``slowdown``
    x base with ``burst_jitter`` tails.  Between bursts the cluster is
    healthy, so score decay makes the monitor's picture go stale — the
    regime that punishes purely predictive control.
    """

    name: ClassVar[str] = "bursty"
    base: float = 1.0
    healthy_jitter: float = 0.05
    period: int = 12
    burst_len: int = 4
    fraction: float = 0.25
    slowdown: float = 3.0
    burst_jitter: float = 1.0

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Healthy times, except inside a burst window."""
        base = np.full(K, self.base)
        jitter = np.full(K, self.healthy_jitter)
        if self.burst_len > 0 and (step % self.period) < self.burst_len:
            burst = step // self.period
            slow = self._pick(K, int(round(self.fraction * K)), seed, 0, burst)
            base[slow] *= self.slowdown
            jitter[slow] = self.burst_jitter
        return self._shifted_exp(step, K, seed, base, jitter)

    def calm(self) -> "BurstySlowdown":
        """Bursts disabled entirely."""
        return dataclasses.replace(self, burst_len=0)


@register
@dataclasses.dataclass(frozen=True)
class FlappingWorkers(Scenario):
    """Workers that alternate slow/healthy on a phase-shifted duty cycle.

    Each of ``num_flappers`` seed-fixed workers is slow for
    ``duty * period`` of every ``period`` steps, with a per-worker phase
    offset — persistently intermittent rather than persistently slow, so
    decayed straggler scores hover around the flagging threshold.
    """

    name: ClassVar[str] = "flapping"
    base: float = 1.0
    healthy_jitter: float = 0.05
    num_flappers: int = 2
    period: int = 6
    duty: float = 0.5
    slowdown: float = 2.5
    flap_jitter: float = 0.5

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Per-worker times with each flapper's duty window applied."""
        flappers = self._pick(K, self.num_flappers, seed, 0)
        base = np.full(K, self.base)
        jitter = np.full(K, self.healthy_jitter)
        if flappers.size:
            # floor-of-uniform, not Generator.integers: only the uniform
            # bitstream is version-stable (see _pick)
            phases = np.floor(_rng(seed, 1).random(flappers.size)
                              * max(self.period, 1)).astype(np.int64)
            on = ((step + phases) % self.period) < self.duty * self.period
            slow = flappers[on]
            base[slow] *= self.slowdown
            jitter[slow] = self.flap_jitter
        return self._shifted_exp(step, K, seed, base, jitter)

    def calm(self) -> "FlappingWorkers":
        """No flappers."""
        return dataclasses.replace(self, num_flappers=0)


@register
@dataclasses.dataclass(frozen=True)
class CorrelatedRackFailure(Scenario):
    """A whole rack degrades at once (correlated, not independent, loss).

    Workers are striped round-robin over ``racks`` racks; at ``fail_step``
    one seed-chosen rack drops to ``slowdown`` x base with ``rack_jitter``
    tails, recovering at ``recover_step`` (never, when None).  The erasure
    budget must absorb ~K/racks simultaneous stragglers.
    """

    name: ClassVar[str] = "rack"
    base: float = 1.0
    healthy_jitter: float = 0.05
    racks: int = 4
    fail_step: Optional[int] = 6
    recover_step: Optional[int] = None
    slowdown: float = 3.0
    rack_jitter: float = 1.0

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Per-worker times; the failed rack is slow inside its window."""
        base = np.full(K, self.base)
        jitter = np.full(K, self.healthy_jitter)
        failed = (self.fail_step is not None and step >= self.fail_step
                  and (self.recover_step is None or step < self.recover_step))
        if failed:
            # floor-of-uniform for version stability (see _pick)
            rack = min(int(_rng(seed, 0).random() * self.racks),
                       self.racks - 1)
            members = np.flatnonzero(np.arange(K) % self.racks == rack)
            base[members] *= self.slowdown
            jitter[members] = self.rack_jitter
        return self._shifted_exp(step, K, seed, base, jitter)

    def calm(self) -> "CorrelatedRackFailure":
        """The rack never fails."""
        return dataclasses.replace(self, fail_step=None)


@register
@dataclasses.dataclass(frozen=True)
class PoolResize(Scenario):
    """Mid-run worker pool shrink/grow.

    ``num_departing`` workers leave at ``depart_step`` (their finish times
    jump to ``down_factor`` x base — machines nobody should wait for);
    ``num_arriving`` workers are absent (same ``down_factor``) until they
    join at ``join_step``.  The two sets are disjoint.  The feed always
    emits for the full universe of K workers; a fixed-pool server sees
    departure/arrival purely through the monitor's mask, while an ELASTIC
    ``AdaptiveServer`` (``universe=``) starts its pool without the
    arriving set (:meth:`arriving_ids`), executes the shrink handoff when
    the departures exhaust slack, and ``grow()``s onto Leja-extended
    points at ``join_step``.
    """

    name: ClassVar[str] = "pool_resize"
    base: float = 1.0
    healthy_jitter: float = 0.05
    num_departing: int = 2
    depart_step: Optional[int] = 8
    num_arriving: int = 2
    join_step: Optional[int] = 4
    down_factor: float = 25.0

    def member_sets(self, K: int, seed: int) -> tuple:
        """The seed-fixed (departing, arriving) universe id arrays.

        The same ranked-uniform pick :meth:`times` applies, exposed so an
        elastic driver can start its pool without the arriving workers
        and admit exactly them at ``join_step``.
        """
        both = self._pick(K, self.num_departing + self.num_arriving, seed, 0)
        return both[: self.num_departing], both[self.num_departing:]

    def departing_ids(self, K: int, seed: int) -> np.ndarray:
        """Universe ids that go slow at ``depart_step``."""
        return self.member_sets(K, seed)[0]

    def arriving_ids(self, K: int, seed: int) -> np.ndarray:
        """Universe ids absent until ``join_step``."""
        return self.member_sets(K, seed)[1]

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Per-worker times with departures/arrivals applied at ``step``."""
        departing, arriving = self.member_sets(K, seed)
        base = np.full(K, self.base)
        if self.depart_step is not None and step >= self.depart_step:
            base[departing] *= self.down_factor
        if self.join_step is not None and step < self.join_step:
            base[arriving] *= self.down_factor
        return self._shifted_exp(step, K, seed, base,
                                 np.full(K, self.healthy_jitter))

    def calm(self) -> "PoolResize":
        """Nobody leaves, everybody already joined."""
        return dataclasses.replace(self, num_departing=0, num_arriving=0,
                                   join_step=None)


@register
@dataclasses.dataclass(frozen=True)
class Crawler(Scenario):
    """Persistently slow workers that never die — partial decoding's regime.

    ``num_crawlers`` seed-fixed workers run at a steady ``crawl_factor`` x
    base with mild ``crawl_jitter`` tails: slow enough that waiting for
    them dominates a step, but reliably PRODUCTIVE — each still completes
    a useful fraction of its block in the time the healthy pool finishes.
    Binary erasure throws that fraction away (and with more crawlers than
    the rung's budget, cannot mask them all); partial-straggler
    sub-tasking (``sub_tasks > 1``) consumes their chunk prefixes instead.
    """

    name: ClassVar[str] = "crawler"
    base: float = 1.0
    healthy_jitter: float = 0.05
    num_crawlers: int = 4
    crawl_factor: float = 1.8
    crawl_jitter: float = 0.15

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Per-worker times; the seed-fixed crawler set stays slow forever."""
        crawlers = self._pick(K, self.num_crawlers, seed, 0)
        base = np.full(K, self.base)
        jitter = np.full(K, self.healthy_jitter)
        base[crawlers] *= self.crawl_factor
        jitter[crawlers] = self.crawl_jitter
        return self._shifted_exp(step, K, seed, base, jitter)

    def calm(self) -> "Crawler":
        """No crawlers; healthy jitter only."""
        return dataclasses.replace(self, num_crawlers=0)


@register
@dataclasses.dataclass(frozen=True)
class Degrading(Scenario):
    """Workers that slow down progressively but keep producing.

    ``num_degrading`` seed-fixed workers run at
    ``min(1 + rate * step, max_factor)`` x base — a thermal-throttling /
    leaking-neighbour ramp.  Early on they are indistinguishable from
    healthy; by the time the monitor flags them they are far too slow to
    wait for yet still finish a useful prefix per step, so erasing them
    outright discards real work every step for the rest of the run.
    """

    name: ClassVar[str] = "degrading"
    base: float = 1.0
    healthy_jitter: float = 0.05
    num_degrading: int = 3
    rate: float = 0.08
    max_factor: float = 3.0
    degrade_jitter: float = 0.2

    def times(self, step: int, K: int, seed: int) -> np.ndarray:
        """Per-worker times with the ramped slowdown applied at ``step``."""
        degrading = self._pick(K, self.num_degrading, seed, 0)
        base = np.full(K, self.base)
        jitter = np.full(K, self.healthy_jitter)
        factor = min(1.0 + self.rate * step, self.max_factor)
        base[degrading] *= factor
        jitter[degrading] = self.degrade_jitter
        return self._shifted_exp(step, K, seed, base, jitter)

    def calm(self) -> "Degrading":
        """Nobody degrades; healthy jitter only."""
        return dataclasses.replace(self, num_degrading=0)
