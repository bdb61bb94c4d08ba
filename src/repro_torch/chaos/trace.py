"""Record and bit-deterministically replay adaptive serving runs.

A trace is a JSONL file: one header line, then one line per serving step
carrying BOTH sides of the control loop — the (K,) per-worker finish
times the feed produced AND the deterministic fields of the resulting
``StepReport`` (rung choice, mask, fractional progress plan, modelled
latency, predicted/realized tails, feedback quantile and threshold;
everything except wall-clock noise).  Python's
``json`` serialises floats at shortest round-trip precision, so float64
values survive the file boundary bit-exactly.

Usage — record::

    recorder = TraceRecorder(scenario.compile(K, seed=7), K,
                             meta={"scenario": "bursty", "seed": 7})
    server = AdaptiveServer(ladder, feed=recorder, ...)
    reports = server.run(steps, make_request)
    trace = recorder.finish(reports)
    trace.save("run.jsonl")

and replay::

    trace = Trace.load("run.jsonl")
    server2 = AdaptiveServer(ladder2, feed=trace.feed(), ...)  # same config
    reports2 = server2.run(len(trace.steps), make_request)
    assert trace.diff(reports2) == []

Replaying feeds the RECORDED times back through a freshly constructed,
identically configured server; because every control decision is a pure
function of the time stream (monitor EWMAs, closed-form quantiles, seeded
policy sampling), the rung choices, masks, and tails must reproduce
exactly — ``diff`` returns the field-level mismatches (empty = identical)
and ``verify_replay`` raises on any.  Golden traces under ``tests/golden/``
pin this contract in CI (regenerate via ``scripts/regen_golden_traces.py``).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.chaos.serialize import (report_field_names, report_to_dict,
                                   tuplify)
from repro_torch.core.simulator import TimeFeed

if TYPE_CHECKING:  # StepReport lives in control/, which imports torch;
    # keep repro_torch.chaos's trace handling free of it at run time —
    # scenarios + trace handling are pure host-side numpy.
    from repro_torch.control.driver import StepReport

__all__ = ["TRACE_VERSION", "TraceStep", "Trace", "TraceRecorder",
           "verify_replay"]

TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TraceStep:
    """One recorded serving step: the feed's times + the report's decisions."""

    step: int
    times: Tuple[float, ...]
    rung: str
    switched: bool
    erased: Tuple[int, ...]
    sim_latency_s: float
    slack: int
    respecialize: bool
    shrink_target: Optional[Tuple[int, int]]
    exact: Optional[bool]
    slo_violation: bool
    predicted_tail_s: Optional[float]
    realized_s: Optional[float]
    realized_violation: bool
    q_effective: Optional[float]
    #: fractional per-worker progress plan (partial serving; None when Q=1).
    progress: Optional[Tuple[float, ...]] = None
    #: feedback-adjusted flagging threshold (None without feedback).
    threshold_effective: Optional[float] = None
    #: seed-derived obs correlation ID (span_id_for(seed, scope, step)).
    span_id: Optional[str] = None
    #: universe ids serving the step (elastic pool; None on fixed pools).
    pool: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_report(cls, report: StepReport,
                    times: np.ndarray) -> "TraceStep":
        """Pair a ``StepReport`` with the times that produced it.

        Field selection goes through the shared
        :func:`repro_torch.chaos.serialize.report_to_dict` (everything except
        wall-clock noise), so a field added to ``StepReport`` must be
        added HERE too — the resulting ``TypeError`` on the next recorded
        trace is the reminder that the trace schema (and
        ``COMPARED_FIELDS``) needs an intentional update.
        """
        rec = report_to_dict(report)
        rec["times"] = [float(t) for t in np.asarray(times)]
        return cls(**{k: tuplify(v) if isinstance(v, list) else v
                      for k, v in rec.items()})


#: StepReport fields a replay must reproduce bit-exactly — every
#: TraceStep field except the key (``step``) and the feed input
#: (``times``).  Derived from the schema itself (via the shared
#: ``report_field_names``), so a field added to StepReport + TraceStep is
#: automatically compared; forgetting the TraceStep half still fails
#: loudly in ``from_report``.
COMPARED_FIELDS = report_field_names(TraceStep, volatile=("step", "times"))


@dataclasses.dataclass(frozen=True)
class Trace:
    """A recorded run: K workers, free-form metadata, per-step records."""

    K: int
    meta: dict
    steps: Tuple[TraceStep, ...]

    def feed(self) -> TimeFeed:
        """A ``TimeFeed`` replaying the recorded per-worker times verbatim.

        Raises:
            IndexError: when asked for a step beyond the recording.
        """
        by_step = {s.step: np.asarray(s.times, dtype=np.float64)
                   for s in self.steps}

        def replay_feed(step: int, rng=None) -> np.ndarray:
            if step not in by_step:
                raise IndexError(
                    f"trace has no step {step} (recorded: {len(self.steps)})")
            return by_step[step].copy()

        return replay_feed

    def diff(self, reports: Sequence[StepReport]) -> List[str]:
        """Field-level mismatches between this trace and ``reports``.

        Every compared field must match EXACTLY (floats included — that is
        the bit-determinism contract).  Returns human-readable mismatch
        strings; an empty list means the replay reproduced the run.
        """
        out: List[str] = []
        if len(reports) != len(self.steps):
            out.append(f"step count: trace {len(self.steps)} vs "
                       f"replay {len(reports)}")
        for rec, rep in zip(self.steps, reports):
            got = TraceStep.from_report(rep, rec.times)
            for field in COMPARED_FIELDS:
                want, have = getattr(rec, field), getattr(got, field)
                if want != have:
                    out.append(f"step {rec.step} {field}: "
                               f"trace {want!r} vs replay {have!r}")
        return out

    # -- persistence ---------------------------------------------------------
    def save(self, path) -> Path:
        """Write the trace as JSONL (header line + one line per step)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [json.dumps({"kind": "header", "version": TRACE_VERSION,
                             "K": self.K, "steps": len(self.steps),
                             "meta": self.meta}, sort_keys=True)]
        for s in self.steps:
            rec = dataclasses.asdict(s)
            rec = {"kind": "step", **{k: list(v) if isinstance(v, tuple)
                                      else v for k, v in rec.items()}}
            lines.append(json.dumps(rec, sort_keys=True))
        path.write_text("\n".join(lines) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "Trace":
        """Read a trace written by :meth:`save`.

        Raises:
            ValueError: on a missing/foreign header or version mismatch.
        """
        lines = Path(path).read_text().splitlines()
        if not lines:
            raise ValueError(f"{path}: empty trace file")
        header = json.loads(lines[0])
        if header.get("kind") != "header":
            raise ValueError(f"{path}: first line is not a trace header")
        if header.get("version") != TRACE_VERSION:
            raise ValueError(f"{path}: trace version {header.get('version')} "
                             f"!= supported {TRACE_VERSION}")
        steps = []
        for line in lines[1:]:
            rec = json.loads(line)
            if rec.pop("kind", None) != "step":
                raise ValueError(f"{path}: non-step record after header")
            rec["times"] = tuple(rec["times"])
            rec["erased"] = tuple(rec["erased"])
            if rec["shrink_target"] is not None:
                rec["shrink_target"] = tuple(rec["shrink_target"])
            if rec.get("progress") is not None:
                rec["progress"] = tuple(rec["progress"])
            if rec.get("pool") is not None:
                rec["pool"] = tuple(rec["pool"])
            steps.append(TraceStep(**rec))
        return cls(K=int(header["K"]), meta=dict(header.get("meta", {})),
                   steps=tuple(steps))


class TraceRecorder:
    """A pass-through ``TimeFeed`` that records what it emitted.

    Wrap the real feed, hand the recorder to ``AdaptiveServer(feed=...)``,
    run, then :meth:`finish` with the server's reports to obtain the
    :class:`Trace`.

    Args:
        feed: the underlying per-worker time source.
        K: worker count (recorded in the header; feeds are (K,)-shaped).
        meta: free-form provenance (scenario name/params, seed, ...).
    """

    def __init__(self, feed: TimeFeed, K: int, meta: Optional[dict] = None):
        self._feed = feed
        self.K = K
        self.meta = dict(meta or {})
        self._times: dict = {}

    def __call__(self, step: int, rng=None) -> np.ndarray:
        """Delegate to the wrapped feed, keeping a copy of the times."""
        t = np.asarray(self._feed(step, rng), dtype=np.float64)
        self._times[int(step)] = t.copy()
        return t

    def finish(self, reports: Sequence[StepReport]) -> Trace:
        """Pair the recorded times with the run's reports into a Trace.

        Raises:
            ValueError: if a report's step has no recorded times (the
                recorder was not the feed that served the run).
        """
        steps = []
        for rep in reports:
            if rep.step not in self._times:
                raise ValueError(f"no recorded times for step {rep.step}; "
                                 f"was this recorder the server's feed?")
            steps.append(TraceStep.from_report(rep, self._times[rep.step]))
        return Trace(K=self.K, meta=self.meta, steps=tuple(steps))


def verify_replay(trace: Trace, reports: Sequence[StepReport]) -> None:
    """Assert ``reports`` reproduce ``trace`` exactly.

    Raises:
        AssertionError: listing every mismatching field.
    """
    mismatches = trace.diff(reports)
    if mismatches:
        raise AssertionError(
            "replay diverged from trace:\n  " + "\n  ".join(mismatches))
