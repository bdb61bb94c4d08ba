"""``repro_torch.obs`` — spans, metrics, and exporters for the coded stack.

One process-wide :class:`ObsSession` holds a metrics registry, a span
recorder, and an injectable clock.  Instrumented call sites use the
module-level conveniences (:func:`count`, :func:`observe`, :func:`span`,
:func:`emit_span`) which are near-free no-ops until :func:`enable` is
called — the disabled fast path is one global ``None`` check, so the
instrumented code paths return bit-identical results with observability
off.

Enable programmatically::

    from repro_torch import obs
    obs.enable(fresh=True)
    with obs.span("my.region", kind="demo"):
        ...
    obs.session().registry.total("runtime.executable.compile")

or via the environment: ``REPRO_OBS=1`` enables collection at import
time (to run the ordinary test suite instrumented).

Whenever a ``torch.profiler`` is recording, :func:`span` also opens a
profiler range of the span's name, collection on or off, so
the program's spans nest on the profiler's trace beside the device work
they launch.  With neither on, :func:`span` costs the ``None`` check and
the profiler's flag.  ``torch`` is never imported here: a process that
has not imported it has no profiler to ask.
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from repro_torch.obs.clock import MONOTONIC, Clock, SettableClock
from repro_torch.obs.metrics import DEFAULT_BUCKETS, MetricsRegistry
from repro_torch.obs.spans import (NULL_SPAN, Span, SpanRecorder, profiler_range,
                                   profiling, span_id_for)

__all__ = [
    "ObsSession", "SettableClock", "Span", "SpanRecorder",
    "MetricsRegistry", "DEFAULT_BUCKETS", "span_id_for",
    "enable", "disable", "enabled", "session",
    "count", "gauge", "observe", "span", "emit_span", "use_clock",
]


class ObsSession:
    """One collection session: registry + span recorder + clock.

    A session on the monotonic clock in a process whose CUDA is already
    initialized anchors the current card's clock at once (one synchronize),
    so kernel spans deferred later never wait at launch.
    """

    def __init__(self, clock: Clock = MONOTONIC):
        self.registry = MetricsRegistry()
        self.recorder = SpanRecorder(clock)
        torch = sys.modules.get("torch")
        if clock is MONOTONIC and torch is not None and torch.cuda.is_initialized():
            self.recorder.anchor(torch.device("cuda", torch.cuda.current_device()))

    @property
    def clock(self) -> Clock:
        """The session's time source (spans stamp from it)."""
        return self.recorder.clock

    @clock.setter
    def clock(self, clock: Clock) -> None:
        """Swap the time source (e.g. a simulated ``SettableClock``)."""
        self.recorder.clock = clock


_session: Optional[ObsSession] = None


def enable(fresh: bool = False, clock: Clock = MONOTONIC) -> ObsSession:
    """Turn collection on, returning the active session.

    ``fresh=True`` discards any previous session (tests and benches use
    this to start from zeroed counters); otherwise an existing session
    keeps accumulating.
    """
    global _session
    if fresh or _session is None:
        _session = ObsSession(clock)
    return _session


def disable() -> None:
    """Turn collection off (instrumented sites become no-ops again)."""
    global _session
    _session = None


def enabled() -> bool:
    """Whether a collection session is active."""
    return _session is not None


def session() -> ObsSession:
    """The active session (raises if observability is disabled)."""
    if _session is None:
        raise RuntimeError(
            "observability is disabled — call repro_torch.obs.enable() first")
    return _session


# -- instrumentation-site conveniences (no-ops while disabled) ---------------

def count(name: str, n: float = 1.0, **labels) -> None:
    """Increment counter ``name`` by ``n`` (no-op while disabled)."""
    if _session is not None:
        _session.registry.counter(name, **labels).inc(n)


def gauge(name: str, value: float, **labels) -> None:
    """Set gauge ``name`` (no-op while disabled)."""
    if _session is not None:
        _session.registry.gauge(name, **labels).set(value)


def observe(name: str, value: float,
            buckets: Optional[Sequence[float]] = None, **labels) -> None:
    """Record ``value`` into histogram ``name`` (no-op while disabled)."""
    if _session is not None:
        _session.registry.histogram(name, buckets=buckets,
                                    **labels).observe(value)


def span(name: str, track: str = "main", lane: str = "main", **attrs):
    """A context manager timing ``name`` (shared no-op while disabled),
    mirrored as a profiler range while a ``torch.profiler`` records."""
    if _session is None:
        return profiler_range(name) if profiling() else NULL_SPAN
    return _session.recorder.span(name, track=track, lane=lane, **attrs)


def emit_span(name: str, start_s: float, end_s: float, track: str = "main",
              lane: str = "main", **attrs) -> Optional[Span]:
    """Record a pre-timed span (no-op while disabled, returning None)."""
    if _session is None:
        return None
    return _session.recorder.emit(name, start_s, end_s, track=track,
                                  lane=lane, **attrs)


def use_clock(clock: Clock) -> None:
    """Point the active session's clock at ``clock`` (no-op if disabled).

    The serve tier calls this with its :class:`SettableClock` so every
    span recorded during the run stamps simulated seconds.
    """
    if _session is not None:
        _session.clock = clock


if os.environ.get("REPRO_OBS", "").strip() not in ("", "0"):
    enable()
