"""Hierarchical spans: timed, nested regions of work.

A span is one ``(name, start_s, end_s)`` interval with a parent pointer,
an optional ``track``/``lane`` placement (Perfetto rows: one *track* per
SLO class, one *lane* per pipeline stage), and free-form string attrs.
Two ways to produce one:

* ``with recorder.span("runtime.executable.build", kind="matmul"):`` —
  the context manager stamps start/end from the session clock and
  maintains the nesting stack (exception-safe: the span is closed and
  marked ``ok=False`` if the body raises).
* ``recorder.emit("serve.worker_stage", start_s, end_s, ...)`` — for
  pre-timed intervals, e.g. the serve tier's simulated pipeline stages
  whose start/end come from the schedule, not from wall time.

Span IDs are deterministic: the recorder numbers spans in creation
order, and :func:`span_id_for` derives stable seed-keyed IDs for records
that must survive replay byte-identically (serve traces, chaos traces).
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.clock import MONOTONIC, Clock

__all__ = ["Span", "SpanRecorder", "span_id_for"]


def span_id_for(seed: int, kind: str, index: int) -> str:
    """A stable 16-hex-char span ID derived from ``(seed, kind, index)``.

    This is the correlation key stamped into serve/chaos trace records:
    it depends only on the run recipe (the seed), the record kind (e.g.
    ``"step.premium"``), and the record's ordinal — never on wall time —
    so a replayed trace reproduces the IDs byte-identically.
    """
    payload = f"{int(seed)}:{kind}:{int(index)}".encode()
    return hashlib.blake2b(payload, digest_size=8).hexdigest()


@dataclass
class Span:
    """One closed interval of work on the span timeline."""

    sid: int
    name: str
    start_s: float
    end_s: float
    parent: Optional[int] = None
    track: str = "main"
    lane: str = "main"
    attrs: Dict[str, str] = field(default_factory=dict)
    ok: bool = True

    @property
    def duration_s(self) -> float:
        """Span length in seconds."""
        return self.end_s - self.start_s


class _OpenSpan:
    """Context manager for an in-progress span (returned by ``span()``)."""

    __slots__ = ("_rec", "name", "track", "lane", "attrs", "sid",
                 "start_s", "_parent")

    def __init__(self, rec: "SpanRecorder", name: str, track: str,
                 lane: str, attrs: Dict[str, str]):
        self._rec = rec
        self.name = name
        self.track = track
        self.lane = lane
        self.attrs = attrs
        self.sid = -1
        self.start_s = 0.0
        self._parent: Optional[int] = None

    def __enter__(self) -> "_OpenSpan":
        self.sid, self._parent, self.start_s = self._rec._open(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rec._close(self, ok=exc_type is None)
        return False  # never swallow the exception


class _NullSpan:
    """The do-nothing span handed out when observability is disabled."""

    __slots__ = ()
    sid = -1
    attrs: Dict[str, str] = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


#: Shared no-op context manager — allocation-free on the disabled path.
NULL_SPAN = _NullSpan()


class SpanRecorder:
    """Collects closed :class:`Span`\\ s and tracks the nesting stack.

    The stack is thread-local (each thread nests independently) but the
    closed-span list and the ID counter are shared, guarded by a lock —
    IDs are unique process-wide and reflect creation order.
    """

    def __init__(self, clock: Clock = MONOTONIC):
        self.clock: Clock = clock
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._next_sid = 0
        self._local = threading.local()

    # -- internals -----------------------------------------------------------
    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, open_span: _OpenSpan) -> Tuple[int, Optional[int], float]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        stack.append(sid)
        return sid, parent, self.clock()

    def _close(self, open_span: _OpenSpan, ok: bool) -> None:
        stack = self._stack()
        # Exception-safety: unwind past any child left open by a raise.
        while stack and stack[-1] != open_span.sid:
            stack.pop()
        if stack:
            stack.pop()
        span = Span(sid=open_span.sid, name=open_span.name,
                    start_s=open_span.start_s, end_s=self.clock(),
                    parent=open_span._parent, track=open_span.track,
                    lane=open_span.lane, attrs=open_span.attrs, ok=ok)
        with self._lock:
            self.spans.append(span)

    # -- public API ----------------------------------------------------------
    def span(self, name: str, track: str = "main", lane: str = "main",
             **attrs) -> _OpenSpan:
        """Open a clock-timed span as a context manager."""
        return _OpenSpan(self, name, track, lane,
                         {k: str(v) for k, v in attrs.items()})

    def emit(self, name: str, start_s: float, end_s: float,
             track: str = "main", lane: str = "main",
             **attrs) -> Span:
        """Record a pre-timed span (simulated schedules, replayed traces).

        The interval is taken verbatim — the session clock is not read —
        and the span is parented to the innermost open span, if any.
        """
        stack = self._stack()
        parent = stack[-1] if stack else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        span = Span(sid=sid, name=name, start_s=float(start_s),
                    end_s=float(end_s), parent=parent, track=track,
                    lane=lane, attrs={k: str(v) for k, v in attrs.items()})
        with self._lock:
            self.spans.append(span)
        return span

    def by_name(self, name: str) -> List[Span]:
        """All closed spans with ``name``, in creation order."""
        return [s for s in self.spans if s.name == name]
