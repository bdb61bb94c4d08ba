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
* ``recorder.defer("kernel.decode", start, stop, device)`` — for a CUDA
  launch bracketed by two timing events: the span stays pending, with its
  parent taken at launch, until its stop event has completed.  Pending
  spans are resolved as later spans are deferred (``Event.query``, which
  never waits) and, at the latest, when the recorder is read
  (:attr:`SpanRecorder.spans`, :meth:`SpanRecorder.by_name`): only a read
  waits for the card.

While a ``torch.profiler`` is recording, a context-manager span (and
``obs.span`` with collection off) also enters a profiler range of its name
(``profiler_range``), so the program's spans nest on the profiler's trace,
on the device trace's clock.

Span IDs are deterministic: the recorder numbers spans in creation
order, and :func:`span_id_for` derives stable seed-keyed IDs for records
that must survive replay byte-identically (serve traces, chaos traces).
"""
from __future__ import annotations

import collections
import hashlib
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.clock import MONOTONIC, Clock

__all__ = ["Span", "SpanRecorder", "span_id_for", "profiling", "profiler_range"]

# torch's "is a profiler recording" flag, bound once torch is imported: a
# process that never imports torch (the serve simulator) never pays for it.
_profiler_enabled = None


def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording in this process (False,
    without importing torch, while nothing has imported it)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


def profiler_range(name: str):
    """A profiler range called ``name``: the user-scope range that
    ``torch.profiler.record_function`` records, through torch's C++ fast
    path (a tenth of ``record_function``'s host time under a profiler)."""
    return sys.modules["torch"]._C._profiler._RecordFunctionFast(name)


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
                 "start_s", "_parent", "_range")

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
        self._range = None

    def __enter__(self) -> "_OpenSpan":
        self.sid, self._parent, self.start_s = self._rec._open(self)
        if profiling():
            self._range = profiler_range(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
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


@dataclass
class _Deferred:
    """A span timed by CUDA events whose stop event may not have run yet."""

    sid: int
    name: str
    parent: Optional[int]
    track: str
    lane: str
    attrs: Dict[str, str]
    start: object            # torch.cuda.Event pair around the launch
    stop: object
    launch_s: float          # the session clock at launch
    anchor: Optional[tuple]  # (event, host seconds) on the device's clock


class SpanRecorder:
    """Collects closed :class:`Span`\\ s and tracks the nesting stack.

    The stack is thread-local (each thread nests independently) but the
    closed-span list and the ID counter are shared, guarded by a lock —
    IDs are unique process-wide and reflect creation order.
    """

    def __init__(self, clock: Clock = MONOTONIC):
        self.clock: Clock = clock
        self._spans: List[Span] = []
        self._pending: collections.deque = collections.deque()
        self._anchors: Dict[object, tuple] = {}
        self._lock = threading.Lock()
        self._resolving = threading.Lock()
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
            self._spans.append(span)

    def _resolve(self, wait: bool) -> None:
        """Close the deferred spans whose events have run, in launch order;
        with ``wait``, wait for every one.  The card is waited for outside
        the recorder's lock, so other threads' spans never queue behind a
        read; one resolution runs at a time, and a launch's finds nothing
        to do while another runs."""
        if not self._resolving.acquire(blocking=wait):
            return
        try:
            with self._lock:
                done = []
                while self._pending and (wait or self._pending[0].stop.query()):
                    done.append(self._pending.popleft())
            closed = []
            for p in done:
                if wait:
                    p.stop.synchronize()
                duration = p.start.elapsed_time(p.stop) / 1e3
                if p.anchor is None:
                    start = p.launch_s
                else:
                    event, host_s = p.anchor
                    start = host_s + event.elapsed_time(p.start) / 1e3
                closed.append(Span(
                    sid=p.sid, name=p.name, start_s=start,
                    end_s=start + duration, parent=p.parent, track=p.track,
                    lane=p.lane, attrs=p.attrs))
            with self._lock:
                self._spans.extend(closed)
        finally:
            self._resolving.release()

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
            self._spans.append(span)
        return span

    def anchor(self, device) -> tuple:
        """``(event, host seconds)``: a timing event of ``device`` and the
        monotonic clock when the card ran it, made once per device (the
        one synchronize a recorder makes outside a read).  It places the
        deferred spans of ``device`` on the host's clock."""
        anchor = self._anchors.get(device)
        if anchor is None:
            import torch

            torch.cuda.synchronize(device)
            event = torch.cuda.Event(enable_timing=True)
            host_s = MONOTONIC()
            event.record(torch.cuda.current_stream(device))
            event.synchronize()
            anchor = self._anchors[device] = (event, host_s)
        return anchor

    def defer(self, name: str, start, stop, device, track: str = "main",
              lane: str = "main", **attrs) -> None:
        """Record the span of a launch that ``start`` and ``stop`` (CUDA
        timing events, both recorded) bracket on ``device``, without
        waiting for it.

        The span is parented to the innermost open span and closed once
        ``stop`` has run.  Under the monotonic clock it lies where the card
        ran the launch (placed from the device's :meth:`anchor`); under any
        other clock (a simulated ``SettableClock``) it starts at the
        session clock at launch and lasts the events' device time.
        """
        if self._pending:
            self._resolve(wait=False)
        stack = self._stack()
        parent = stack[-1] if stack else None
        anchor = self.anchor(device) if self.clock is MONOTONIC else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self._pending.append(_Deferred(
                sid, name, parent, track, lane,
                {k: str(v) for k, v in attrs.items()}, start, stop,
                self.clock(), anchor))

    @property
    def spans(self) -> List[Span]:
        """Every closed span; those deferred before the read are waited for
        and closed first."""
        if self._pending:
            self._resolve(wait=True)
        return self._spans

    def by_name(self, name: str) -> List[Span]:
        """All closed spans with ``name``, in the order they closed."""
        return [s for s in self.spans if s.name == name]
