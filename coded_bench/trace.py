"""Trace part of the window with ``torch.profiler`` and reduce the trace to
device busy time, device time by operation and by stage of the program,
and the idle gaps by what the host was doing.

The traced part starts and ends between two requests (``Tracer``), so it
holds whole requests only: a ``bench.window`` range around it and a
``bench.request`` range around each.  Entries mark calls into the
program's layers (``span_method``); a range named ``stage.<name>`` also
claims the device work launched inside it, found through the profiler's
correlation of each kernel with the host operation that launched it.  Each
stretch of an idle gap goes to the innermost host range or operation that
covers it, or to ``host python`` where no recorded range does.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
REQUEST = "bench.request"
STAGE = "stage."
_OUTER = (WINDOW, REQUEST)
SPAN = (0.4, 0.6)   # the traced part of the window, as shares of it


def profiler(device):
    """A profiler of the host and, on a card, its device activity."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class Tracer:
    """Profiles the part ``SPAN`` of a window of ``seconds``, starting and
    stopping only where the loop says it is between requests."""

    def __init__(self, on: bool, device, seconds: float):
        self.on, self.device, self.seconds = on, device, seconds
        self.prof = self.range = self.result = None
        self.finished = False

    def between(self, elapsed: float, last: bool = False) -> None:
        """Called between requests with the seconds of window gone."""
        if not self.on or self.finished:
            return
        if self.prof is None and not last and elapsed >= SPAN[0] * self.seconds:
            self.prof = profiler(self.device)
            self.prof.__enter__()
            self.range = record_function(WINDOW)
            self.range.__enter__()
        elif self.prof is not None and (last or elapsed >= SPAN[1] * self.seconds):
            self.range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.result, self.prof, self.finished = reduce(self.prof), None, True

    def request(self):
        """The range around one request while the profiler runs."""
        return record_function(REQUEST) if self.prof is not None \
            else contextlib.nullcontext()


def span_method(obj, attr: str, name: str) -> None:
    """Wrap ``obj.attr`` (a bound method) in a profiler range ``name``."""
    inner = getattr(obj, attr)

    @functools.wraps(inner)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return inner(*args, **kwargs)

    setattr(obj, attr, wrapped)


def _annotation(e) -> bool:
    """True for a range the host marked, which the profiler mirrors on the
    device's timeline: it is no device work."""
    for attr in ("is_user_annotation", "activity_type"):
        try:
            value = getattr(e, attr)()
        except (AttributeError, RuntimeError):
            continue
        if value is True or "annotation" in str(value).lower():
            return True
    return False


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    if cut > 0 and name[cut - 1] != " ":
        name = name[:cut]
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _corr(e, attr: str) -> int:
    try:
        return int(getattr(e, attr)())
    except (AttributeError, RuntimeError, TypeError, ValueError):
        return 0


def _launch_call(name: str) -> bool:
    """True for a host call of the CUDA runtime or driver (a launch, a copy,
    a set): the device operation it starts carries its correlation id."""
    return name.startswith("cu") and name[2:3].isalpha()


def _stage_of(t, stages) -> str | None:
    """The innermost ``stage.*`` range (start, end, name) covering time t."""
    covering = [(b - a, n) for a, b, n in stages if a <= t <= b]
    return min(covering)[1] if covering else None


def reduce(prof, top: int = 10) -> dict:
    """``{busy_s, window_s, device_s, requests, stages, device_ops,
    idle_gaps}`` of the ``bench.window`` range of a finished profile:
    ``device_s`` sums the device operations' times, ``stages`` those
    launched inside each ``stage.*`` range, ``requests`` counts the
    ``bench.request`` ranges (``busy_s`` 0 when no device work was
    recorded)."""
    events = prof.profiler.kineto_results.events()
    host, device, launched = [], [], {}
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                device.append((a, a + d, short_name(e.name()),
                               _corr(e, "correlation_id")))
        elif e.device_type() == DeviceType.CPU:
            host.append((a, a + d, e.name()))
            if _launch_call(e.name()):
                launched[_corr(e, "correlation_id")] = a
    win = [(a, b) for a, b, name in host if name == WINDOW]
    if not win:
        raise RuntimeError(f"the profile holds no {WINDOW!r} range")
    w0, w1 = win[0]
    # a device operation was launched when the runtime call of its
    # correlation id ran
    clipped = [(max(a, w0), min(b, w1), n, launched.get(c))
               for a, b, n, c in device if b > w0 and a < w1]
    busy = _merge((a, b) for a, b, _, _ in clipped)
    by_op, by_stage = defaultdict(int), defaultdict(int)
    stages = [(a, b, n) for a, b, n in host if n.startswith(STAGE)]
    for a, b, n, launch in clipped:
        by_op[n] += b - a
        stage = _stage_of(launch, stages) if launch is not None else None
        if stage is not None:
            by_stage[stage] += b - a
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    inner = sorted((a, b, n) for a, b, n in host
                   if n not in _OUTER and b > w0 and a < w1)
    starts = [a for a, _, _ in inner]
    longest = max((b - a for a, b, _ in inner), default=0)
    by_host = defaultdict(int)
    for a, b in gaps:
        lo = bisect.bisect_left(starts, a - longest)
        hi = bisect.bisect_left(starts, b)
        cands = [(s, e, n) for s, e, n in inner[lo:hi] if e > a]
        cuts = sorted({a, b, *(max(s, a) for s, _, _ in cands),
                       *(min(e, b) for _, e, _ in cands)})
        for x, y in zip(cuts, cuts[1:]):
            covering = [(e - s, n) for s, e, n in cands if s <= x and e >= y]
            by_host[min(covering)[1] if covering else "host python"] += y - x
    ranked = lambda d: [[n, v / 1e9] for n, v in  # noqa: E731
                        sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "device_s": sum(by_op.values()) / 1e9,
            "requests": sum(1 for a, b, n in host
                            if n == REQUEST and a >= w0 and b <= w1),
            "stages": {n: v / 1e9 for n, v in by_stage.items()},
            "device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
