"""Injectable time sources for the observability layer.

Spans stamp ``(start, end)`` from whatever clock their session carries.
The default is the process monotonic clock (``time.perf_counter``), which
is right for real runs; simulated-clock runs (the serve tier, chaos
replays) install a :class:`SettableClock` instead and advance it to the
loop's own simulated ``now`` — every context-manager span then stamps
SIMULATED seconds, so two runs of the same (spec, scenario, seed) recipe
produce byte-identical span streams.
"""
from __future__ import annotations

import time
from typing import Callable

__all__ = ["Clock", "MONOTONIC", "SettableClock"]

#: A clock is any zero-argument callable returning seconds as a float.
Clock = Callable[[], float]

#: The default real-time source: monotonic, sub-microsecond, never steps.
MONOTONIC: Clock = time.perf_counter


class SettableClock:
    """A manually-advanced clock for deterministic simulated-time runs.

    Calling the instance reads the current time; :meth:`set` moves it.
    Time never goes backwards — ``set`` clamps to the maximum seen, so a
    loop that interleaves out-of-order bookkeeping cannot produce spans
    that end before they start.
    """

    def __init__(self, start_s: float = 0.0):
        self._t = float(start_s)

    def __call__(self) -> float:
        """The current simulated time in seconds."""
        return self._t

    def set(self, t_s: float) -> float:
        """Advance to ``t_s`` (monotone: never moves backwards)."""
        self._t = max(self._t, float(t_s))
        return self._t
