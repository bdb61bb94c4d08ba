"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Metric names are dotted lowercase paths (``runtime.executable.compile``,
``serve.shed``); labels are keyword arguments at the call site
(``count("serve.shed", reason="rate_limited")``).  Each distinct
``(name, labels)`` pair owns one instrument, created on first touch, so
instrumentation sites never pre-register anything.

Histograms use FIXED bucket edges chosen at first touch (default:
latency-shaped seconds).  Fixed edges are what make dumps comparable
across runs — two runs of the same recipe produce the same bucket rows,
so a regression shows up as a count shift, not a re-binned axis.

``to_prometheus`` renders the whole registry in the Prometheus text
exposition format (dots become underscores; histograms emit cumulative
``_bucket{le=...}`` rows plus ``_sum``/``_count``).
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "prom_name"]

#: Default histogram edges (seconds): spans sub-millisecond kernel calls
#: through multi-minute simulated serving tails.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0)

LabelSet = Tuple[Tuple[str, str], ...]

_PROM_OK = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """``name`` sanitised for the Prometheus exposition format."""
    return _PROM_OK.sub("_", name)


class Counter:
    """A monotonically increasing count."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0; counters never decrease)."""
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """A point-in-time value (last write wins)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        """Record the current value."""
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative semantics.

    ``edges`` are the finite upper bounds (ascending); an observation
    lands in the first bucket whose edge is >= the value, or the implicit
    ``+Inf`` bucket past the last edge.  ``counts`` holds the PER-BUCKET
    (non-cumulative) counts, length ``len(edges) + 1``.
    """

    kind = "histogram"
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float] = DEFAULT_BUCKETS):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"bucket edges must be strictly ascending: "
                             f"{edges}")
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        """Record one observation (edge-inclusive: ``v == edge`` lands in
        that edge's bucket, matching Prometheus ``le`` semantics)."""
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> Tuple[Tuple[float, int], ...]:
        """``(le, cumulative_count)`` rows, ending with ``(inf, count)``."""
        out = []
        running = 0
        for edge, n in zip(self.edges, self.counts):
            running += n
            out.append((edge, running))
        out.append((float("inf"), self.count))
        return tuple(out)


class MetricsRegistry:
    """All instruments of one observability session, keyed (name, labels).

    A name is bound to ONE instrument kind on first touch; asking for the
    same name as a different kind raises (``serve.shed`` cannot be a
    counter in one module and a histogram in another).
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelSet], object] = {}
        self._kinds: Dict[str, str] = {}

    @staticmethod
    def _label_key(labels: dict) -> LabelSet:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _get(self, name: str, kind: str, factory, labels: dict):
        have = self._kinds.setdefault(name, kind)
        if have != kind:
            raise ValueError(
                f"metric {name!r} is already a {have}, not a {kind}")
        key = (name, self._label_key(labels))
        metric = self._metrics.get(key)
        if metric is None:
            metric = factory()
            self._metrics[key] = metric
        return metric

    def counter(self, name: str, **labels) -> Counter:
        """The counter for ``(name, labels)`` (created on first touch)."""
        return self._get(name, "counter", Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        """The gauge for ``(name, labels)`` (created on first touch)."""
        return self._get(name, "gauge", Gauge, labels)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        """The histogram for ``(name, labels)``.

        ``buckets`` fixes the edges on FIRST touch; later calls must pass
        the same edges (or None to accept whatever was fixed).
        """
        hist = self._get(
            name, "histogram",
            lambda: Histogram(buckets if buckets is not None
                              else DEFAULT_BUCKETS), labels)
        if buckets is not None and tuple(float(b) for b in buckets) != \
                hist.edges:
            raise ValueError(
                f"histogram {name!r} already has edges {hist.edges}; "
                f"cannot re-bucket to {tuple(buckets)}")
        return hist

    # -- read side -----------------------------------------------------------
    def collect(self) -> Iterable[Tuple[str, LabelSet, object]]:
        """Every instrument as ``(name, labels, metric)``, sorted."""
        return sorted(self._metrics.items(), key=lambda kv: kv[0])

    def total(self, name: str) -> float:
        """Sum of a counter/gauge across ALL label sets (0.0 if untouched)."""
        return sum(m.value for (n, _), m in self._metrics.items()
                   if n == name and hasattr(m, "value"))

    def value(self, name: str, **labels) -> Optional[float]:
        """One counter/gauge value, or None if that label set never fired."""
        m = self._metrics.get((name, self._label_key(labels)))
        return None if m is None or not hasattr(m, "value") else m.value

    # -- Prometheus text exposition ------------------------------------------
    def to_prometheus(self) -> str:
        """The whole registry in Prometheus text format (sorted, stable)."""
        by_name: Dict[str, list] = {}
        for (name, labels), metric in self.collect():
            by_name.setdefault(name, []).append((labels, metric))
        lines = []
        for name in sorted(by_name):
            pn = prom_name(name)
            kind = self._kinds[name]
            lines.append(f"# TYPE {pn} {kind}")
            for labels, metric in by_name[name]:
                if kind == "histogram":
                    for le, cum in metric.cumulative():
                        le_s = "+Inf" if le == float("inf") else repr(le)
                        lines.append(f"{pn}_bucket"
                                     f"{_fmt_labels(labels + (('le', le_s),))}"
                                     f" {cum}")
                    lines.append(f"{pn}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_value(metric.sum)}")
                    lines.append(f"{pn}_count{_fmt_labels(labels)} "
                                 f"{metric.count}")
                else:
                    lines.append(f"{pn}{_fmt_labels(labels)} "
                                 f"{_fmt_value(metric.value)}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels: LabelSet) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def _fmt_value(v: float) -> str:
    # integers render without a trailing .0 (counters are usually counts)
    return str(int(v)) if float(v).is_integer() else repr(float(v))
