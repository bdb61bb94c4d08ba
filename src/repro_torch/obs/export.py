"""Exporters: Chrome-trace/Perfetto JSON and Prometheus text dumps.

``write_perfetto`` renders the span list in the Chrome trace event
format (the JSON flavour Perfetto and ``chrome://tracing`` both load):
one *process* row per span ``track`` (we use tracks for SLO classes),
one *thread* row per ``lane`` (pipeline stages: workers vs decode), and
one complete event (``ph: "X"``) per span with microsecond ``ts``/
``dur``.  Pipeline overlap — decode of batch *t* running concurrently
with workers of batch *t+1* — shows up as overlapping slices on the two
lanes of one track.

``write_prometheus`` dumps the metrics registry in the Prometheus text
exposition format; ``parse_prometheus`` reads such a dump back into
plain dicts for the ``obs_report`` CLI and for tests.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import Span

__all__ = ["perfetto_events", "write_perfetto", "write_prometheus",
           "parse_prometheus"]


def _track_ids(spans: Iterable[Span]) -> Tuple[Dict[str, int],
                                               Dict[Tuple[str, str], int]]:
    """Stable (pid per track, tid per (track, lane)) assignments."""
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    for s in spans:
        if s.track not in pids:
            pids[s.track] = len(pids) + 1
        key = (s.track, s.lane)
        if key not in tids:
            tids[key] = sum(1 for t, _ in tids if t == s.track) + 1
    return pids, tids


def perfetto_events(spans: Iterable[Span]) -> List[dict]:
    """The Chrome trace event list for ``spans`` (metadata + slices)."""
    spans = list(spans)
    pids, tids = _track_ids(spans)
    events: List[dict] = []
    for track, pid in pids.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": track}})
    for (track, lane), tid in tids.items():
        events.append({"ph": "M", "name": "thread_name",
                       "pid": pids[track], "tid": tid,
                       "args": {"name": lane}})
    for s in spans:
        args = dict(s.attrs)
        if not s.ok:
            args["error"] = "1"
        events.append({
            "ph": "X",
            "name": s.name,
            "pid": pids[s.track],
            "tid": tids[(s.track, s.lane)],
            "ts": round(s.start_s * 1e6, 3),
            "dur": round(max(0.0, s.end_s - s.start_s) * 1e6, 3),
            "args": args,
        })
    return events


def _mkparent(path: str) -> None:
    """Create ``path``'s parent directory if it does not exist yet."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)


def write_perfetto(path: str, spans: Iterable[Span]) -> None:
    """Write ``spans`` as a Chrome-trace JSON file at ``path``."""
    doc = {"traceEvents": perfetto_events(spans),
           "displayTimeUnit": "ms"}
    _mkparent(path)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def write_prometheus(path: str, registry: MetricsRegistry) -> None:
    """Write the registry's Prometheus text dump at ``path``."""
    _mkparent(path)
    with open(path, "w") as fh:
        fh.write(registry.to_prometheus())


_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Parse a Prometheus text dump into ``{name: [(labels, value)]}``.

    Only what the report CLI needs: sample lines with optional labels;
    ``# TYPE``/comment lines are skipped.  Histogram series keep their
    ``_bucket``/``_sum``/``_count`` suffixed names and ``le`` labels.
    """
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"unparseable metrics line: {line!r}")
        labels = {k: v.replace(r"\"", '"').replace(r"\\", "\\")
                  for k, v in _LABEL.findall(m.group("labels") or "")}
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else float(raw)
        out.setdefault(m.group("name"), []).append((labels, value))
    return out
