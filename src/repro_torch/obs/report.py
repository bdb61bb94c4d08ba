"""``obs_report`` — render a human-readable summary of an obs dump.

Reads the Prometheus text dump (and optionally the Perfetto JSON) that
``obs.export.write_prometheus`` / ``write_perfetto`` write and prints a run
summary: top spans by total time, cache-hit ratios, the shed breakdown,
and per-rung stage latency histograms.  Pure text in, pure text out —
the ``render`` function is deterministic for a given pair of dumps, so
tests golden-check it.

Usage::

    PYTHONPATH=src python -m repro_torch.obs.report --metrics m.prom \\
        [--perfetto t.json] [--top 10]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.export import parse_prometheus

__all__ = ["render", "main"]

Samples = Dict[str, List[Tuple[Dict[str, str], float]]]

#: ``(title, hit_series, miss_or_cost_series)`` ratio rows.  The second
#: series is the "other" outcome — hits / (hits + other).
_RATIO_ROWS = (
    ("runtime.executable", "runtime_executable_hit",
     "runtime_executable_compile"),
    ("decode.panel_cache", "decode_panel_cache_hit",
     "decode_panel_cache_miss"),
)


def _total(samples: Samples, name: str) -> float:
    return sum(v for _, v in samples.get(name, ()))


def _fmt_labels(labels: Dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _section_counters(samples: Samples) -> List[str]:
    lines = ["== counters =="]
    skip = ("_bucket", "_sum", "_count")
    for name in sorted(samples):
        if name.endswith(skip):
            continue
        for labels, value in samples[name]:
            label_s = f"{{{_fmt_labels(labels)}}}" if labels else ""
            lines.append(f"  {name}{label_s} = {value:g}")
    return lines


def _section_ratios(samples: Samples) -> List[str]:
    lines = ["== cache hit ratios =="]
    for title, hit_name, other_name in _RATIO_ROWS:
        hits = _total(samples, hit_name)
        other = _total(samples, other_name)
        denom = hits + other
        if denom == 0:
            continue
        lines.append(f"  {title}: {hits:g} hit / {other:g} other "
                     f"= {hits / denom:.1%}")
    if len(lines) == 1:
        lines.append("  (no cache activity recorded)")
    return lines


def _section_sheds(samples: Samples) -> List[str]:
    lines = ["== admission =="]
    admitted = _total(samples, "serve_admit")
    lines.append(f"  admitted = {admitted:g}")
    sheds = samples.get("serve_shed", [])
    if not sheds:
        lines.append("  shed = 0")
        return lines
    lines.append(f"  shed = {sum(v for _, v in sheds):g}")
    for labels, value in sorted(sheds, key=lambda lv: _fmt_labels(lv[0])):
        lines.append(f"    {_fmt_labels(labels)}: {value:g}")
    return lines


def _section_histograms(samples: Samples) -> List[str]:
    lines = ["== latency histograms =="]
    any_rows = False
    for name in sorted(samples):
        if not name.endswith("_bucket"):
            continue
        base = name[: -len("_bucket")]
        # group bucket samples by their non-le label set
        groups: Dict[Tuple[Tuple[str, str], ...],
                     List[Tuple[float, float]]] = {}
        for labels, value in samples[name]:
            le = labels.get("le", "+Inf")
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            groups.setdefault(key, []).append(
                (float("inf") if le == "+Inf" else float(le), value))
        for key in sorted(groups):
            label_s = (f"{{{_fmt_labels(dict(key))}}}" if key else "")
            total = max(v for _, v in groups[key])
            sums = [v for labels, v in samples.get(base + "_sum", ())
                    if tuple(sorted((k, x) for k, x in labels.items()))
                    == key]
            mean = (sums[0] / total) if sums and total else 0.0
            lines.append(f"  {base}{label_s}: n={total:g} mean={mean:.4g}s")
            prev = 0.0
            for le, cum in sorted(groups[key]):
                in_bucket = cum - prev
                prev = cum
                if in_bucket <= 0:
                    continue
                le_s = "+Inf" if le == float("inf") else f"{le:g}"
                lines.append(f"    le {le_s}: {in_bucket:g}")
            any_rows = True
    if not any_rows:
        lines.append("  (no histograms recorded)")
    return lines


def _section_spans(events: List[dict], top: int) -> List[str]:
    lines = [f"== top spans (by total time, top {top}) =="]
    agg: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        agg.setdefault(ev["name"], []).append(ev.get("dur", 0.0))
    rows = sorted(agg.items(), key=lambda kv: (-sum(kv[1]), kv[0]))[:top]
    if not rows:
        lines.append("  (no spans recorded)")
    for name, durs in rows:
        total_s = sum(durs) / 1e6
        lines.append(f"  {name}: n={len(durs)} total={total_s:.4g}s "
                     f"mean={total_s / len(durs):.4g}s")
    return lines


def render(metrics_text: str, perfetto_doc: Optional[dict] = None,
           top: int = 10) -> str:
    """The full report for one metrics dump (+ optional Perfetto trace)."""
    samples = parse_prometheus(metrics_text)
    blocks = []
    if perfetto_doc is not None:
        blocks.append(_section_spans(
            perfetto_doc.get("traceEvents", []), top))
    blocks.append(_section_ratios(samples))
    blocks.append(_section_sheds(samples))
    blocks.append(_section_histograms(samples))
    blocks.append(_section_counters(samples))
    return "\n".join("\n".join(b) for b in blocks) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point: print the report for the given dump files."""
    ap = argparse.ArgumentParser(prog="obs_report", description=__doc__)
    ap.add_argument("--metrics", required=True,
                    help="Prometheus text dump (write_prometheus)")
    ap.add_argument("--perfetto", default=None,
                    help="Perfetto/Chrome-trace JSON (write_perfetto)")
    ap.add_argument("--top", type=int, default=10,
                    help="how many span rows to show")
    args = ap.parse_args(argv)
    with open(args.metrics) as fh:
        metrics_text = fh.read()
    perfetto_doc = None
    if args.perfetto:
        with open(args.perfetto) as fh:
            perfetto_doc = json.load(fh)
    print(render(metrics_text, perfetto_doc, top=args.top), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
