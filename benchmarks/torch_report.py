"""Markdown tables from the port's dry-run cells.

The twin of ``benchmarks/report.py``'s dry-run, roofline and variant
sections over ``build/dryrun/`` (``repro_torch.launch.dryrun`` and
``benchmarks/torch_hillclimb.py`` write it), at the H100's figures of
``benchmarks/torch_roofline.py``.  The paper benches have their own twins
(``torch_fig1_latency``, ``torch_table1_error``, ``torch_tradeoff_sweep``).
The report goes only to ``--out``.

Usage:
  python -m benchmarks.torch_report --out build/dryrun/REPORT.md
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from benchmarks.torch_roofline import RESULTS_DIR, load_cells, mem_gib, roofline_row, terms


def _md_table(header, rows) -> str:
    out = ["| " + " | ".join(header) + " |",
           "|" + "|".join("---" for _ in header) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(x) for x in r) + " |")
    return "\n".join(out)


def dryrun_section(results_dir: Path = RESULTS_DIR) -> str:
    rows = []
    for mesh in ("singlepod", "multipod"):
        for c in load_cells(mesh, results_dir):
            rows.append((c["arch"], c["shape"], "2x16x16" if c["multi_pod"] else "16x16",
                         f"{c['trace_s']:.0f}s", f"{c['dot_flops']:.2e}",
                         f"{c['collectives']['total_bytes']:.2e}", f"{mem_gib(c):.1f}"))
    return _md_table(["arch", "shape", "mesh", "trace", "dot FLOPs/dev", "coll B/dev",
                      "GiB/dev (args+temp)"], rows)


def roofline_section(results_dir: Path = RESULTS_DIR) -> str:
    rows = []
    for c in load_cells("singlepod", results_dir):
        r = roofline_row(c)
        rows.append((r["arch"], r["shape"], f"{r['compute_s']:.3f}", f"{r['memory_s']:.3f}",
                     f"{r['collective_s']:.3f}", r["dominant"], f"{r['useful_ratio']:.2f}",
                     f"{r['roofline_fraction']:.3f}", f"{r['mem_gib_per_dev']:.0f}"))
    return _md_table(["arch", "shape", "compute s", "memory s", "collective s", "dominant",
                      "useful ratio", "roofline frac", "GiB/dev"], rows)


def perf_section(results_dir: Path = RESULTS_DIR) -> str:
    """Each hillclimb variant's terms beside its baseline cell's."""
    rows = []
    for f in sorted(results_dir.glob("*__singlepod__*.json")):
        base_name, variant = f.stem.split("__singlepod__")
        base_f = results_dir / f"{base_name}__singlepod.json"
        if not base_f.exists():
            continue
        c, b = json.loads(f.read_text()), json.loads(base_f.read_text())
        bt, vt = terms(b), terms(c)
        rows.append((c["arch"], c["shape"], variant,
                     *(f"{bt[k]:.2f}→{vt[k]:.2f}" for k in ("compute", "memory",
                                                            "collective")),
                     f"{max(bt.values()) / max(vt.values()):.2f}x"))
    if not rows:
        return "(run benchmarks/torch_hillclimb.py first)"
    return _md_table(["arch", "shape", "variant", "compute s", "memory s", "collective s",
                      "bottleneck speedup"], rows)


def report(results_dir: Path = RESULTS_DIR) -> str:
    """The three sections, each under its heading."""
    return "\n\n".join(f"## {title}\n\n{fn(results_dir)}" for title, fn in (
        ("Dry run (predicted, H100)", dryrun_section),
        ("Roofline (predicted, H100 SXM figures)", roofline_section),
        ("Variants", perf_section))) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="where the markdown goes")
    ap.add_argument("--results", default=str(RESULTS_DIR), help="the dry-run cells")
    args = ap.parse_args(argv)
    Path(args.out).write_text(report(Path(args.results)))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
