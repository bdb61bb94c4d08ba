"""Roofline terms from the port's dry-run cells, at the H100's figures.

The twin of ``benchmarks/roofline.py`` over ``repro_torch.launch.dryrun``'s
JSON (``build/dryrun/``).  Per (arch x shape x mesh) cell:

  compute term    = dot FLOPs a device / PEAK_FLOPS            [s]
  memory term     = HBM bytes a device / HBM_BW                [s]
  collective term = collective bytes a device / LINK_BW        [s]

plus MODEL_FLOPS / dot FLOPs (the useful-compute ratio: remat, the
checkpointed loss chunks and padding show here) and the dominant term.
The dot FLOPs and bytes are the dry run's per-device counts of the ops an
eager step dispatches (``launch/hlo_analysis.py``); an eager step fuses no
elementwise ops, so its HBM term is larger than a compiled step's.  Every
figure is a prediction of the dry run, not a measurement.

Hardware: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at 700 W):
989.4 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, and NVLink 4 at
450 GB/s a direction (900 GB/s both ways).

Usage:
  python -m benchmarks.torch_roofline            # rows of build/dryrun/*__singlepod.json
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.models.stats import attention_score_flops, model_flops

PEAK_FLOPS = 989.4e12    # bf16 dense, tensor cores, a card
HBM_BW = 3.35e12         # B/s a card
# NVLink 4, one direction, a card.  Optimistic for the production mesh: an
# NVLink domain is one 8-card node, so a 16-wide model axis spans two nodes
# and part of its traffic crosses the slower inter-node network.
LINK_BW = 450e9

RESULTS_DIR = Path(__file__).resolve().parents[1] / "build" / "dryrun"


def load_cells(mesh: str = "singlepod", results_dir: Path = RESULTS_DIR):
    return [json.loads(f.read_text())
            for f in sorted(results_dir.glob(f"*__{mesh}.json"))]


def terms(cell: dict) -> dict:
    """{"compute", "memory", "collective"} seconds of a cell at the H100's
    figures."""
    return {"compute": cell["dot_flops"] / PEAK_FLOPS,
            "memory": cell.get("hbm_bytes", 0.0) / HBM_BW,
            "collective": cell["collectives"]["total_bytes"] / LINK_BW}


def mem_gib(cell: dict) -> float:
    """GiB a device: arguments plus the step's peak of what it allocates."""
    mem = cell["memory"]
    return ((mem["argument_bytes"] or 0) + (mem["temp_bytes"] or 0)) / 2 ** 30


def roofline_row(cell: dict) -> dict:
    arch, shape_name = cell["arch"], cell["shape"]
    n_dev = cell["n_devices"]
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    t = terms(cell)
    mf = model_flops(cfg, shape.kind, shape.global_batch, shape.seq_len)
    attn_f = attention_score_flops(cfg, shape.kind, shape.global_batch, shape.seq_len)
    useful = (mf + attn_f) / n_dev
    dominant = max(t, key=t.get)
    total = max(t.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": cell["multi_pod"],
        "compute_s": t["compute"], "memory_s": t["memory"], "collective_s": t["collective"],
        "dominant": dominant,
        "model_flops_per_dev": useful,
        "hlo_flops_per_dev": cell["dot_flops"],
        "useful_ratio": useful / max(cell["dot_flops"], 1.0),
        "roofline_fraction": (useful / PEAK_FLOPS) / max(total, 1e-12),
        "mem_gib_per_dev": mem_gib(cell),
        "trace_s": cell["trace_s"],
    }


def main(results_dir: Path = RESULTS_DIR):
    cells = load_cells(results_dir=results_dir)
    if not cells:
        print("no dry-run artifacts yet (run repro_torch.launch.dryrun)")
        return []
    rows = [roofline_row(c) for c in cells]
    print("arch,shape,compute_s,memory_s,collective_s,dominant,"
          "useful_ratio,roofline_fraction,mem_gib_per_dev")
    for r in rows:
        print(f"{r['arch']},{r['shape']},{r['compute_s']:.4f},"
              f"{r['memory_s']:.4f},{r['collective_s']:.4f},{r['dominant']},"
              f"{r['useful_ratio']:.3f},{r['roofline_fraction']:.3f},"
              f"{r['mem_gib_per_dev']:.1f}")
    return rows


if __name__ == "__main__":
    main()
