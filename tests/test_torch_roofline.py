"""The readers of the port's dry run: the twin of
``tests/test_integration.py::TestRoofline`` at the H100's figures, and
``benchmarks/torch_report.py`` / ``torch_hillclimb.py`` on cells written
here."""
import ast
import json
from pathlib import Path

import pytest

from benchmarks import torch_hillclimb, torch_report, torch_roofline
from benchmarks.torch_roofline import HBM_BW, LINK_BW, PEAK_FLOPS, roofline_row

ROOT = Path(__file__).resolve().parents[1]

CELL = {
    "arch": "qwen3_0_6b", "shape": "train_4k", "multi_pod": False,
    "kind": "train", "n_devices": 256, "trace_s": 1.0,
    "dot_flops": 4.8e13, "hbm_bytes": 1.1e12,
    "collectives": {"bytes_by_kind": {"all-gather": 1.5e11}, "count_by_kind": {"all-gather": 3},
                    "total_bytes": 1.5e11},
    "memory": {"argument_bytes": 8e10, "output_bytes": 16, "temp_bytes": 5e9},
}


class TestRoofline:
    def test_roofline_row_math(self):
        r = roofline_row(CELL)
        assert r["dominant"] == "collective"
        assert 0 < r["roofline_fraction"] < 1
        assert r["compute_s"] == pytest.approx(4.8e13 / 989.4e12)
        assert r["memory_s"] == pytest.approx(1.1e12 / 3.35e12)
        assert r["collective_s"] == pytest.approx(1.5e11 / 450e9)
        assert r["mem_gib_per_dev"] == pytest.approx((8e10 + 5e9) / 2 ** 30)

    def test_h100_figures(self):
        """bf16 dense on the tensor cores, HBM3, NVLink 4 one direction."""
        assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989.4e12, 3.35e12, 450e9)


def _write_cells(d: Path) -> None:
    base = dict(CELL)
    (d / "qwen3_0_6b__train_4k__singlepod.json").write_text(json.dumps(base))
    fast = dict(CELL, collectives=dict(CELL["collectives"], total_bytes=0.5e11))
    (d / "qwen3_0_6b__train_4k__singlepod__no_fsdp.json").write_text(json.dumps(fast))
    (d / "qwen3_0_6b__train_4k__multipod.json").write_text(
        json.dumps(dict(CELL, multi_pod=True, n_devices=512)))


def test_report_sections(tmp_path):
    _write_cells(tmp_path)
    out = tmp_path / "report.md"
    torch_report.main(["--out", str(out), "--results", str(tmp_path)])
    text = out.read_text()
    assert text.count("## ") == 3
    assert "| qwen3_0_6b | train_4k | 16x16 |" in text
    assert "| qwen3_0_6b | train_4k | 2x16x16 |" in text
    # the collective term drops 3x; the memory term (0.33 s) then bounds it
    assert "| qwen3_0_6b | train_4k | no_fsdp | 0.05→0.05 | 0.33→0.33 | 0.33→0.11 | 1.02x |" in text
    rows = torch_roofline.main(tmp_path)
    assert [r["dominant"] for r in rows] == ["collective"]      # the single-pod baseline


def test_empty_results_print_no_table(tmp_path, capsys):
    assert torch_roofline.main(tmp_path) == []
    assert torch_report.perf_section(tmp_path) == "(run benchmarks/torch_hillclimb.py first)"


def _literal(path: Path, name: str):
    """A module-level literal of a reference bench, read without importing
    it (the reference bench sets XLA_FLAGS when imported)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == name:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_hillclimb_cells_and_variants_are_the_reference_s():
    ref = ROOT / "benchmarks" / "hillclimb.py"
    assert torch_hillclimb.CELLS == _literal(ref, "CELLS")
    assert torch_hillclimb.VARIANTS == _literal(ref, "VARIANTS")
    assert set(torch_hillclimb.PLAN) <= {(c, v) for c in torch_hillclimb.CELLS
                                         for v in torch_hillclimb.VARIANTS}
