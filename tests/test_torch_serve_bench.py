"""The serve bench twin (``benchmarks/torch_serve_bench.py``) on the CPU.

Its rows must equal ``benchmarks/serve_bench.py``'s (run here through the
JAX package) and the checked-in ``BENCH_serve.json``'s field for field,
pass the reference's ``check`` gates, and leave ``BENCH_serve.json`` alone:
the twin writes JSON only to the path ``--out`` names.
"""
import json
from pathlib import Path

import jax
import pytest

jax.config.update("jax_enable_x64", True)

from benchmarks import torch_serve_bench  # noqa: E402
from repro_torch import obs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _obs_off():
    """The bench's CompileWatch turns obs on; leave it off for the next test."""
    yield
    obs.disable()


@pytest.fixture(scope="module")
def check_rows():
    result = torch_serve_bench.run(list(torch_serve_bench.CHECK_SCENARIOS),
                                   "reference", CPU)
    obs.disable()
    return result


def test_heavy_tail_row_equals_the_reference_bench(check_rows):
    from benchmarks import serve_bench
    from repro.core.numerics import enable_x64

    with enable_x64():
        want = serve_bench.run(["heavy_tail"])
    got = {row["scenario"]: row for row in check_rows["scenarios"]}
    assert got["heavy_tail"] == want["scenarios"][0]
    assert check_rows["config"] == want["config"]
    assert check_rows["recompiles"] == want["recompiles"] == 0


def test_rows_equal_the_checked_in_file(check_rows):
    recorded = json.loads((ROOT / "BENCH_serve.json").read_text())
    rows = {row["scenario"]: row for row in recorded["scenarios"]}
    for row in check_rows["scenarios"]:
        assert row == rows[row["scenario"]]


def test_check_passes(check_rows):
    torch_serve_bench.check(check_rows)


def test_check_fails_when_the_baseline_meets_the_premium_slo(check_rows):
    rows = json.loads(json.dumps(check_rows))
    gold = rows["scenarios"][0]["baseline"]["tenants"]["gold"]
    gold["p_slo_s"] = gold["slo_s"] / 2
    with pytest.raises(AssertionError, match="baseline MET"):
        torch_serve_bench.check(rows)


def test_main_writes_only_the_out_path(tmp_path, capsys):
    bench_file = ROOT / "BENCH_serve.json"
    before = bench_file.read_bytes()
    out = tmp_path / "rows.json"
    torch_serve_bench.main(["--check", "--device", CPU, "--scenario",
                            "heavy_tail", "--scenario", "pareto",
                            "--out", str(out)])
    assert json.loads(out.read_text())["scenarios"]
    assert bench_file.read_bytes() == before
    text = capsys.readouterr().out
    assert "serve bench check (reference): OK" in text
    assert text.count("req/s") == 4


def test_mesh_backend_raises():
    """The tier's split stages do not run on mesh (the reference's bench
    offers no mesh at all)."""
    with pytest.raises(NotImplementedError, match="split worker/decode stages"):
        torch_serve_bench.run(["heavy_tail"], "mesh", CPU)
