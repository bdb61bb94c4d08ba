"""BENCHMARK.json against the harness: every name resolves to a file, the
contract's shapes hold, and nothing imports JAX or the JAX package."""
import ast
import json
import re
import subprocess
import sys

import pytest

from coded_bench import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["coded_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_resolve_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("coded_bench/") and c["file"] not in files
        files.add(c["file"])
        cfg = spec.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert hasattr(spec.module("problems", cfg["problem"]), "Problem")
        assert set(c["reduced"]) == set(cfg.get("reduced_from", {}))
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_files(cell):
    w = spec.workload(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["traffic"]) and w["chips"] == 1 and _line(w["why"])
    mix = spec.mix(w["traffic"])
    entry = spec.module("entries", mix["entry"])
    assert hasattr(entry, "Entry")
    e2e = [m["name"] for m in spec.metrics(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics(BENCH, cell, "per_layer")
    assert layer
    for m in spec.metrics(BENCH, cell, "end_to_end") + layer:
        assert hasattr(spec.module("metrics", m["name"]), "read")
    assert len({(x["config"], x["traffic"]) for x in BENCH["workloads"]}) == len(CELLS)


def test_metrics_follow_the_contract():
    names = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        layers.setdefault(m["name"].split(".")[0], m["layer"])
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
    assert {m["name"] for m in BENCH["per_layer"] if m["name"].endswith("_roofline")} \
        <= {m["name"] for m in BENCH["per_layer"] if m["unit"] == "%"}


def test_files_are_named_from_name_characters():
    for path in spec.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_harness_module_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path.name, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    tops = {name.split(".")[0] for name in _imports(spec.HERE / "reference.py")}
    assert tops <= {"__future__", "numpy", "torch"}


def test_forbidden_modules_compare_whole_top_level_names():
    assert run._loaded_forbidden(["repro_torch", "repro_torch.core", "torch"]) == []
    assert run._loaded_forbidden(["repro_torch", "repro.core", "jaxlib.xla"]) == \
        ["jaxlib", "repro"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "coded_bench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(spec.ROOT / "build")})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(proc.stdout or "x")
