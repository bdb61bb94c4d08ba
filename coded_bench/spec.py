"""Find everything a cell needs by the names ``BENCHMARK.json`` gives.

* a configuration: the JSON file its ``configs`` entry names, which names
  its problem: ``problems/<problem>.py``, the inputs, the work counted and
  the comparison with the plain reference;
* a traffic mix: ``mixes/<traffic>.json``, which names its entry, its loop
  and its draw models (``traffic``);
* an entry: ``entries/<entry>.py``, the program calls a request makes;
* a loop: ``loops/<loop>.py``, how the window offers requests;
* a draw model: ``draws/<model>.py``;
* a metric: ``metrics/<name>.py``, its reader.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(path=None) -> dict:
    """The parsed ``BENCHMARK.json`` at the checkout's root."""
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def _named(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    """The ``workloads`` entry called ``name``."""
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    """The configuration file of the ``configs`` entry called ``name``."""
    return json.loads((ROOT / _named(bench["configs"], name, "config")["file"])
                      .read_text())


def mix(name: str) -> dict:
    """The parameters of the traffic mix called ``name``."""
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def module(kind: str, name: str):
    """``<kind>/<name>.py`` loaded as a module (``kind``: problems, entries,
    loops, draws, metrics); one module object a file."""
    path = HERE / kind / f"{name}.py"
    key = f"coded_bench.{kind}.{name.replace('-', '_').replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    if not path.is_file():
        raise KeyError(f"no file {path.relative_to(ROOT)} for {name!r}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` (end_to_end or per_layer) this cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
