"""The port's dry run (``launch/dryrun.py``) and the config rules it reads.

``shape_applicable`` and ``cells`` equal the reference's for every
architecture.  SMOKE cells trace on a fake (2, 2) mesh (a fake process
group of 4 ranks, this process rank 0) in a child process, since the fake
group belongs to the whole process: each writes the JSON schema of the
reference's dry run (less ``cost`` and ``hlo_lines``, ``trace_s`` for the
compile times) and an op log that ``reanalyze_all`` turns back into the
same figures.  The dot-FLOP parity with the reference's ``analyze_hlo`` is
in ``test_torch_dryrun_parity.py`` (serving steps) and
``test_torch_dryrun_train.py`` (train steps).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import shape_applicable as jshape_applicable
from repro_torch.configs import SHAPES, cells, get_config, list_archs, shape_applicable

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", jlist_archs())
def test_shape_rules_match_the_reference(arch):
    assert list_archs() == jlist_archs() and list(SHAPES) == list(JSHAPES)
    for s in SHAPES:
        assert shape_applicable(get_config(arch), s) == jshape_applicable(jget_config(arch), s)
    assert cells(arch) == jcells(arch)


# the child: SMOKE cells on a (2, 2) mesh of fake ranks, each written as the
# CLI writes it, then every op log reanalyzed
_CHILD = """
import json, sys
from pathlib import Path
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.launch.dryrun import reanalyze_all, run_cell
out = Path(sys.argv[1])
cells = [("qwen3_0_6b", "prefill", None), ("qwen3_0_6b", "decode", None),
         ("qwen3_0_6b", "train", None), ("rwkv6_3b", "train", {"rwkv_kernel": True}),
         ("jamba_1_5_large_398b", "prefill", {"mamba_kernel": True})]
for arch, kind, over in cells:
    spec = ShapeSpec("smoke_" + kind, 64, 2, kind)
    res = run_cell(arch, spec, cfg_overrides=over, device="cpu", results_dir=out,
                   cfg=get_smoke_config(arch), mesh_shape=(2, 2))
    (out / f"{arch}__smoke_{kind}__singlepod.json").write_text(json.dumps(res))
before = {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}
assert reanalyze_all(out) == len(cells)
after = {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}
assert before == after, "reanalysis changed a cell"
print("done")
"""


@pytest.fixture(scope="module")
def smoke_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(out)], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("done"), \
        proc.stdout[-2000:] + proc.stderr[-4000:]
    return {p.name.split("__")[0] + ":" + p.name.split("__")[1]: json.loads(p.read_text())
            for p in out.glob("*.json")}, out


def test_smoke_cells_write_the_reference_schema(smoke_cells):
    cells_, out = smoke_cells
    assert len(cells_) == 5
    for name, c in cells_.items():
        assert set(c) == {"arch", "shape", "multi_pod", "kind", "n_devices", "trace_s",
                          "memory", "collectives", "dot_flops", "dot_count", "hbm_bytes",
                          "kernel_calls"}, name
        assert set(c["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes"}
        assert set(c["collectives"]) == {"bytes_by_kind", "count_by_kind", "total_bytes"}
        assert c["n_devices"] == 4 and c["multi_pod"] is False
        assert c["dot_flops"] > 0 and c["dot_count"] > 0 and c["hbm_bytes"] > 0
        assert c["memory"]["argument_bytes"] > 0 and c["memory"]["temp_bytes"] > 0
        assert c["collectives"]["total_bytes"] == pytest.approx(
            sum(c["collectives"]["bytes_by_kind"].values()))
        assert (out / f"{c['arch']}__{c['shape']}__singlepod.ops.jsonl.gz").exists()


def test_smoke_cells_on_a_mesh(smoke_cells):
    """What a (2, 2) mesh adds: the sharded parameters' collectives in every
    step (the train step's reduce-scatters of the FSDP gradients), the
    kernel ops (one a scan layer, twice in a train step: remat), and the
    returned serve cache counted as output, the train step's updates not."""
    cells_, _ = smoke_cells
    train, prefill = cells_["qwen3_0_6b:smoke_train"], cells_["qwen3_0_6b:smoke_prefill"]
    assert train["kind"] == "train" and train["collectives"]["count_by_kind"]["reduce-scatter"]
    assert prefill["collectives"]["count_by_kind"]["all-gather"]
    assert train["memory"]["output_bytes"] < 64          # the metrics only
    assert prefill["memory"]["output_bytes"] > 0         # logits and the cache
    assert cells_["rwkv6_3b:smoke_train"]["kernel_calls"] == {"wkv_scan": 4}
    assert cells_["jamba_1_5_large_398b:smoke_prefill"]["kernel_calls"] == {"mamba_scan": 7}
    assert not train["kernel_calls"]
