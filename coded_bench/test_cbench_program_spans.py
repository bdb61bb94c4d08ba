"""The program's own spans in a traced run on its plain CPU path (v = 8000,
32 x 32 outputs): they reach the profiler as ranges with ``repro_torch.obs``
off, so the breakdown names them, and no reader turns collection on."""
import pytest
import torch

from coded_bench import run

SMALL = {"r": 32, "t": 32}


@pytest.fixture
def obs_off():
    from repro_torch import obs

    obs.disable()
    yield obs
    obs.disable()


@pytest.mark.parametrize("cell", ["tradeoff-8000-first9", "tradeoff-8000-partial4"])
def test_traced_run_reads_the_facades_spans(cell, obs_off):
    torch.set_num_threads(2)
    # a window long enough that the traced part (its middle fifth) starts
    # between two requests on a loaded CPU
    res = run.run_cell(cell, 2**31 + 11, 1.5, True, device="cpu", overrides=SMALL)
    assert res["correct"]
    assert not obs_off.enabled()
    # no device work on the CPU: no stage claims any, so the decode stage's
    # roofline reads nothing
    assert "decode_stage_roofline" not in res["metrics"]
    # the facade's spans (runtime.call, runtime.prepare) hold idle time
    gaps = [name for name, _ in res["breakdown"]["idle_gaps"]]
    assert any(name.startswith("runtime.") for name in gaps), gaps
