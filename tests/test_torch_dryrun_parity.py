"""Dot-FLOP parity of the port's accounting with the reference's
``analyze_hlo``, serving steps (prefill and decode) on one device.

The reference compiles each SMOKE step (B = 2, S = 64) with abstract
inputs and parses the HLO; the port traces the same step under fake
tensors (``launch/dryrun.py::trace_cell`` without a mesh) and counts the
ops it dispatches.  Every serving step does the same products, so the
counts are equal, also with the WKV kernel on (``rwkv_kernel=True``: the
reference counts no dot inside a Pallas call, the port none inside a
kernel op).  The train steps are in ``test_torch_dryrun_train.py``.
"""
import dataclasses

import pytest

import jax
import jax.numpy as jnp

from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.specs import abstract_batch, abstract_cache, abstract_state
from repro.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro.optim import OptConfig as JOptConfig
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.launch.dryrun import trace_cell

B, S = 2, 64


def jax_dot_flops(arch: str, kind: str, overrides: dict) -> float:
    """The reference's ``analyze_hlo`` dot FLOPs of a compiled SMOKE step."""
    cfg = dataclasses.replace(jget_smoke_config(arch), **overrides)
    shape = JShapeSpec("smoke", S, B, kind)
    params, opt = abstract_state(cfg, None, with_opt=kind == "train")
    batch = abstract_batch(cfg, shape, None)
    if kind == "train":
        lowered = jax.jit(make_train_step(cfg, JOptConfig(), None)).lower(params, opt, batch)
    elif kind == "prefill":
        lowered = jax.jit(make_prefill_step(cfg, None, S_max=S)).lower(params, batch)
    else:
        cache = abstract_cache(cfg, B, S, None)
        lowered = jax.jit(make_serve_step(cfg, None)).lower(
            params, cache, batch, jax.ShapeDtypeStruct((), jnp.int32))
    return analyze_hlo(lowered.compile().as_text()).dot_flops


def port_cell(arch: str, kind: str, overrides: dict) -> dict:
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    return trace_cell(arch, ShapeSpec("smoke", S, B, kind), cfg=cfg, mesh_shape=(),
                      device="cpu")


CASES = [
    ("qwen3_0_6b", "prefill", {}, 21_626_880),
    ("qwen3_0_6b", "decode", {}, 491_520),
    ("rwkv6_3b", "prefill", {}, 25_821_184),
    ("rwkv6_3b", "prefill", {"rwkv_kernel": True}, 25_296_896),
    ("rwkv6_3b", "decode", {}, 532_480),
    ("jamba_1_5_large_398b", "prefill", {}, 187_826_176),
    ("jamba_1_5_large_398b", "decode", {}, 3_076_096),
]


@pytest.mark.parametrize("arch,kind,overrides,flops", CASES,
                         ids=[f"{a}-{k}{'-kernel' if o else ''}" for a, k, o, _ in CASES])
def test_serving_dot_flops_equal_the_reference(arch, kind, overrides, flops):
    cell = port_cell(arch, kind, overrides)
    assert cell["dot_flops"] == jax_dot_flops(arch, kind, overrides) == flops
    assert cell["n_devices"] == 1 and not cell["collectives"]["bytes_by_kind"]
    if overrides:
        assert cell["kernel_calls"] == {"wkv_scan": get_smoke_config(arch).n_layers}
