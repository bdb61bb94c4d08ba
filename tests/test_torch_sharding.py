"""The port's sharding rules against the reference's.

The reference's tables, logical axes and resolved ``PartitionSpec`` s come
from a child process with eight fake XLA devices (as
``tests/test_mesh.py::run_child`` makes them), on a (2, 4) ("data",
"model") mesh; the port's from a one-process "fake" process group of eight
ranks, whose ``DeviceMesh`` resolves placements without communicating.
Every config's SMOKE tree is compared leaf for leaf: the parameters (the
reference's stacked layout, and the port's per-layer ``LM`` through it),
the optimizer state, the batches and the serve cache, the dropped
non-dividing axes included; and ``launch/specs.py``'s abstract shapes and
dtypes against the reference's.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import SHAPES, ShapeSpec, get_smoke_config, list_archs
from repro_torch.distributed import axis_rules, current_rules, shard
from repro_torch.distributed.param_sharding import (
    batch_logical_axes,
    cache_logical_axes,
    param_logical_axes,
    tree_specs,
)
from repro_torch.distributed.sharding import P, default_rules, placements, resolve_spec
from repro_torch.launch import specs
from repro_torch.models import init_params, param_shapes

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
SMALL = {"train": ShapeSpec("t", 64, 8, "train"), "prefill": ShapeSpec("p", 64, 8, "prefill"),
         "decode": ShapeSpec("d", 64, 8, "decode")}

_REFERENCE = r"""
import json, sys
import jax
from repro.configs import get_smoke_config, list_archs
from repro.configs.base import ShapeSpec
from repro.distributed.param_sharding import (batch_logical_axes, cache_logical_axes,
                                              param_logical_axes, tree_shardings)
from repro.distributed.sharding import default_rules
from repro.launch import specs
from repro.models import param_shapes

def leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple) and
                           all(isinstance(e, (str, type(None))) for e in x))

def spec(s, ndim):
    out = [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]
    return out + [None] * (ndim - len(out))

mesh = jax.make_mesh((2, 4), ("data", "model"))
pod = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
rules = default_rules(mesh)
out = {"tables": {"2x4": default_rules(mesh).table, "pod": default_rules(pod).table,
                  "pod_nofsdp": default_rules(pod, fsdp=False).table}, "archs": {}}
small = {"train": ShapeSpec("t", 64, 8, "train"), "prefill": ShapeSpec("p", 64, 8, "prefill"),
         "decode": ShapeSpec("d", 64, 8, "decode")}
for arch in list_archs():
    cfg = get_smoke_config(arch)
    ps = param_shapes(cfg)
    logical = param_logical_axes(ps)
    a = {"logical": [list(x) for x in leaves(logical)],
         "params": [spec(s, len(l.shape)) for s, l in zip(
             jax.tree.leaves(tree_shardings(rules, ps, logical)), jax.tree.leaves(ps))]}
    p_abs, o_abs = specs.abstract_state(cfg, rules)
    a["opt"] = [[list(x.shape), str(x.dtype), spec(x.sharding, len(x.shape))]
                for x in jax.tree.leaves(o_abs)]
    a["state"] = [[list(x.shape), str(x.dtype)] for x in jax.tree.leaves(p_abs)]
    cache = specs.abstract_cache(cfg, 8, 64, rules)
    a["cache"] = [[{k: [list(v.shape), str(v.dtype), spec(v.sharding, len(v.shape))]
                    for k, v in pos.items()} for pos in cache]]
    a["cache_logical"] = [{k: list(v) for k, v in pos.items()} for pos in cache_logical_axes(cfg)]
    a["batch"] = {}
    for kind, shape in small.items():
        b = specs.abstract_batch(cfg, shape, rules)
        a["batch"][kind] = {k: [list(v.shape), str(v.dtype), spec(v.sharding, len(v.shape))]
                            for k, v in b.items()}
        a["batch_logical_" + kind] = {k: list(v) for k, v in batch_logical_axes(cfg, kind).items()}
    out["archs"][arch] = a
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _REFERENCE], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def mesh():
    """A (2, 4) mesh in this process over a fake group of eight ranks."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    """Leaves in jax.tree.leaves order (dict keys sorted); a spec or an axes
    tuple is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (P, specs.Placed)) and not (
            isinstance(tree, tuple) and all(isinstance(e, (str, type(None))) for e in tree)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _spec(s, ndim):
    out = [list(e) if isinstance(e, tuple) else e for e in s]
    return out + [None] * (ndim - len(out))


def _dt(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def test_default_rules_tables_equal_the_reference(reference, mesh):
    assert default_rules(mesh).table == reference["tables"]["2x4"]
    # a pod mesh: the tables only, so it needs no group of its size
    pod = type("PodMesh", (), {"mesh_dim_names": ("pod", "data", "model")})()
    want = {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in default_rules(pod).table.items()}
    assert want == reference["tables"]["pod"]
    nofsdp = {k: (list(v) if isinstance(v, tuple) else v)
              for k, v in default_rules(pod, fsdp=False).table.items()}
    assert nofsdp == reference["tables"]["pod_nofsdp"]


@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_and_resolved_specs_equal_the_reference(reference, mesh, arch):
    ref = reference["archs"][arch]
    cfg = get_smoke_config(arch)
    ps = param_shapes(cfg)
    logical = param_logical_axes(ps)
    assert [list(x) for x in _leaves(logical)] == ref["logical"]
    rules = default_rules(mesh)
    got = [_spec(s, t.ndim) for s, t in zip(_leaves(tree_specs(rules, ps, logical)),
                                             _leaves(ps))]
    assert got == ref["params"]
    # the port's per-layer LM: each parameter's axes are its stacked leaf's
    # without the leading group dim
    lm = init_params(cfg, seed=0, device="cpu")
    per_layer = param_logical_axes(lm)
    P_len = len(cfg.pattern)
    for name, axes in per_layer.items():
        top, rest = name.split(".", 1)
        if top == "blocks":
            i, part, leaf = rest.split(".")
            stacked = logical["blocks"][int(i) % P_len][part][leaf]
            assert axes == stacked[1:], name
        else:
            assert axes == logical[top][rest], name


@pytest.mark.parametrize("arch", list_archs())
def test_state_batch_and_cache_specs_equal_the_reference(reference, mesh, arch):
    ref = reference["archs"][arch]
    cfg = get_smoke_config(arch)
    rules = default_rules(mesh)
    p_abs, o_abs = specs.abstract_state(cfg, rules)
    assert [[list(x.value.shape), _dt(x.value)] for x in _leaves(p_abs)] == ref["state"]
    assert [[list(x.value.shape), _dt(x.value), _spec(x.spec, x.value.ndim)]
            for x in _leaves(o_abs)] == ref["opt"]
    # the port's cache is one dict a layer; the reference's stacks the
    # groups of each pattern position
    cache = specs.abstract_cache(cfg, 8, 64, rules)
    P_len = len(cfg.pattern)
    for p, pos in enumerate(ref["cache"][0]):
        for k, (shape, dtype, spec) in pos.items():
            for g in range(cfg.n_groups):
                x = cache[g * P_len + p][k]
                assert [cfg.n_groups, *x.value.shape] == shape and _dt(x.value) == dtype, k
                assert [None, *_spec(x.spec, x.value.ndim)] == spec, k
    for p, pos in enumerate(ref["cache_logical"]):
        for k, axes in pos.items():
            assert [None, *cache_logical_axes(cfg)[p][k]] == axes
    for kind, shape in SMALL.items():
        batch = specs.abstract_batch(cfg, shape, rules)
        assert {k: [list(v.value.shape), _dt(v.value), _spec(v.spec, v.value.ndim)]
                for k, v in batch.items()} == ref["batch"][kind]
        assert {k: list(v) for k, v in batch_logical_axes(cfg, kind).items()} == \
            ref["batch_logical_" + kind]


def test_abstract_shapes_allocate_nothing_and_match_the_config():
    cfg = get_smoke_config("jamba_1_5_large_398b")
    p_abs, o_abs = specs.abstract_state(cfg, None)
    assert all(x.device.type == "meta" for x in _leaves(p_abs) + _leaves(o_abs))
    assert o_abs["step"].dtype == torch.int32
    b = specs.input_specs(cfg, SHAPES["train_4k"])
    assert tuple(b["tokens"].shape) == (256, 4096) and b["tokens"].device.type == "meta"
    c = specs.abstract_cache(cfg, 2, 32, None)
    assert len(c) == cfg.n_layers and all(t.device.type == "meta" for d in c
                                          for t in d.values())


def test_shard_resolves_as_the_reference_and_is_a_noop_without_rules(mesh):
    """``shard`` on a DTensor lands on the resolved placements, a
    non-dividing axis dropped (replicated); without rules, or on a plain
    tensor, it returns its argument."""
    rules = default_rules(mesh)
    x = distribute_tensor(torch.zeros(8, 6, 12), mesh, [Replicate(), Replicate()])
    assert current_rules() is None and shard(x, "dp", "tp") is x
    with axis_rules(rules):
        plain = torch.zeros(3)
        assert shard(plain, "tp") is plain
        y = shard(x, "dp", "tp", "tp")        # 6 % 4: tp dropped on dim 1
        assert resolve_spec(rules, (8, 6, 12), ("dp", "tp", "tp")) == P("data", None, "model")
        assert tuple(y.placements) == placements(mesh, P("data", None, "model"))
        assert y.to_local().shape == (4, 6, 3)
    assert current_rules() is None
