"""The port's ``CodedMatmul`` (on the CPU) against the JAX package's
``CodedMatmul(plan, "fused")`` end to end, plus the port's device and
import rules.

Integer inputs within the plan's bounds decode EXACTLY in both packages, so
every comparison here is element for element.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.core import make_plan as jmake_plan  # noqa: E402
from repro.runtime import CodedMatmul as JCodedMatmul  # noqa: E402
from repro.runtime import ErasurePattern as JErasurePattern  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import make_plan  # noqa: E402
from repro_torch.core.schemes import make_scheme  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.runtime import CacheGroup, CodedMatmul, ErasurePattern, plan_token  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

SCHEMES = [
    ("bec", 2, 2, 2, 1),
    ("tradeoff", 4, 2, 1, 2),
    ("polycode", 2, 2, 1, 1),
]


def _np(x):
    return x.detach().cpu().numpy()


def _problem(rng, kind, p, m, n, pp, points="chebyshev", extra=2, batch=()):
    v, r, t = 8 * p, 12, 10
    A = rng.integers(-3, 4, size=(*batch, v, r)).astype(np.float64)
    B = rng.integers(-3, 4, size=(*batch, v, t)).astype(np.float64)
    K = make_scheme(kind, p, m, n, p_prime=pp).tau + extra
    kw = dict(K=K, L=v * 3 * 3 + 1, p_prime=pp, points=points)
    return A, B, jmake_plan(kind, p, m, n, **kw), make_plan(kind, p, m, n, **kw)


@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_every_erasure_pattern_matches_jax(rng, kind, p, m, n, pp):
    """Port fused + reference == JAX fused == A^T B, for every erasure
    pattern of size <= K - tau (K = tau + 2)."""
    A, B, jplan, plan = _problem(rng, kind, p, m, n, pp)
    jcm = JCodedMatmul(jplan, "fused")
    cm = CodedMatmul(plan, "fused", device="cpu")
    ref = cm.with_backend("reference")
    C0 = A.T @ B
    K, n_checked = plan.K, 0
    for size in range(K - plan.tau + 1):
        for erased in itertools.combinations(range(K), size):
            C_j = np.asarray(jcm(jnp.asarray(A), jnp.asarray(B), erased=list(erased)))
            for facade in (cm, ref):
                C = _np(facade(A, B, erased=list(erased)))
                np.testing.assert_array_equal(C, C_j, err_msg=str(erased))
            np.testing.assert_array_equal(C_j, C0, err_msg=str(erased))
            n_checked += 1
    assert n_checked == 1 + K + K * (K - 1) // 2
    info = cm.cache_info()
    assert info["builds"] == 2 and info["panel_builds"] == n_checked


def test_unit_circle_plan_matches_jax(rng):
    """A complex plan: the plain complex path on every backend, exact."""
    A, B, jplan, plan = _problem(rng, "bec", 2, 2, 2, 1, points="unit_circle")
    assert plan.is_complex
    for erased in ([], [1, 3], [0, 5]):
        C_j = np.asarray(JCodedMatmul(jplan, "fused")(jnp.asarray(A), jnp.asarray(B),
                                                      erased=erased))
        for backend in ("fused", "reference"):
            C = CodedMatmul(plan, backend, device="cpu")(A, B, erased=erased)
            assert C.dtype == torch.float64
            np.testing.assert_array_equal(_np(C), C_j)
    np.testing.assert_array_equal(C_j, A.T @ B)


@pytest.mark.parametrize("batched", ["both", "a_only"])
def test_batched_call_matches_jax(rng, batched):
    A, B, jplan, plan = _problem(rng, "bec", 2, 2, 2, 1, batch=(2, 3))
    if batched == "a_only":
        B = B[0, 0]
    C_j = np.asarray(JCodedMatmul(jplan, "fused")(jnp.asarray(A), jnp.asarray(B),
                                                  erased=[2]))
    C = _np(CodedMatmul(plan, device="cpu")(A, B, erased=[2]))
    assert C.shape == (2, 3, A.shape[-1], B.shape[-1])
    np.testing.assert_array_equal(C, C_j)


def test_float32_matches_jax(rng):
    A, B, jplan, plan = _problem(rng, "bec", 2, 2, 2, 1)
    C_j = np.asarray(JCodedMatmul(jplan, "fused", dtype=jnp.float32)(
        jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32), erased=[0]))
    C = CodedMatmul(plan, dtype=torch.float32, device="cpu")(A, B, erased=[0])
    assert C.dtype == torch.float32
    np.testing.assert_array_equal(_np(C), C_j)


def test_ragged_operands_pad_and_crop(rng):
    """v, r, t that the block grid does not divide are zero-padded, exactly."""
    A = rng.integers(-3, 4, size=(9, 7)).astype(np.float64)
    B = rng.integers(-3, 4, size=(9, 5)).astype(np.float64)
    kw = dict(K=6, L=9 * 9 + 1, points="chebyshev")
    C_j = np.asarray(JCodedMatmul(jmake_plan("bec", 2, 2, 2, **kw))(
        jnp.asarray(A), jnp.asarray(B), erased=[4]))
    C = _np(CodedMatmul(make_plan("bec", 2, 2, 2, **kw), device="cpu")(A, B, erased=[4]))
    np.testing.assert_array_equal(C, C_j)
    np.testing.assert_array_equal(C, A.T @ B)


def test_cache_counters_across_patterns(rng):
    """Builds stay flat and hits grow across new erasure patterns; each
    distinct mask factors one panel."""
    A, B, _, plan = _problem(rng, "bec", 2, 2, 2, 1)
    cm = CodedMatmul(plan, device="cpu")
    cm(A, B)
    assert cm.cache_info() == {"builds": 1, "hits": 0, "entries": 1, "panel_builds": 1}
    for i, erased in enumerate(([0], [1], [0, 1], [0], [])):
        cm(A, B, erased=erased)
        info = cm.cache_info()
        assert info["builds"] == 1 and info["hits"] == i + 1
    assert cm.cache_info()["panel_builds"] == 4
    cm(A, B, mask=torch.tensor([1.0, 1, 1, 1, 1, 0]))   # tensor mask: concrete
    assert cm.cache_info()["panel_builds"] == 5
    sibling = cm.with_backend("reference")
    sibling(A, B, erased=[0])
    assert sibling.cache_info()["builds"] == 2 and cm.cache_info()["builds"] == 2
    assert sibling.cache_info()["panel_builds"] == 5


def test_cache_group_shares_across_plans(rng):
    A, B, _, plan = _problem(rng, "bec", 2, 2, 2, 1)
    other = make_plan("polycode", 2, 2, 2, K=12, L=A.shape[0] * 9 + 1,
                      points="chebyshev")
    group = CacheGroup()
    a = CodedMatmul(plan, device="cpu", cache_group=group)
    b = CodedMatmul(other, device="cpu", cache_group=group)
    for cm in (a, b, a, b):
        np.testing.assert_array_equal(_np(cm(A, B, erased=[1])), A.T @ B)
    assert group.cache_info() == {"builds": 2, "hits": 2, "entries": 2,
                                  "panel_builds": 2, "plans": 2}
    assert plan_token(plan) == plan_token(make_plan(
        "bec", 2, 2, 2, K=plan.K, L=A.shape[0] * 9 + 1, points="chebyshev"))


def test_too_few_survivors_raises(rng):
    A, B, _, plan = _problem(rng, "bec", 2, 2, 2, 1)
    cm = CodedMatmul(plan, device="cpu")
    with pytest.raises(ValueError, match="undecodable"):
        cm(A, B, erased=[0, 1, 2])
    with pytest.raises(ValueError, match="contraction"):
        cm(A, B[:-1])


def test_default_device_is_the_card(rng):
    """Without a device the facade runs on CUDA; on a machine without a card
    it raises instead of falling back to the CPU."""
    plan = make_plan("bec", 2, 2, 2, K=6, L=100)
    if torch.cuda.is_available():
        assert CodedMatmul(plan).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CodedMatmul(plan)


@pytest.mark.parametrize("call", ["mesh", "decode_stage_partial", "unknown_kind"])
def test_unported_paths_raise(rng, call):
    """What the port refuses, as the reference package does: the mesh
    backend without a mesh, split-stage decode of partial specs, and
    pipeline kinds it does not know."""
    A, B, _, plan = _problem(rng, "bec", 2, 2, 2, 1)
    cm = CodedMatmul(plan, device="cpu")
    if call == "mesh":
        with pytest.raises(ValueError, match="requires a mesh"):
            CodedMatmul(plan, call, device="cpu")
    elif call == "decode_stage_partial":
        with pytest.raises(NotImplementedError, match="per-chunk panel"):
            cm.decode_stage(cm.worker_stage(A, B), (A.shape[1], B.shape[1]),
                            progress=np.ones(plan.K))
    else:
        for kind in (("partial",), ("chunked", 2), ("decode", 1)):
            with pytest.raises(ValueError, match="unknown pipeline kind"):
                cm._executor.make_pipeline(plan, kind, torch.float64)


@pytest.mark.parametrize("spec,kw", [
    (None, {}),
    ([1, 3], {}),
    (np.array([1.0, 0, 1, 1, 1, 0]), {}),
    (None, {"erased": [0, 5]}),
    (None, {"survivors": [0, 1, 2, 3]}),
    (None, {"mask": [0, 1, 1, 1, 1, 1]}),
])
def test_erasure_normalisation_matches_jax(spec, kw):
    got = ErasurePattern.normalize(6, spec, **kw)
    exp = JErasurePattern.normalize(6, spec, **kw)
    np.testing.assert_array_equal(got.mask, exp.mask)
    assert (got.kind, got.key, got.survivors, got.erased, got.n_survivors) == (
        exp.kind, exp.key, exp.survivors, exp.erased, exp.n_survivors)


def test_erasure_normalisation_errors():
    with pytest.raises(ValueError, match="only one"):
        ErasurePattern.normalize(4, [0], erased=[1])
    with pytest.raises(ValueError, match="duplicate"):
        ErasurePattern.from_erased(4, [1, 1])
    with pytest.raises(ValueError, match="out of range"):
        ErasurePattern.from_survivors(4, [4])
    with pytest.raises(ValueError, match="0 or 1"):
        ErasurePattern.from_mask(4, torch.tensor([1.0, 0.5, 1, 1]))
    with pytest.raises(ValueError, match="K=5"):
        ErasurePattern.normalize(4, ErasurePattern.all_alive(5))
    with pytest.raises(TypeError):
        ErasurePattern.normalize(4, "workers")
    assert ErasurePattern.normalize(4, torch.tensor([0, 1, 1, 1])).erased == (0,)


def test_fractional_mask_error_matches_reference():
    """A fractional completion vector passed as a mask is refused with the
    reference's whole message, guidance to ``progress=`` included."""
    mask = [1, 0.5, 1, 1]
    with pytest.raises(ValueError) as port:
        ErasurePattern.from_mask(4, mask)
    with pytest.raises(ValueError) as ref:
        JErasurePattern.from_mask(4, np.asarray(mask))
    assert str(port.value) == str(ref.value)
    assert "pass it as progress= with sub_tasks=Q" in str(port.value)


def test_cpu_path_launches_no_kernel(rng):
    A, B, _, plan = _problem(rng, "bec", 2, 2, 2, 1)
    ops.reset_launch_counts()
    for backend in ("fused", "staged"):
        cm = CodedMatmul(plan, backend, device="cpu")
        cm(A, B, erased=[1])
        cm(A, B, progress=np.r_[0.5, np.ones(plan.K - 1)], sub_tasks=2)
    # the LM serving path with both scan kernels' fields on
    for arch in ("rwkv6_3b", "jamba_1_5_large_398b"):
        cfg = get_smoke_config(arch)
        cfg = dataclasses.replace(cfg, moe=None, rwkv_kernel=True, mamba_kernel=True,
                                  pattern=tuple((m, "mlp" if f == "moe" else f)
                                                for m, f in cfg.pattern))
        generate(cfg, init_params(cfg, device="cpu"), torch.zeros(1, 8, dtype=torch.long), 2)
    counts = ops.launch_counts()
    assert set(counts) == {"fused_worker", "decode", "decode_partial", "encode",
                           "matmul_t", "wkv_scan", "mamba_scan", ops.CLUSTER_LAUNCHES}
    assert all(n == 0 for n in counts.values()), counts


def test_port_imports_neither_jax_nor_repro():
    """The package, every module of it (the sharding rules, the parameter
    sharding, the abstract specs, the dry run and its accounting named),
    the smoke script's imports, the port's benches (the dry run's readers
    and the harness among them) and its examples pull in no JAX and nothing
    of the JAX package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
import repro_torch.distributed.sharding, repro_torch.distributed.param_sharding
import repro_torch.launch.specs
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
sys.path.insert(0, {root!r})
import chip_smoke
import benchmarks.torch_obs_util, benchmarks.torch_table1_error
import benchmarks.torch_fig1_latency, benchmarks.torch_tradeoff_sweep
import benchmarks.torch_control_bench, benchmarks.torch_serve_bench
import benchmarks.torch_fused_breakdown, benchmarks.torch_encode_breakdown
import benchmarks.torch_roofline, benchmarks.torch_report, benchmarks.torch_hillclimb
import benchmarks.torch_kernels_micro, benchmarks.torch_runtime_bench, benchmarks.torch_run
import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis
sys.path.insert(0, {examples!r})
import torch_quickstart, torch_serve_lm, torch_straggler_sim, torch_train_lm
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("clean", len([m for m in sys.modules if m.startswith("repro_torch")]))
""".format(root=str(ROOT), examples=str(ROOT / "examples"))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("clean")
