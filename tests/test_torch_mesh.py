"""The port's mesh backend on CPU ranks against the JAX package.

The port's mesh is multi-controller: ``launch/mesh.py::spawn_mesh`` starts
one process per rank over gloo, every rank makes the same facade call, and
each returns its C.  The parent computes the JAX package's reference-backend
C for the same (plan, A, B, erasure or progress) from the same numpy draws;
integer inputs within the plan's bounds decode EXACTLY in both packages, so
every rank's C must equal it bit for bit.  One case holds the port's mesh
against the JAX ``MeshExecutor`` itself, run in a child interpreter on 8
fake CPU devices as ``tests/test_mesh.py`` runs it.

The rank bodies are module-level functions (the ranks import this module
by name, without JAX), and each spawn runs once per module (a fixture),
its results read by many tests.  Every spawn has a deadline.
"""
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import make_plan
from repro_torch.distributed.coded import CodedLinearPlan, _quant_scale, coded_matmul_mesh
from repro_torch.kernels import _build
from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime import CodedMatmul

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120

# the binary cases: tests/test_mesh.py::TestCodedMesh and the runtime's
# mesh scenarios (tests/test_runtime.py), on a (2, 4) mesh
BIN_PLAN = dict(kind="bec", p=2, m=2, n=1, K=4, L=64 * 4 * 4 + 1, points="chebyshev")
ERASED = ([], [1], [0, 3])
SERVE_ERASED = ([0], [1], [2], [3], [1, 2])
FLAGS = [(True, True), (True, False), (False, True)]      # (use_kernels, fused)
FORMS = ("erased", "mask", "survivors")
# the partial cases: tests/test_mesh.py::TestMeshPartial at K = 7 for
# every scheme (one (1, 7) mesh), Q = 1, 2 and 4
SCHEMES = [("bec", 2, 2, 2, 1), ("tradeoff", 4, 2, 1, 2), ("polycode", 2, 2, 1, 1)]
PARTIAL_K = 7
QS = (1, 2, 4)
LIN_MASK = [1.0, 0.0, 1.0, 1.0]
MESH_PROGRESS = np.array([0.5, 0.5, 1.0, 1.0])      # Q = 2 on the (2, 4) mesh


def _binary_operands():
    rng = np.random.default_rng(0)
    return (rng.integers(-4, 5, size=(64, 48)).astype(np.float64),
            rng.integers(-4, 5, size=(64, 40)).astype(np.float64))


def _lin_operands():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(16, 32)).astype(np.float32),
            rng.normal(size=(32, 24)).astype(np.float32))


def _lin_plan(bits: int) -> dict:
    q = 2 ** (bits - 1)
    return dict(kind="bec", p=2, m=2, n=1, K=4, L=32 * q * q + 1, points="chebyshev")


def _partial_problem(kind, p, m, n, pp):
    rng = np.random.default_rng(SCHEMES.index((kind, p, m, n, pp)))
    v = 8 * p
    A = rng.integers(-3, 4, size=(v, 12)).astype(np.float64)
    B = rng.integers(-3, 4, size=(v, 10)).astype(np.float64)
    plan = dict(kind=kind, p=p, m=m, n=n, K=PARTIAL_K, L=v * 3 * 3 + 1, p_prime=pp)
    return A, B, plan


def _spanning(K: int, Q: int) -> np.ndarray:
    prog = np.ones(K)
    if Q == 1:
        prog[0] = 0.0
    else:
        prog[0] = prog[1] = (Q - 1) / Q
    return prog


def _np(x):
    return x.detach().cpu().numpy()


def _binary_rank(mesh) -> dict:
    """Every binary case on one rank of the (2, 4) mesh."""
    A, B = _binary_operands()
    plan = make_plan(**BIN_PLAN)
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    for uk, fused in FLAGS:
        cm = CodedMatmul(plan, "mesh", mesh=mesh, use_kernels=uk, fused=fused)
        for erased in ERASED:
            mask = np.ones(plan.K)
            mask[erased] = 0
            specs = {"erased": dict(erased=erased), "mask": dict(mask=mask),
                     "survivors": dict(survivors=np.flatnonzero(mask))}
            for form, spec in specs.items():
                out[(uk, fused, form, tuple(erased))] = _np(cm(A, B, **spec))
        out[(uk, fused, "transport")] = cm._executor.transport
        out[(uk, fused, "device")] = str(cm.device)
        out[(uk, fused, "partial")] = _np(cm(A, B, progress=MESH_PROGRESS, sub_tasks=2))
    # serving: one build, then five fresh patterns that only hit
    cm = CodedMatmul(plan, "mesh", mesh=mesh)
    cm(A, B)
    first = cm.cache_info()
    for erased in SERVE_ERASED:
        out[("serve", tuple(erased))] = _np(cm(A, B, erased=erased))
    out["serve_info"] = (first, cm.cache_info(), cm.executable_cache_size())
    batch = torch.stack([torch.as_tensor(A), torch.as_tensor(A) + 1])
    out["batched"] = _np(cm(batch, B, erased=[2]))
    sibling = cm.with_backend("reference")
    out["sibling"] = (sibling.backend, _np(sibling(A, B, erased=[1])), cm.cache_info())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        C = coded_matmul_mesh(A, B, plan, mesh, np.array(LIN_MASK), dtype=torch.float64)
    out["shim"] = (_np(C), [w.category.__name__ for w in caught])
    # CodedLinearPlan: 4-bit grid against the quantised product, 8-bit grid
    # against the float product, all-zero and tiny activations
    x, W = (torch.as_tensor(a) for a in _lin_operands())
    lin4 = CodedLinearPlan(make_plan(**_lin_plan(4)), mesh, quant_bits=4, dtype=torch.float64)
    out["lin4"] = _np(lin4(x, W, mask=torch.tensor(LIN_MASK)))
    lin8 = CodedLinearPlan(make_plan(**_lin_plan(8)), mesh, quant_bits=8, dtype=torch.float64)
    out["lin8"] = _np(lin8(x, W, mask=torch.tensor(LIN_MASK)))
    out["lin8_zero"] = _np(lin8(torch.zeros_like(x), W))
    out["lin8_tiny"] = _np(lin8(x * 1e-12, W))
    return out


def _partial_rank(mesh) -> dict:
    """Every partial case on one rank of the (1, 7) mesh."""
    out = {}
    for scheme in SCHEMES:
        A, B, kw = _partial_problem(*scheme)
        plan = make_plan(**kw)
        for uk in (True, False):
            cm = CodedMatmul(plan, "mesh", mesh=mesh, use_kernels=uk)
            for Q in QS:
                out[(scheme[0], uk, Q)] = _np(cm(A, B, progress=_spanning(plan.K, Q),
                                                 sub_tasks=Q))
            out[(scheme[0], uk, "binary")] = _np(cm(A, B, erased=[0]))
        # one build per Q, none on progress changes
        cm = CodedMatmul(plan, "mesh", mesh=mesh, use_kernels=False)
        for Q in (2, 4):
            for k in range(3):
                prog = np.ones(plan.K)
                prog[k] = (Q - 1) / Q
                cm(A, B, progress=prog, sub_tasks=Q)
        out[(scheme[0], "builds")] = cm.cache_info()
        bad = np.zeros(plan.K)
        bad[:plan.tau - 1] = 1.0
        try:
            cm(A, B, progress=bad, sub_tasks=2)
            out[(scheme[0], "span")] = None
        except ValueError as e:
            out[(scheme[0], "span")] = str(e)
    return out


def _spawn(fn, data, model):
    return mesh_mod.spawn_mesh(fn, data=data, model=model, device="cpu",
                               timeout_s=SPAWN_TIMEOUT_S)


BUILDS = []


@pytest.fixture(scope="module")
def binary_ranks():
    """The (2, 4) mesh's outputs, rank by rank, with `_build.build`
    patched to record its calls (a CPU mesh must make none)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "build", lambda *a, **k: BUILDS.append(a))
        return [out.result for out in _spawn(_binary_rank, 2, 4)]


@pytest.fixture(scope="module")
def partial_ranks():
    return [out.result for out in _spawn(_partial_rank, 1, PARTIAL_K)]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's reference-backend C, keyed like the rank outputs."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.core import make_plan as jmake_plan
    from repro.distributed.coded import _quant_scale as jquant_scale
    from repro.runtime import CodedMatmul as JCodedMatmul

    out = {}
    A, B = (jnp.asarray(a) for a in _binary_operands())
    jcm = JCodedMatmul(jmake_plan(**BIN_PLAN), "reference", dtype=jnp.float64)
    for erased in (*ERASED, *SERVE_ERASED):
        out[tuple(erased)] = np.asarray(jcm(A, B, erased=list(erased)))
    out["batched"] = np.asarray(jcm(jnp.stack([A, A + 1]), B, erased=[2]))
    for scheme in SCHEMES:
        a, b, kw = _partial_problem(*scheme)
        a, b = jnp.asarray(a), jnp.asarray(b)
        jp = JCodedMatmul(jmake_plan(**kw), "reference", dtype=jnp.float64)
        for Q in QS:
            out[(scheme[0], Q)] = np.asarray(jp(a, b, progress=_spanning(PARTIAL_K, Q),
                                                sub_tasks=Q))
        out[(scheme[0], "binary")] = np.asarray(jp(a, b, erased=[0]))
        bad = np.zeros(PARTIAL_K)
        bad[:jp.plan.tau - 1] = 1.0
        with pytest.raises(ValueError) as err:
            jp(a, b, progress=bad, sub_tasks=2)
        out[(scheme[0], "span")] = str(err.value)
    x, W = (jnp.asarray(a) for a in _lin_operands())
    for bits in (4, 8):
        qmax = 2 ** (bits - 1) - 1
        sx, sw = jquant_scale(x, qmax), jquant_scale(W, qmax)
        out[("lin", bits)] = (np.asarray(x @ W), float(sx), float(sw), qmax)
    # the quantised reference of tests/test_mesh.py (its +1e-9 epsilon)
    sx = float(jnp.max(jnp.abs(x))) / 7 + 1e-9
    sw = float(jnp.max(jnp.abs(W))) / 7 + 1e-9
    out["lin4_quantised"] = np.asarray((jnp.round(x / sx) @ jnp.round(W / sw)) * (sx * sw))
    return out


# -- binary: bec on a (2, 4) mesh ---------------------------------------------


@pytest.mark.parametrize("erased", ERASED, ids=str)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("uk,fused", FLAGS)
def test_binary_equals_jax_reference(binary_ranks, jax_ref, erased, form, uk, fused):
    """Every rank's C equals the JAX reference backend's, bit for bit, for
    every erasure input form and worker-product path."""
    want = jax_ref[tuple(erased)]
    np.testing.assert_array_equal(want, _binary_operands()[0].T @ _binary_operands()[1])
    for rank in binary_ranks:
        np.testing.assert_array_equal(rank[(uk, fused, form, tuple(erased))], want)


def test_ranks_know_their_coordinates(binary_ranks):
    assert [r["coords"] for r in binary_ranks] == [(d, k) for d in range(2) for k in range(4)]
    for r in binary_ranks:
        assert r[(True, True, "transport")] == "gloo, host tensors"
        assert r[(True, True, "device")] == "cpu"


def test_serving_builds_once_and_hits(binary_ranks, jax_ref):
    """One build, then five fresh patterns that only hit the memo."""
    for rank in binary_ranks:
        first, info, size = rank["serve_info"]
        assert first["builds"] == 1 and first["hits"] == 0
        assert info["builds"] == 1 and info["hits"] == 5, info
        assert size == 1
        for erased in SERVE_ERASED:
            np.testing.assert_array_equal(rank[("serve", tuple(erased))], jax_ref[tuple(erased)])


def test_batched_operand(binary_ranks, jax_ref):
    for rank in binary_ranks:
        assert rank["batched"].shape == (2, 48, 40)
        np.testing.assert_array_equal(rank["batched"], jax_ref["batched"])


def test_with_backend_shares_the_caches(binary_ranks, jax_ref):
    for rank in binary_ranks:
        name, C, info = rank["sibling"]
        assert name == "reference"
        np.testing.assert_array_equal(C, jax_ref[(1,)])
        # unbatched, batched, then the sibling's pipeline in the shared memo
        assert info["builds"] == 3, info


def test_coded_matmul_mesh_shim(binary_ranks, jax_ref):
    for rank in binary_ranks:
        C, caught = rank["shim"]
        assert "DeprecationWarning" in caught
        np.testing.assert_array_equal(C, jax_ref[(1,)])


# -- partial: three schemes on a (1, 7) mesh ------------------------------------


@pytest.mark.parametrize("Q", QS)
@pytest.mark.parametrize("uk", [True, False])
@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s[0])
def test_partial_equals_jax_reference(partial_ranks, jax_ref, scheme, uk, Q):
    A, B, _ = _partial_problem(*scheme)
    want = jax_ref[(scheme[0], Q)]
    np.testing.assert_array_equal(want, A.T @ B)
    for rank in partial_ranks:
        np.testing.assert_array_equal(rank[(scheme[0], uk, Q)], want)


@pytest.mark.parametrize("uk", [True, False])
@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s[0])
def test_q1_partial_is_the_binary_path(partial_ranks, jax_ref, scheme, uk):
    for rank in partial_ranks:
        np.testing.assert_array_equal(rank[(scheme[0], uk, 1)], rank[(scheme[0], uk, "binary")])
        np.testing.assert_array_equal(rank[(scheme[0], uk, "binary")],
                                      jax_ref[(scheme[0], "binary")])


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s[0])
def test_one_build_per_q_none_on_progress(partial_ranks, scheme):
    for rank in partial_ranks:
        info = rank[(scheme[0], "builds")]
        assert info["builds"] == 2 and info["hits"] == 4, info


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s[0])
def test_non_spanning_progress_raises_like_reference(partial_ranks, jax_ref, scheme):
    assert "span" in jax_ref[(scheme[0], "span")]
    for rank in partial_ranks:
        assert rank[(scheme[0], "span")] is not None
        assert "span" in rank[(scheme[0], "span")]


# -- CodedLinearPlan -------------------------------------------------------------


def test_coded_linear_quantised_grid(binary_ranks, jax_ref):
    """4-bit grid with a lost worker: the quantised reference within 1e-6."""
    for rank in binary_ranks:
        assert float(np.max(np.abs(rank["lin4"] - jax_ref["lin4_quantised"]))) < 1e-6


def test_coded_linear_float_bound(binary_ranks, jax_ref):
    """8-bit grid: within the quantisation bound of the float product."""
    y_float, sx, sw, qmax = jax_ref[("lin", 8)]
    x, W = _lin_operands()
    d = x.shape[1]
    bound = d * (sx / 2 * np.abs(W).max() + sw / 2 * np.abs(x).max() + sx * sw / 4)
    for rank in binary_ranks:
        err = float(np.max(np.abs(rank["lin8"] - y_float)))
        assert err <= bound, (err, bound)
        assert err / float(np.max(np.abs(y_float))) < 0.05


def test_coded_linear_zero_and_tiny(binary_ranks, jax_ref):
    y_float = jax_ref[("lin", 8)][0]
    for rank in binary_ranks:
        assert float(np.max(np.abs(rank["lin8_zero"]))) == 0.0
        rel = np.max(np.abs(rank["lin8_tiny"] - y_float * 1e-12)) / np.max(
            np.abs(y_float * 1e-12))
        assert rel < 0.05, rel


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_scale_matches_reference(jax_ref, bits):
    x, W = _lin_operands()
    _, sx, sw, qmax = jax_ref[("lin", bits)]
    assert float(_quant_scale(torch.as_tensor(x), qmax)) == sx
    assert float(_quant_scale(torch.as_tensor(W), qmax)) == sw


def test_quant_scale_guards():
    assert float(_quant_scale(torch.zeros((4, 4)), 7)) == 1.0
    x = torch.full((4, 4), 1e-12)
    s = _quant_scale(x, 7)
    assert float(torch.round(x / s).max()) == 7


# -- the JAX MeshExecutor itself ----------------------------------------------

_JAX_MESH_CHILD = """
import sys
import jax; jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from repro.core import make_plan
from repro.runtime import CodedMatmul, MeshExecutor
rng = np.random.default_rng(0)
A = jnp.asarray(rng.integers(-4, 5, size=(64, 48)), jnp.float64)
B = jnp.asarray(rng.integers(-4, 5, size=(64, 40)), jnp.float64)
plan = make_plan("bec", 2, 2, 1, K=4, L=64*4*4+1, points="chebyshev")
mesh = jax.make_mesh((2, 4), ("data", "model"))
cm = CodedMatmul(plan, MeshExecutor(mesh, use_kernels=False), dtype=jnp.float64)
out = {str(e): np.asarray(cm(A, B, erased=e)) for e in ([], [1], [0, 3])}
out["partial"] = np.asarray(cm(A, B, progress=np.r_[0.5, 0.5, 1, 1], sub_tasks=2))
np.savez(sys.argv[1], **out)
"""


def test_equals_the_jax_mesh_executor(binary_ranks, tmp_path):
    """The JAX MeshExecutor on 8 fake devices (use_kernels=False) and the
    port's (2, 4) CPU mesh give the same C, binary and partial."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    path = tmp_path / "jax_mesh.npz"
    proc = subprocess.run([sys.executable, "-c", _JAX_MESH_CHILD, str(path)], env=env,
                          capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    want = np.load(path)
    for rank in binary_ranks:
        for erased in ERASED:
            np.testing.assert_array_equal(rank[(False, True, "erased", tuple(erased))],
                                          want[str(erased)])
        for uk, fused in FLAGS:
            np.testing.assert_array_equal(rank[(uk, fused, "partial")], want["partial"])


# -- refusals, on a one-rank group ------------------------------------------------


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A one-rank gloo group and its ("model",) mesh in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_serves(one_rank_mesh):
    plan = make_plan("bec", 1, 1, 1, K=1, L=4 * 9 + 1, points="chebyshev")
    A = np.arange(12.0).reshape(4, 3) % 4
    C = CodedMatmul(plan, "mesh", mesh=one_rank_mesh)(A, A)
    np.testing.assert_array_equal(_np(C), A.T @ A)


@pytest.mark.parametrize("stage", ["worker_stage", "decode_stage"])
def test_split_stages_refused(one_rank_mesh, stage):
    plan = make_plan("bec", 1, 1, 1, K=1, L=100, points="chebyshev")
    cm = CodedMatmul(plan, "mesh", mesh=one_rank_mesh)
    A = np.ones((4, 3))
    with pytest.raises(NotImplementedError, match="split-stage"):
        if stage == "worker_stage":
            cm.worker_stage(A, A)
        else:
            cm.decode_stage(np.ones((1, 3, 3)), (3, 3))


@pytest.mark.parametrize("kind", [("chunked", 2), ("partial",)], ids=str)
def test_unknown_kind_refused(one_rank_mesh, kind):
    plan = make_plan("bec", 1, 1, 1, K=1, L=100, points="chebyshev")
    cm = CodedMatmul(plan, "mesh", mesh=one_rank_mesh)
    with pytest.raises(ValueError, match="unknown mesh pipeline kind"):
        cm._executor.make_pipeline(plan, kind, torch.float64)


def test_axis_size_mismatch_refused(one_rank_mesh):
    plan = make_plan(**BIN_PLAN)
    A, B = _binary_operands()
    with pytest.raises(ValueError, match="mesh axis"):
        CodedMatmul(plan, "mesh", mesh=one_rank_mesh)(A, B)
    with pytest.raises(ValueError, match="mesh axis"):
        CodedMatmul(make_plan("bec", 1, 1, 1, K=1, L=100), "mesh", mesh=one_rank_mesh,
                    axis="data")(A, B)


def test_complex_plan_refused(one_rank_mesh):
    plan = make_plan("bec", 1, 1, 1, K=1, L=100, points="unit_circle")
    with pytest.raises(ValueError, match="complex"):
        CodedMatmul(plan, "mesh", mesh=one_rank_mesh)(np.ones((4, 3)), np.ones((4, 3)))


def test_cache_token_folds_in_the_mesh_and_flags(one_rank_mesh):
    from repro_torch.runtime import resolve_executor

    tokens = {resolve_executor("mesh", mesh=one_rank_mesh, use_kernels=uk,
                               fused=f).cache_token() for uk, f in FLAGS}
    assert len(tokens) == 3
    assert all(t[0] == "mesh" and t[1] is one_rank_mesh for t in tokens)


def test_meshes_check_the_world_size(one_rank_mesh):
    with pytest.raises(ValueError, match="needs 8 ranks"):
        mesh_mod.make_debug_mesh(2, 4, device_type="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh_mod.make_production_mesh(device_type="cpu")
    mesh = mesh_mod.make_debug_mesh(1, 1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")


def test_cpu_spawn_never_builds(binary_ranks):
    assert len(binary_ranks) == 8 and BUILDS == []


def test_card_spawn_builds_once_before_the_ranks(monkeypatch):
    """On a card the parent builds every library, then starts the ranks
    (which then never run nvcc side by side)."""
    events = []

    class Started(Exception):
        pass

    def start(*args, **kwargs):
        events.append("start")
        raise Started

    monkeypatch.setattr(_build, "build", lambda *a, **k: events.append("build"))
    monkeypatch.setattr(mesh_mod.mp, "start_processes", start)
    with pytest.raises(Started):
        mesh_mod.spawn_mesh(_failing_rank, data=1, model=2, device=torch.device("cuda"),
                            timeout_s=1)
    assert events == ["build", "start"]


def test_spawn_raises_a_rank_failure():
    """A rank's exception reaches the parent at once; the rank still busy
    is stopped, long before its 60 s of work end."""
    start = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_mod.spawn_mesh(_failing_rank, data=1, model=2, device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S)
    assert time.monotonic() - start < 50


def test_spawn_deadline():
    with pytest.raises(TimeoutError, match="did not finish within 3 s"):
        mesh_mod.spawn_mesh(_failing_rank, data=1, model=1, device="cpu", timeout_s=3)


def _failing_rank(mesh):
    if mesh.get_local_rank("model") == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(60)


def test_runtime_facade_memo_keys_the_mesh(one_rank_mesh):
    from repro_torch.core.api import runtime_facade

    plan = make_plan("bec", 1, 1, 1, K=1, L=100)
    a = runtime_facade(plan, "mesh", mesh=one_rank_mesh)
    assert a is runtime_facade(plan, "mesh", mesh=one_rank_mesh)
    assert a is not runtime_facade(plan, "mesh", mesh=one_rank_mesh, use_kernels=False)
    assert a.device == torch.device("cpu") and a.backend == "mesh"


def test_ranks_import_no_jax():
    """The ranks import this module by name: its top imports no JAX."""
    head = Path(__file__).read_text().split("def _binary_operands")[0]
    assert "import jax" not in head and "from repro." not in head
