"""The port's traced erasure kinds ("traced", ("decode-traced", r, t),
("partial-traced", Q)) on the CPU, against the JAX package's jit-traced
calls.

A mask or progress tensor that the host must not read - here an input of a
``make_fx`` trace - takes the traced kinds: the reference backend solves the
masked normal equations in the body, the kernel backends (their plain
versions here) build the decode panel on the device.  The traced graph, run
on real tensors, must give the JAX package's ``jax.jit`` result and the
port's concrete result element for element (integer inputs within the
plan's bounds decode exactly in both packages).  The mesh's traced kinds
run on gloo ranks, spawned once for the module; the ranks import this
module by name, so JAX is imported only inside the fixtures.
"""
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch import obs
from repro_torch.core import make_plan
from repro_torch.core.api import PlanTables
from repro_torch.core.decoding import make_decode_panel, masked_panel
from repro_torch.core.schemes import make_scheme
from repro_torch.kernels import coded_fused
from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime import CodedMatmul, ErasurePattern, PartialPattern
from repro_torch.runtime.partial import chunk_masks_for, chunk_masks_traced

BACKENDS = ("reference", "staged", "fused")
# (kind, p, m, n, p_prime): one geometry per scheme family, as tests/test_runtime.py
SCHEMES = [("bec", 2, 2, 2, 1), ("tradeoff", 4, 2, 1, 2), ("polycode", 2, 2, 1, 1)]
QS = (2, 4)
SPAWN_TIMEOUT_S = 120
# the mesh cases: bec on a (1, 4) mesh of gloo ranks
MESH_PLAN = dict(kind="bec", p=2, m=2, n=1, K=4, L=64 * 4 * 4 + 1, points="chebyshev")
MESH_ERASED = ([], [1], [0, 3])
MESH_PROGRESS = np.array([0.5, 0.5, 1.0, 1.0])          # Q = 2
MESH_FLAGS = [(True, True), (True, False), (False, True)]  # (use_kernels, fused)


def _plan_kw(kind, p, m, n, pp):
    tau = make_scheme(kind, p, m, n, p_prime=pp).tau
    v = 8 * p
    return dict(kind=kind, p=p, m=m, n=n, K=tau + 2, L=v * 3 * 3 + 1, p_prime=pp,
                points="chebyshev"), v


def _problem(scheme, seed=0):
    kw, v = _plan_kw(*scheme)
    rng = np.random.default_rng(seed)
    A = rng.integers(-3, 4, size=(v, 12)).astype(np.float64)
    B = rng.integers(-3, 4, size=(v, 10)).astype(np.float64)
    return A, B, kw


def _masks(K):
    """All alive, two erasures apart, and the last two erased (K = tau + 2)."""
    out = []
    for erased in ([], [1, K - 1], [K - 2, K - 1]):
        mask = np.ones(K)
        mask[erased] = 0
        out.append(mask)
    return out


def _spanning(K, Q):
    prog = np.ones(K)
    prog[0] = prog[1] = (Q - 1) / Q
    return prog


def _jax_cm(kw, backend):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.core import make_plan as jmake_plan
    from repro.runtime import CodedMatmul as JCodedMatmul

    return JCodedMatmul(jmake_plan(**kw), backend, dtype=jnp.float64), jax, jnp


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _trace(fn, *args):
    return make_fx(fn, tracing_mode="fake")(*(_t(a) for a in args))


# -- the kind ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fake", "real"])
def test_traced_mask_detected_under_make_fx(mode):
    """Inside a trace the mask is a traced pattern, whose host views raise,
    as tests/test_runtime.py::test_traced_mask_detected_under_jit holds."""
    seen = {}

    def probe(m):
        seen["pat"] = ErasurePattern.normalize(4, mask=m)
        seen["spec"] = ErasurePattern.normalize(4, m)
        return m + 0

    make_fx(probe, tracing_mode=mode)(torch.ones(4))
    for pat in (seen["pat"], seen["spec"]):
        assert pat.kind == "traced" and not pat.is_concrete
        assert pat.key == ("traced",)
        for view in ("survivors", "erased", "n_survivors"):
            with pytest.raises(ValueError, match="traced"):
                getattr(pat, view)


@pytest.mark.parametrize("mode", ["fake", "real"])
def test_traced_progress_detected_under_make_fx(mode):
    seen = {}

    def probe(w):
        seen["pat"] = PartialPattern.from_progress(4, 2, w)
        seen["lift"] = PartialPattern.from_erasure(ErasurePattern.from_mask(4, w), 2)
        return w + 0

    make_fx(probe, tracing_mode=mode)(torch.ones(4))
    for pat in (seen["pat"], seen["lift"]):
        assert pat.kind == "traced" and pat.key == (2, "traced")
        for view in ("chunk_counts", "chunk_masks", "coverage"):
            with pytest.raises(ValueError, match="traced"):
                getattr(pat, view)


def test_eager_and_closed_over_tensors_stay_concrete():
    """A plain tensor is read to the host: concrete, keyed by its support,
    also when a trace closes over it (read with the trace's modes off)."""
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    pat = ErasurePattern.normalize(4, mask=mask)
    assert pat.kind == "concrete" and pat.key == (1, 0, 1, 1) and pat.erased == (1,)
    seen = {}

    def probe(a):
        seen["pat"] = ErasurePattern.normalize(4, mask=mask)
        return a + 1

    make_fx(probe, tracing_mode="fake")(torch.ones(3))
    assert seen["pat"].kind == "concrete" and seen["pat"].survivors == (0, 2, 3)


def test_traced_shapes_are_checked():
    def probe(m):
        with pytest.raises(ValueError, match=r"traced mask shape \(3,\)"):
            ErasurePattern.normalize(4, mask=m)
        with pytest.raises(ValueError, match=r"traced progress shape \(3,\)"):
            PartialPattern.from_progress(4, 2, m)
        return m

    make_fx(probe, tracing_mode="fake")(torch.ones(3))


# -- the traced graphs against the JAX package's jit ---------------------------


@pytest.fixture(scope="module")
def jax_masks():
    """JAX's jit-traced C for every (scheme, backend, mask), from one jit per
    (scheme, backend)."""
    out = {}
    for scheme in SCHEMES:
        A, B, kw = _problem(scheme)
        for backend in BACKENDS:
            jcm, jax, jnp = _jax_cm(kw, backend)
            f = jax.jit(lambda a, b, m: jcm(a, b, mask=m))
            for i, mask in enumerate(_masks(kw["K"])):
                out[(scheme[0], backend, i)] = np.asarray(
                    f(jnp.asarray(A), jnp.asarray(B), jnp.asarray(mask)))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s[0])
def test_traced_mask_graph_equals_jax_jit(jax_masks, scheme, backend):
    """One make_fx graph of ``cm(a, b, mask=m)`` serves every mask: each
    equals the JAX jit result, the port's concrete C and A^T B."""
    A, B, kw = _problem(scheme)
    cm = CodedMatmul(make_plan(**kw), backend, device="cpu")
    graph = _trace(lambda a, b, m: cm(a, b, mask=m), A, B, np.ones(kw["K"]))
    for i, mask in enumerate(_masks(kw["K"])):
        got = graph(_t(A), _t(B), _t(mask)).numpy()
        np.testing.assert_array_equal(got, A.T @ B)
        np.testing.assert_array_equal(got, jax_masks[(scheme[0], backend, i)])
        np.testing.assert_array_equal(got, cm(A, B, mask=mask).numpy())
    assert cm.cache_info()["panel_builds"] == len(_masks(kw["K"]))   # concrete only


@pytest.fixture(scope="module")
def jax_progress():
    """JAX's jit-traced C for every (scheme, backend, Q) on a spanning
    progress vector."""
    out = {}
    for scheme in SCHEMES:
        A, B, kw = _problem(scheme, seed=1)
        for backend in BACKENDS:
            jcm, jax, jnp = _jax_cm(kw, backend)
            for Q in QS:
                f = jax.jit(lambda a, b, w, Q=Q: jcm(a, b, progress=w, sub_tasks=Q))
                out[(scheme[0], backend, Q)] = np.asarray(
                    f(jnp.asarray(A), jnp.asarray(B), jnp.asarray(_spanning(kw["K"], Q))))
    return out


@pytest.mark.parametrize("Q", QS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s[0])
def test_traced_progress_graph_equals_jax_jit(jax_progress, scheme, backend, Q):
    """The ("partial-traced", Q) graph: the chunk masks and their panels are
    built from the progress tensor inside the graph."""
    A, B, kw = _problem(scheme, seed=1)
    cm = CodedMatmul(make_plan(**kw), backend, device="cpu")
    graph = _trace(lambda a, b, w: cm(a, b, progress=w, sub_tasks=Q), A, B, np.ones(kw["K"]))
    prog = _spanning(kw["K"], Q)
    got = graph(_t(A), _t(B), _t(prog)).numpy()
    np.testing.assert_array_equal(got, A.T @ B)
    np.testing.assert_array_equal(got, jax_progress[(scheme[0], backend, Q)])
    np.testing.assert_array_equal(got, cm(A, B, progress=prog, sub_tasks=Q).numpy())
    # a second progress vector through the same graph
    prog2 = np.ones(kw["K"])
    prog2[2] = (Q - 1) / Q
    np.testing.assert_array_equal(graph(_t(A), _t(B), _t(prog2)).numpy(), A.T @ B)


@pytest.mark.parametrize("backend", BACKENDS)
def test_traced_decode_stage_equals_jax_jit(backend):
    """worker_stage, then a make_fx graph of decode_stage with the mask as
    input (("decode-traced", r, t)) against the JAX jit of the same."""
    A, B, kw = _problem(SCHEMES[0], seed=2)
    cm = CodedMatmul(make_plan(**kw), backend, device="cpu")
    Y = cm.worker_stage(A, B)
    rt = (A.shape[1], B.shape[1])
    graph = make_fx(lambda y, m: cm.decode_stage(y, rt, mask=m),
                    tracing_mode="fake")(Y, _t(np.ones(kw["K"])))
    jcm, jax, jnp = _jax_cm(kw, backend)
    jY = jcm.worker_stage(jnp.asarray(A), jnp.asarray(B))
    f = jax.jit(lambda y, m: jcm.decode_stage(y, rt, mask=m))
    for mask in _masks(kw["K"]):
        got = graph(Y, _t(mask)).numpy()
        np.testing.assert_array_equal(got, A.T @ B)
        np.testing.assert_array_equal(got, np.asarray(f(jY, jnp.asarray(mask))))
        np.testing.assert_array_equal(got, cm.decode_stage(Y, rt, mask=mask).numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_dynamic_mask_graph_solves_and_closed_over_mask_does_not(backend):
    """The twin of tests/test_fused.py's jaxpr check: a concrete mask closed
    over from outside the trace decodes with its host panel (no solve in
    the graph); a traced mask solves in the graph."""
    A, B, kw = _problem(SCHEMES[0])
    cm = CodedMatmul(make_plan(**kw), backend, device="cpu")
    mfix = _t(_masks(kw["K"])[1])
    fixed = _trace(lambda a, b: cm(a, b, mask=mfix), A, B)
    dynamic = _trace(lambda a, b, m: cm(a, b, mask=m), A, B, mfix)
    assert "solve" not in fixed.code and "lu_factor" not in fixed.code
    assert "linalg_solve_ex" in dynamic.code
    np.testing.assert_array_equal(fixed(_t(A), _t(B)).numpy(), A.T @ B)
    np.testing.assert_array_equal(dynamic(_t(A), _t(B), mfix).numpy(), A.T @ B)


# -- the facade's traced path ------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_traced_patterns_share_one_pipeline_and_no_panel(backend):
    """Traced patterns made directly (as a trace would make them) run
    eagerly: one pipeline per kind, every later pattern a memo hit, and
    the panel cache untouched."""
    A, B, kw = _problem(SCHEMES[0], seed=3)
    K = kw["K"]
    cm = CodedMatmul(make_plan(**kw), backend, device="cpu")
    for mask in _masks(K):
        C = cm(A, B, ErasurePattern(K, "traced", _t(mask)))
        np.testing.assert_array_equal(C.numpy(), A.T @ B)
    for Q in QS:
        C = cm(A, B, PartialPattern(K, Q, "traced", _t(_spanning(K, Q))))
        np.testing.assert_array_equal(C.numpy(), A.T @ B)
    assert cm.cache_info() == {"builds": 3, "hits": 2, "entries": 3, "panel_builds": 0}


def test_traced_mask_skips_the_survivor_check():
    """As in the reference: too few survivors under a traced mask give a
    wrong C, not an error (the check would read the mask); concrete ones
    raise."""
    A, B, kw = _problem(SCHEMES[0])
    K = kw["K"]
    tau = make_scheme("bec", 2, 2, 2).tau
    mask = np.zeros(K)
    mask[:tau - 1] = 1
    cm = CodedMatmul(make_plan(**kw), "fused", device="cpu")
    C = cm(A, B, ErasurePattern(K, "traced", _t(mask)))
    assert C.shape == (12, 10) and not np.array_equal(C.numpy(), A.T @ B)
    with pytest.raises(ValueError, match="undecodable"):
        cm(A, B, mask=mask)


def test_ridge_is_part_of_the_traced_pipeline():
    """Facades sharing a memo with different ridges build their own traced
    pipelines, and one ridge's panel is the host panel of that ridge."""
    A, B, kw = _problem(SCHEMES[0])
    plan = make_plan(**kw)
    cm0 = CodedMatmul(plan, device="cpu")
    cm1 = CodedMatmul(plan, device="cpu", panel_ridge=1e-12,
                      _shared=(plan.make_panel_cache(1e-12), cm0._executables, cm0._stats))
    traced = ErasurePattern(plan.K, "traced", _t(np.ones(plan.K)))
    np.testing.assert_array_equal(cm0(A, B, traced).numpy(), A.T @ B)
    np.testing.assert_array_equal(cm1(A, B, traced).numpy(), A.T @ B)
    assert cm0.cache_info()["builds"] == 2
    mask = _masks(plan.K)[1]
    W = masked_panel(plan.scheme, _t(plan.z_points), _t(mask), ridge=1e-3)
    W_host = make_decode_panel(plan.scheme, plan.z_points, mask, ridge=1e-3).W
    np.testing.assert_allclose(W.numpy(), W_host, rtol=0, atol=1e-12)


def test_make_pipeline_builds_every_traced_kind():
    A, B, kw = _problem(SCHEMES[0])
    plan = make_plan(**kw)
    a, b = _t(A), _t(B)
    mask = _t(_masks(plan.K)[1])
    for backend in BACKENDS:
        ex = CodedMatmul(plan, backend, device="cpu")._executor
        C = ex.make_pipeline(plan, "traced", torch.float64)(a, b, mask)
        Cp = ex.make_pipeline(plan, ("partial-traced", 2), torch.float64)(
            a, b, _t(_spanning(plan.K, 2)))
        Y = ex.make_pipeline(plan, "products", torch.float64)(a, b)
        Cd = ex.make_pipeline(plan, ("decode-traced", 12, 10), torch.float64)(Y, mask)
        for out in (C, Cp, Cd):
            np.testing.assert_array_equal(out.numpy(), A.T @ B)


# -- the pieces ----------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s[0])
def test_masked_panel_equals_the_host_panel(scheme):
    """The device panel is the host LU panel up to rounding, also each
    panel of a stack of masks."""
    _, _, kw = _problem(scheme)
    plan = make_plan(**kw)
    masks = np.stack(_masks(plan.K))
    stack = masked_panel(plan.scheme, _t(plan.z_points), _t(masks))
    assert stack.shape == (len(masks), plan.scheme.grid.m * plan.scheme.grid.n, plan.K)
    for mask, W in zip(masks, stack):
        host = make_decode_panel(plan.scheme, plan.z_points, mask).W
        np.testing.assert_allclose(W.numpy(), host, rtol=0, atol=1e-12)
        one = masked_panel(plan.scheme, _t(plan.z_points), _t(mask))
        np.testing.assert_allclose(one.numpy(), host, rtol=0, atol=1e-12)


@pytest.mark.parametrize("Q", [1, 2, 3, 4])
def test_chunk_masks_traced_equal_the_host_masks(Q):
    rng = np.random.default_rng(Q)
    for _ in range(5):
        counts = rng.integers(0, Q + 1, size=7)
        got = chunk_masks_traced(_t(counts / Q), Q)
        np.testing.assert_array_equal(got.numpy(), chunk_masks_for(counts, Q))


def test_plan_tables_upload_once_and_not_under_a_trace():
    plan = make_plan(**_problem(SCHEMES[0])[2])
    tables = PlanTables(plan)
    first = tables.get("coeff_a", torch.float64, "cpu")
    assert tables.get("coeff_a", torch.float64, "cpu") is first
    assert tables.get("coeff_a", torch.float32, "cpu") is not first
    np.testing.assert_array_equal(first.numpy(), plan.coeff_a)
    seen = []

    def probe(a):
        seen.append(tables.get("z_points", torch.float64, "cpu"))
        return a + seen[-1].sum()

    make_fx(probe, tracing_mode="fake")(torch.ones(2))
    assert len(tables._kept) == 2 and type(seen[0]) is not torch.Tensor


def test_device_offsets_are_kept():
    offsets = ((0, 7, 14), (3, 5))
    first = coded_fused.device_offsets(*offsets, device="cpu")
    assert coded_fused.device_offsets(*offsets, device="cpu") is first
    assert first.tolist() == [0, 7, 14, 3, 5]


def test_obs_counts_traced_kernel_calls_without_spans():
    """With obs on, a kernel call on fake tensors counts
    ``kernel.call{op, traced=1}`` and records no span; an eager call counts
    ``traced=0`` and records one."""
    A, B, kw = _problem(SCHEMES[0])
    cm = CodedMatmul(make_plan(**kw), "fused", device="cpu")
    obs.enable(fresh=True)
    try:
        _trace(lambda a, b, m: cm(a, b, mask=m), A, B, np.ones(kw["K"]))
        reg, rec = obs.session().registry, obs.session().recorder
        assert reg.value("kernel.call", op="fused_worker", traced=1) == 1
        assert reg.value("kernel.call", op="decode", traced=1) == 1
        assert not reg.value("kernel.call", op="fused_worker", traced=0)
        assert not rec.by_name("kernel.fused_worker") and not rec.by_name("kernel.decode")
        cm(A, B, mask=np.ones(kw["K"]))
        assert reg.value("kernel.call", op="fused_worker", traced=0) == 1
        assert len(rec.by_name("kernel.fused_worker")) == 1
    finally:
        obs.disable()


# -- the mesh: "traced" and ("partial-traced", Q) on gloo ranks ------------------


def _mesh_operands():
    rng = np.random.default_rng(4)
    return (rng.integers(-4, 5, size=(64, 48)).astype(np.float64),
            rng.integers(-4, 5, size=(64, 40)).astype(np.float64))


def _mesh_rank(mesh) -> dict:
    """Each traced request beside its concrete twin, on one rank of (1, 4)."""
    A, B = _mesh_operands()
    plan = make_plan(**MESH_PLAN)
    out = {}
    for uk, fused in MESH_FLAGS:
        cm = CodedMatmul(plan, "mesh", mesh=mesh, use_kernels=uk, fused=fused)
        for erased in MESH_ERASED:
            mask = np.ones(plan.K)
            mask[erased] = 0
            out[(uk, fused, tuple(erased))] = (
                cm(A, B, ErasurePattern(plan.K, "traced", _t(mask))).numpy(),
                cm(A, B, mask=mask).numpy())
        out[(uk, fused, "partial")] = (
            cm(A, B, PartialPattern(plan.K, 2, "traced", _t(MESH_PROGRESS))).numpy(),
            cm(A, B, progress=MESH_PROGRESS, sub_tasks=2).numpy())
        out[(uk, fused, "info")] = cm.cache_info()
    return out


@pytest.fixture(scope="module")
def mesh_ranks(monkeypatch_module):
    monkeypatch_module.setenv("OMP_NUM_THREADS", "2")
    return [r.result for r in mesh_mod.spawn_mesh(
        _mesh_rank, data=1, model=4, device="cpu", timeout_s=SPAWN_TIMEOUT_S)]


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("case", [*(tuple(e) for e in MESH_ERASED), "partial"], ids=str)
@pytest.mark.parametrize("uk,fused", MESH_FLAGS)
def test_mesh_traced_kinds_equal_the_concrete_ones(mesh_ranks, uk, fused, case):
    A, B = _mesh_operands()
    assert len(mesh_ranks) == 4
    for rank in mesh_ranks:
        traced, concrete = rank[(uk, fused, case)]
        np.testing.assert_array_equal(traced, concrete)
        np.testing.assert_array_equal(traced, A.T @ B)
        # concrete binary, partial; traced, partial-traced: one pipeline each
        assert rank[(uk, fused, "info")]["builds"] == 4
