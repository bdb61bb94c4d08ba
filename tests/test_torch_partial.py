"""Partial stragglers, the staged backend and split stages: the port's
``CodedMatmul`` (on the CPU) against the JAX package's on the same inputs.

Integer inputs within the plan's bounds decode EXACTLY in both packages, so
every decoded product is compared element for element; the pattern types,
chunk schedule and panel stacks are host numpy and compared exactly too.
"""
import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.core import extend_plan as jextend_plan  # noqa: E402
from repro.core import make_plan as jmake_plan  # noqa: E402
from repro.runtime import CodedMatmul as JCodedMatmul  # noqa: E402
from repro.runtime import ErasurePattern as JErasurePattern  # noqa: E402
from repro.runtime import PartialPattern as JPartialPattern  # noqa: E402
from repro.runtime import partial as jpartial  # noqa: E402
from repro_torch.core import extend_plan, make_plan  # noqa: E402
from repro_torch.core.schemes import make_scheme  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    CodedMatmul,
    ErasurePattern,
    PartialPattern,
    chunk_bounds,
    chunk_coverage,
    chunk_masks_for,
)

BACKENDS = ("reference", "fused", "staged")
SCHEMES = [
    ("bec", 2, 2, 2, 1),
    ("tradeoff", 4, 2, 1, 2),
    ("polycode", 2, 2, 1, 1),
]
SUB_TASKS = (1, 2, 4)


def _np(x):
    return x.detach().cpu().numpy()


def _problem(rng, kind, p, m, n, pp, batch=()):
    """Integer operands and the same plan in both packages (K = tau + 2)."""
    v, r, t = 8 * p, 12, 10
    A = rng.integers(-3, 4, size=(*batch, v, r)).astype(np.float64)
    B = rng.integers(-3, 4, size=(*batch, v, t)).astype(np.float64)
    K = make_scheme(kind, p, m, n, p_prime=pp).tau + 2
    kw = dict(K=K, L=v * 3 * 3 + 1, p_prime=pp, points="chebyshev")
    return A, B, jmake_plan(kind, p, m, n, **kw), make_plan(kind, p, m, n, **kw)


def _spanning_progress(K, Q):
    """Workers 0 and 1 one chunk short (Q > 1) or worker 0 erased (Q = 1):
    with K = tau + 2 every chunk still has tau contributors."""
    prog = np.ones(K)
    if Q > 1:
        prog[[0, 1]] = (Q - 1) / Q
    else:
        prog[0] = 0.0
    return prog


def _jax_call(jplan, A, B, backend="reference", **kw):
    return np.asarray(JCodedMatmul(jplan, backend)(jnp.asarray(A), jnp.asarray(B), **kw))


# -- the chunk schedule -------------------------------------------------------

@pytest.mark.parametrize("rows,Q", [(8, 1), (8, 3), (9, 4), (30, 4), (12, 12)])
def test_chunk_bounds_match_jax(rows, Q):
    assert chunk_bounds(rows, Q) == jpartial.chunk_bounds(rows, Q)


@pytest.mark.parametrize("rows,Q", [(3, 4), (8, 0)])
def test_chunk_bounds_errors_match_jax(rows, Q):
    with pytest.raises(ValueError) as got:
        chunk_bounds(rows, Q)
    with pytest.raises(ValueError) as exp:
        jpartial.chunk_bounds(rows, Q)
    assert str(got.value) == str(exp.value)


def test_chunk_masks_and_coverage_match_jax(rng):
    for K, Q in ((7, 4), (6, 1), (10, 3), (5, 8)):
        counts = rng.integers(0, Q + 1, size=K)
        np.testing.assert_array_equal(chunk_masks_for(counts, Q),
                                      jpartial.chunk_masks_for(counts, Q))
        np.testing.assert_array_equal(chunk_coverage(counts, Q),
                                      jpartial.chunk_coverage(counts, Q))


# -- PartialPattern -----------------------------------------------------------

_K, _Q = 6, 3


@pytest.mark.parametrize("spec,kw", [
    (None, {}),
    (None, {"progress": [0.5, 1.0, 0.34, 0.0, 0.99, 1.0]}),
    ([0.2, 0.7, 1.0, 1.0, 0.0, 0.66], {}),
    (None, {"erased": [0, 4]}),
    (None, {"survivors": [1, 2, 3, 5]}),
    (None, {"mask": [0, 1, 1, 1, 0, 1]}),
    ("erasure", {}),
    ("partial", {}),
])
def test_partial_pattern_normalisation_matches_jax(spec, kw):
    def build(mod_partial, mod_erasure):
        if spec == "erasure":
            return mod_partial.normalize(_K, _Q, mod_erasure.normalize(_K, erased=[2]))
        if spec == "partial":
            return mod_partial.normalize(_K, _Q, mod_partial.from_progress(
                _K, 2, [0.5, 1, 1, 0, 1, 0.5]))
        return mod_partial.normalize(_K, _Q, spec, **kw)

    got = build(PartialPattern, ErasurePattern)
    exp = build(JPartialPattern, JErasurePattern)
    assert (got.K, got.Q, got.kind, got.key) == (exp.K, exp.Q, exp.kind, exp.key)
    np.testing.assert_array_equal(got.progress, exp.progress)
    np.testing.assert_array_equal(got.chunk_counts, exp.chunk_counts)
    np.testing.assert_array_equal(got.chunk_masks, exp.chunk_masks)
    np.testing.assert_array_equal(got.coverage, exp.coverage)
    assert [got.decodable(t) for t in range(1, _K + 1)] == \
        [exp.decodable(t) for t in range(1, _K + 1)]


def test_progress_tensor_is_read_to_host():
    prog = [0.5, 1.0, 0.0, 1.0]
    got = PartialPattern.from_progress(4, 2, torch.tensor(prog))
    exp = JPartialPattern.from_progress(4, 2, np.asarray(prog))
    assert got.key == exp.key and got.kind == "concrete"
    arr = got.progress_array(torch.float32, "cpu")
    assert arr.dtype == torch.float32 and arr.tolist() == prog


@pytest.mark.parametrize("case", [
    "progress_shape", "above_one", "negative", "nan", "q_zero", "k_mismatch",
    "conflicting", "not_spanning",
])
def test_partial_pattern_errors_match_jax(case):
    def run(P, E):
        if case == "progress_shape":
            P.from_progress(4, 2, np.ones(5))
        elif case == "above_one":
            P.from_progress(4, 2, [0.5, 1.0, 1.5, 0.0])
        elif case == "negative":
            P.from_progress(4, 2, [0.5, 1.0, -0.1, 0.0])
        elif case == "nan":
            P.from_progress(4, 2, [0.5, np.nan, 1.0, 0.0])
        elif case == "q_zero":
            P.full(4, 0)
        elif case == "k_mismatch":
            P.normalize(6, 2, P.full(4, 2))
        elif case == "conflicting":
            P.normalize(4, 2, np.ones(4), progress=np.ones(4))
        else:
            P.from_progress(4, 2, [0.5, 0.0, 0.5, 0.0]).require_decodable(2)

    with pytest.raises(ValueError) as got:
        run(PartialPattern, ErasurePattern)
    with pytest.raises(ValueError) as exp:
        run(JPartialPattern, JErasurePattern)
    assert str(got.value) == str(exp.value)


# -- panel stacks -------------------------------------------------------------

@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_get_partial_and_extended_match_jax(rng, kind, p, m, n, pp):
    _, _, jplan, plan = _problem(rng, kind, p, m, n, pp)
    jpc, pc = jplan.make_panel_cache(), plan.make_panel_cache()
    K, Q = plan.K, 4
    patterns = [np.full(K, Q), np.r_[Q - 1, Q - 1, np.full(K - 2, Q)],
                np.r_[0, 2, np.full(K - 2, Q)], np.r_[0, 0, np.full(K - 2, Q)]]
    for counts in patterns:
        cm = chunk_masks_for(counts, Q)
        got = pc.get_partial(cm)
        np.testing.assert_array_equal(got, jpc.get_partial(cm))
        assert got.shape == (Q, plan.scheme.grid.m * plan.scheme.grid.n, K)
        assert pc.get_partial(cm) is got                   # memoised
    assert pc.builds == jpc.builds
    with pytest.raises(ValueError, match="chunk_masks shape"):
        pc.get_partial(np.ones((Q, K + 1)))
    # a grown pool carries every stack across with zero columns, no builds
    z_new = np.asarray(jextend_plan(jplan, 2).z_points)
    np.testing.assert_array_equal(np.asarray(extend_plan(plan, 2).z_points), z_new)
    for g_z in (z_new, np.asarray(jplan.z_points)):
        got, exp = pc.extended(g_z), jpc.extended(g_z)
        assert got.builds == 0 and sorted(got._partial_stacks) == sorted(exp._partial_stacks)
        for key, stack in exp._partial_stacks.items():
            np.testing.assert_array_equal(got._partial_stacks[key], stack)


# -- the partial path end to end ----------------------------------------------

@pytest.mark.parametrize("Q", SUB_TASKS)
@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_partial_call_matches_jax(rng, kind, p, m, n, pp, Q):
    """Every local backend, spanning progress, element for element."""
    A, B, jplan, plan = _problem(rng, kind, p, m, n, pp)
    prog = _spanning_progress(plan.K, Q)
    exp = _jax_call(jplan, A, B, progress=prog, sub_tasks=Q)
    np.testing.assert_array_equal(exp, A.T @ B)
    for backend in BACKENDS:
        cm = CodedMatmul(plan, backend, device="cpu", sub_tasks=Q)
        np.testing.assert_array_equal(_np(cm(A, B, progress=prog)), exp,
                                      err_msg=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tight_and_fuzzed_progress_match_jax(rng, backend):
    """Coverage exactly tau in one chunk, and seeded random chunk counts:
    the port decodes what the reference decodes and raises where it does."""
    A, B, jplan, plan = _problem(rng, "bec", 2, 2, 2, 1)
    Q, K = 4, plan.K
    jcm = JCodedMatmul(jplan, "reference")
    cm = CodedMatmul(plan, backend, device="cpu")
    fuzz = np.random.default_rng(1234)
    progs = [np.r_[0.0, 0.75, np.ones(K - 2)]]
    progs += [fuzz.integers(0, Q + 1, size=K) / Q for _ in range(12)]
    decoded = failed = 0
    for prog in progs:
        if PartialPattern.from_progress(K, Q, prog).decodable(plan.tau):
            exp = np.asarray(jcm(jnp.asarray(A), jnp.asarray(B), progress=prog,
                                 sub_tasks=Q))
            np.testing.assert_array_equal(_np(cm(A, B, progress=prog, sub_tasks=Q)),
                                          exp)
            decoded += 1
        else:
            with pytest.raises(ValueError, match="does not span"):
                cm(A, B, progress=prog, sub_tasks=Q)
            failed += 1
    assert decoded > 1 and failed > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_non_spanning_progress_raises(rng, backend):
    A, B, _, plan = _problem(rng, "tradeoff", 4, 2, 1, 2)
    prog = np.zeros(plan.K)
    prog[: plan.tau - 1] = 1.0
    cm = CodedMatmul(plan, backend, device="cpu")
    with pytest.raises(ValueError, match="does not span"):
        cm(A, B, progress=prog, sub_tasks=2)
    with pytest.raises(ValueError, match="non-empty chunks"):
        cm(A, B, sub_tasks=A.shape[1] + 1)      # more chunks than block rows
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_q1_binary_spec_is_the_binary_path(rng, backend):
    """Q = 1 with a binary spec takes the binary pipeline; the same mask
    through the Q = 1 partial pipeline gives the same bits."""
    for kind, p, m, n, pp in SCHEMES:
        A, B, jplan, plan = _problem(rng, kind, p, m, n, pp)
        cm = CodedMatmul(plan, backend, device="cpu")
        mask = np.ones(plan.K)
        mask[[0, plan.K - 1]] = 0
        binary = _np(cm(A, B, mask=mask, sub_tasks=1))
        assert [key[-1] for key in cm._executables] == ["concrete"]
        partial = _np(cm(A, B, progress=mask, sub_tasks=1))
        assert [key[-1] for key in cm._executables] == ["concrete", ("partial", 1)]
        np.testing.assert_array_equal(partial, binary)
        np.testing.assert_array_equal(binary, _jax_call(jplan, A, B, mask=mask))


@pytest.mark.parametrize("batched", ["both", "a_only"])
def test_batched_partial_matches_jax(rng, batched):
    A, B, jplan, plan = _problem(rng, "bec", 2, 2, 2, 1, batch=(2, 3))
    if batched == "a_only":
        B = B[0, 0]
    prog = _spanning_progress(plan.K, 2)
    exp = _jax_call(jplan, A, B, progress=prog, sub_tasks=2)
    for backend in ("fused", "staged"):
        C = _np(CodedMatmul(plan, backend, device="cpu")(A, B, progress=prog,
                                                         sub_tasks=2))
        assert C.shape == (2, 3, A.shape[-1], B.shape[-1])
        np.testing.assert_array_equal(C, exp)


def test_partial_pipelines_build_once_per_q(rng):
    A, B, _, plan = _problem(rng, "bec", 2, 2, 2, 1)
    cm = CodedMatmul(plan, device="cpu", sub_tasks=2)
    K = plan.K
    for prog in (np.ones(K), _spanning_progress(K, 2), np.r_[0.5, 0.5, 0.5, np.ones(K - 3)]):
        np.testing.assert_array_equal(_np(cm(A, B, progress=prog)), A.T @ B)
    assert cm.cache_info()["builds"] == 1 and cm.cache_info()["hits"] == 2
    sibling = cm.with_backend("staged")
    assert sibling.sub_tasks == 2
    sibling(A, B, progress=np.ones(K))
    cm(A, B, PartialPattern.full(K, 4))                  # the pattern's own Q
    assert cm.cache_info()["builds"] == 3
    assert cm.panel_cache.get_partial(chunk_masks_for(np.full(K, 2), 2)) is \
        cm.panel_cache.get_partial(chunk_masks_for(np.full(K, 2), 2))
    with pytest.raises(ValueError, match="sub_tasks >= 1"):
        CodedMatmul(plan, device="cpu", sub_tasks=0)
    with pytest.raises(ValueError, match="sub_tasks >= 1"):
        cm(A, B, sub_tasks=0)


# -- the staged backend -------------------------------------------------------

@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_staged_every_erasure_pattern_matches_jax_staged(rng, kind, p, m, n, pp):
    """The port's staged backend against the JAX package's staged backend
    (Pallas in interpret mode), for erasures of size 0, 1 and 2."""
    A, B, jplan, plan = _problem(rng, kind, p, m, n, pp)
    jcm = JCodedMatmul(jplan, "staged")
    cm = CodedMatmul(plan, "staged", device="cpu")
    for erased in ([], [0], [plan.K - 1], [1, 3]):
        exp = np.asarray(jcm(jnp.asarray(A), jnp.asarray(B), erased=erased))
        np.testing.assert_array_equal(_np(cm(A, B, erased=erased)), exp)
        np.testing.assert_array_equal(exp, A.T @ B)
    assert cm.cache_info()["builds"] == 1


def test_staged_float32_and_unit_circle_match_jax(rng):
    """float32 on the staged backend; a complex (unit-circle) plan on the
    staged backend and through the per-chunk decode."""
    A, B, jplan, plan = _problem(rng, "bec", 2, 2, 2, 1)
    exp = np.asarray(JCodedMatmul(jplan, "staged", dtype=jnp.float32)(
        jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32), erased=[2]))
    C = CodedMatmul(plan, "staged", dtype=torch.float32, device="cpu")(A, B, erased=[2])
    assert C.dtype == torch.float32
    np.testing.assert_array_equal(_np(C), exp)
    kw = dict(K=plan.K, L=A.shape[0] * 9 + 1, points="unit_circle")
    jplan_c, plan_c = jmake_plan("bec", 2, 2, 2, **kw), make_plan("bec", 2, 2, 2, **kw)
    exp = _jax_call(jplan_c, A, B, "staged", erased=[1, 4])
    np.testing.assert_array_equal(
        _np(CodedMatmul(plan_c, "staged", device="cpu")(A, B, erased=[1, 4])), exp)
    prog = _spanning_progress(plan.K, 2)           # complex per-chunk decode
    exp = _jax_call(jplan_c, A, B, progress=prog, sub_tasks=2)
    np.testing.assert_array_equal(
        _np(CodedMatmul(plan_c, device="cpu")(A, B, progress=prog, sub_tasks=2)), exp)


# -- split stages --------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_split_stages_match_jax(rng, kind, p, m, n, pp, backend):
    """worker_stage gives JAX's products (to float rounding: the encode
    sums in another order); decode_stage of them equals JAX's and the
    one-shot call exactly."""
    A, B, jplan, plan = _problem(rng, kind, p, m, n, pp)
    jcm = JCodedMatmul(jplan, "reference")
    cm = CodedMatmul(plan, backend, device="cpu")
    Y = cm.worker_stage(A, B)
    Yj = np.asarray(jcm.worker_stage(jnp.asarray(A), jnp.asarray(B)))
    assert Y.shape == Yj.shape and Y.shape[0] == plan.K
    np.testing.assert_allclose(_np(Y), Yj, rtol=1e-12, atol=1e-12 * np.abs(Yj).max())
    Y0 = Y.clone()
    rt = (A.shape[1], B.shape[1])
    for erased in ([], [0, 2]):
        C = _np(cm.decode_stage(Y, rt, erased=erased))
        np.testing.assert_array_equal(C, np.asarray(jcm.decode_stage(Yj, rt, erased=erased)))
        np.testing.assert_array_equal(C, _np(cm(A, B, erased=erased)))
    assert torch.equal(Y, Y0)                     # the caller's products stay
    info = cm.cache_info()
    assert info["builds"] == 3 and info["entries"] == 3


def test_batched_split_stages_match_jax(rng):
    A, B, jplan, plan = _problem(rng, "polycode", 2, 2, 1, 1, batch=(3,))
    jcm = JCodedMatmul(jplan, "reference")
    cm = CodedMatmul(plan, "staged", device="cpu")
    Y = cm.worker_stage(A, B[1])
    assert Y.shape[:2] == (3, plan.K)
    C = _np(cm.decode_stage(Y, (A.shape[-1], B.shape[-1]), mask=np.r_[0, np.ones(plan.K - 1)]))
    exp = np.asarray(jcm(jnp.asarray(A), jnp.asarray(B[1]), erased=[0]))
    np.testing.assert_array_equal(C, exp)


def test_decode_stage_rejects_partial_specs_like_jax(rng):
    A, B, jplan, plan = _problem(rng, "bec", 2, 2, 2, 1)
    cm = CodedMatmul(plan, device="cpu")
    jcm = JCodedMatmul(jplan, "reference")
    Y = cm.worker_stage(A, B)
    rt = (A.shape[1], B.shape[1])
    prog = _spanning_progress(plan.K, 2)
    for kw in ({"progress": prog}, {"sub_tasks": 2},
               {"erasure": PartialPattern.from_progress(plan.K, 2, prog)}):
        with pytest.raises(NotImplementedError) as got:
            cm.decode_stage(Y, rt, **kw)
        jkw = kw if "erasure" not in kw else {
            "erasure": JPartialPattern.from_progress(plan.K, 2, prog)}
        with pytest.raises(NotImplementedError) as exp:
            jcm.decode_stage(_np(Y), rt, **jkw)
        head = "split-stage decode has no per-chunk panel path"
        assert str(got.value).startswith(head) and str(exp.value).startswith(head)
        assert "one-shot via cm(A, B, progress=..., sub_tasks=Q)" in str(got.value)
    with pytest.raises(ValueError, match="undecodable"):
        cm.decode_stage(Y, rt, erased=[0, 1, 2])
    np.testing.assert_array_equal(_np(cm.decode_stage(Y, rt, erased=[0], sub_tasks=1)),
                                  A.T @ B)
