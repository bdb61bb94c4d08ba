"""End-to-end behaviour of the paper's system through the port: the twin
of ``tests/test_system.py``.

The full pipeline at the paper's geometry (m = n = p = 2, K = 10 workers,
integer matrices, paper Sec. V) on the CPU (the kernels' plain versions),
asserting the headline claims: exact decode under the maximum erasure
budget, BEC's 6-straggler tolerance against the polynomial code's 1, the
latency shape of Fig. 1, and the scale-and-round float workflow.  Each
result is also held against the JAX package's on the same inputs: the
decoded C within the reference test's 1e-6, the simulated latencies equal.
"""
import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from repro.core import coded_matmul as jcoded_matmul  # noqa: E402
from repro.core import make_plan as jmake_plan  # noqa: E402
from repro.core import LatencyModel as JLatencyModel  # noqa: E402
from repro.core import simulate_completion as jsimulate_completion  # noqa: E402
from repro_torch.core import (  # noqa: E402
    LatencyModel,
    coded_matmul,
    make_plan,
    simulate_completion,
    uncoded_matmul,
)

ATOL = 1e-6     # the reference test's bound


@pytest.fixture(scope="module")
def paper_setup():
    rng = np.random.default_rng(42)
    v = r = t = 256  # scaled-down Sec. V geometry
    A = rng.integers(0, 51, size=(v, r)).astype(np.float64)
    B = rng.integers(0, 51, size=(v, t)).astype(np.float64)
    L = v * 50 * 50 + 1
    return A, B, L


def _port(A, B, plan, **kw) -> np.ndarray:
    C = coded_matmul(torch.from_numpy(A), torch.from_numpy(B), plan, device="cpu", **kw)
    return C.numpy()


class TestPaperSystem:
    def test_bec_survives_six_stragglers(self, paper_setup):
        """The paper's headline: tau=4 of K=10 -> any 6 workers can die."""
        A, B, L = paper_setup
        plan = make_plan("bec", 2, 2, 2, K=10, L=L, points="unit_circle")
        jplan = jmake_plan("bec", 2, 2, 2, K=10, L=L, points="unit_circle")
        assert plan.tau == 4
        C_ref = A.T @ B
        rng = np.random.default_rng(0)
        for _ in range(3):
            dead = rng.choice(10, size=6, replace=False).tolist()
            C = _port(A, B, plan, erased=dead)
            np.testing.assert_allclose(C, C_ref, atol=ATOL)
            jC = np.asarray(jcoded_matmul(jnp.asarray(A), jnp.asarray(B), jplan, erased=dead))
            np.testing.assert_allclose(C, jC, atol=ATOL)

    def test_polycode_needs_nine(self, paper_setup):
        A, B, L = paper_setup
        plan = make_plan("polycode", 2, 2, 2, K=10, L=L, points="unit_circle")
        assert plan.tau == 9
        C = _port(A, B, plan, erased=[5])  # 1 straggler ok
        np.testing.assert_allclose(C, uncoded_matmul(torch.from_numpy(A),
                                                     torch.from_numpy(B)).numpy(), atol=ATOL)
        with pytest.raises(ValueError, match="undecodable"):
            _port(A, B, plan, erased=[0, 1])  # 2 stragglers fatal

    def test_fig1_latency_shape(self):
        """BEC flat to S=6 then jumps; polycode degrades from S=2; the same
        medians as the reference's simulator."""
        model = LatencyModel(base=1.0, straggler_slowdown=2.0)
        jmodel = JLatencyModel(base=1.0, straggler_slowdown=2.0)
        curves = {}
        for tau in (4, 9):
            curves[tau] = [float(np.median(simulate_completion(10, tau, S, model, trials=30,
                                                               seed=S)))
                           for S in range(9)]
            assert curves[tau] == [
                float(np.median(jsimulate_completion(10, tau, S, jmodel, trials=30, seed=S)))
                for S in range(9)]
        bec, poly = curves[4], curves[9]
        assert bec[:7] == [1.0] * 7 and bec[7] == 2.0
        assert poly[0] == poly[1] == 1.0 and poly[2] == 2.0

    def test_end_to_end_float_workflow(self):
        """Floats via scale-and-round (paper footnote 1): the quantised
        coded product matches the quantised reference exactly."""
        rng = np.random.default_rng(1)
        x = rng.normal(size=(128, 64))
        w = rng.normal(size=(128, 96))
        qmax = 31  # 6-bit grid
        sx = np.abs(x).max() / qmax
        sw = np.abs(w).max() / qmax
        xi, wi = np.round(x / sx), np.round(w / sw)
        L = 128 * qmax * qmax + 1
        plan = make_plan("bec", 2, 2, 2, K=8, L=L, points="unit_circle")
        C = _port(xi, wi, plan, erased=[0, 7])
        np.testing.assert_allclose(C, xi.T @ wi, atol=ATOL)
