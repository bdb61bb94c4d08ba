"""The port's elastic pool pieces on the CPU: ``repro_torch.distributed
.elastic``, the monitor's resize, the ladder's respecialisation and the
elastic server's validation.

Mirrors the policy, monitor, ladder and server classes of
``tests/test_elastic.py`` on ``device="cpu"`` (the point, plan and panel
extension cases are in ``test_torch_core.py`` and ``test_torch_partial.py``),
holds the ladder's ``cache_info()`` counters across a shrink and a grow
against the reference's, and runs the bench twin's elastic gate.
"""
import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro_torch import obs  # noqa: E402
from repro_torch.control import AdaptiveServer, ExpectedLatencyPolicy, PlanLadder  # noqa: E402
from repro_torch.control.monitor import WorkerHealthMonitor  # noqa: E402
from repro_torch.core.api import uncoded_matmul  # noqa: E402
from repro_torch.core.bounds import conservative_L  # noqa: E402
from repro_torch.core.points import extend_points  # noqa: E402
from repro_torch.distributed import CodedElasticPolicy, plan_shrink  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _obs_off():
    """The bench's CompileWatch turns obs on; leave it off for the next test."""
    yield
    obs.disable()


class TestPlanShrinkEdges:
    @pytest.mark.parametrize("devices,mesh", [
        (8, (2, 4)), (256, (16, 16)),      # exact fit takes the full mesh
        (7, (2, 2)), (255, (8, 16)),       # inexact fit rounds down
        (1, (1, 1)),
    ])
    def test_largest_mesh_that_fits(self, devices, mesh):
        assert plan_shrink(devices) == mesh

    def test_zero_devices_raises(self):
        with pytest.raises(ValueError, match="no supported mesh fits 0"):
            plan_shrink(0)

    def test_matches_reference(self):
        from repro.distributed.elastic import plan_shrink as ref

        for n in range(1, 300):
            assert plan_shrink(n) == ref(n)


class TestCodedElasticPolicy:
    @pytest.mark.parametrize("mask", [
        [1, 0, 1, 1, 0, 1],
        np.array([1, 0, 1, 1, 0, 1], dtype=bool),
        np.array([1.0, 0.0, 0.5, 2.0, 0.0, 1.0]),
        np.array([1, 0, 1, 1, 0, 1], dtype=np.int32),
    ])
    def test_observe_mask_accepts_int_bool_float(self, mask):
        pol = CodedElasticPolicy(K=6, tau=3)
        pol.observe_mask(mask)
        assert pol.healthy.dtype == bool
        assert int(pol.healthy.sum()) == 4
        assert pol.slack == 1 and not pol.must_respecialize

    def test_observe_mask_shape_mismatch(self):
        pol = CodedElasticPolicy(K=6, tau=3)
        with pytest.raises(ValueError, match=r"mask shape \(5,\) != \(6,\)"):
            pol.observe_mask(np.ones(5))
        with pytest.raises(ValueError, match="mask shape"):
            pol.observe_mask(np.ones((2, 3)))

    def test_slack_and_respecialize_trigger(self):
        pol = CodedElasticPolicy(K=6, tau=4)
        assert pol.slack == 2
        pol.mark_failed(1)
        pol.mark_failed(4)
        assert pol.slack == 0 and pol.must_respecialize
        pol.mark_recovered(4)
        assert not pol.must_respecialize

    def test_shrink_compacts_health_bits(self):
        pol = CodedElasticPolicy(K=6, tau=2)
        pol.observe_mask([1, 0, 1, 1, 0, 1])
        pol.shrink([0, 2, 3, 5])
        assert pol.K == 4
        np.testing.assert_array_equal(pol.healthy, [1, 1, 1, 1])
        np.testing.assert_array_equal(pol.mask(), [1.0, 1.0, 1.0, 1.0])

    def test_grow_appends_healthy(self):
        pol = CodedElasticPolicy(K=4, tau=2)
        pol.mark_failed(3)
        pol.grow(2)
        assert pol.K == 6
        np.testing.assert_array_equal(pol.healthy, [1, 1, 1, 0, 1, 1])
        with pytest.raises(ValueError, match="g must be >= 0"):
            pol.grow(-1)

    @pytest.mark.parametrize("keep,match", [
        ([], "1-D and non-empty"), ([0, 0, 1], "duplicate"),
        ([0, 9], "outside the pool of 4")])
    def test_shrink_validation(self, keep, match):
        with pytest.raises(ValueError, match=match):
            CodedElasticPolicy(K=4, tau=2).shrink(keep)


class TestMonitorResize:
    def _warm_monitor(self):
        mon = WorkerHealthMonitor(4, alpha=1.0, min_history=1)
        mon.record_step([1.0, 2.0, 3.0, 40.0])
        mon.record_step([1.0, 2.0, 3.0, 40.0])
        return mon

    def test_shrink_carries_survivor_state(self):
        mon = self._warm_monitor()
        score_before = mon.straggler_scores().copy()
        mon.resize(keep=[0, 2])
        assert mon.K == 2 and mon.steps == 2
        np.testing.assert_allclose(mon.mean, [1.0, 3.0])
        np.testing.assert_allclose(mon.straggler_scores(), score_before[[0, 2]])

    def test_grow_fills_with_survivor_average(self):
        mon = self._warm_monitor()
        mon.resize(keep=[0, 1, 2], grow=2)
        assert mon.K == 5
        np.testing.assert_allclose(mon.mean, [1.0, 2.0, 3.0, 2.0, 2.0])
        np.testing.assert_allclose(mon.straggler_scores()[3:], 0.0)

    @pytest.mark.parametrize("kw,match", [
        (dict(keep=[0, 0]), "duplicate-free"),
        (dict(keep=[0, 7]), "outside the pool of 4"),
        (dict(grow=-1), "grow must be >= 0"),
        (dict(keep=[]), "empty pool")])
    def test_resize_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            self._warm_monitor().resize(**kw)


def _ladder(K=6, pkg="torch"):
    """Grid (2,2,1): bec tau=2; tradeoff/polycode tau=5."""
    L = conservative_L(8, 3, 3)
    if pkg == "jax":
        from repro.control.ladder import PlanLadder as RefLadder
        return RefLadder(2, 2, 1, K=K, L=L, backend="reference")
    return PlanLadder(2, 2, 1, K=K, L=L, backend="reference", device=CPU)


class TestLadderRespecialize:
    def test_shrink_relowers_onto_survivors(self):
        ladder = _ladder()
        ladder.prewarm((8, 4), (8, 2))
        group = ladder.group
        keys_before = set(group.executables)
        assert keys_before
        taus = {r: ladder.tau(r) for r in ladder.rungs}
        wide = max(taus, key=taus.get)
        ladder.switch(wide)
        keep = np.asarray([0, 2, 4])
        info = ladder.respecialize(ladder.z_points[keep])
        assert ladder.K == 3
        assert ladder.tau(ladder.active) <= 3 and ladder.active != wide
        np.testing.assert_array_equal(ladder.plan(ladder.active).z_points,
                                      _ladder().z_points[keep])
        assert ladder.group is group
        assert keys_before <= set(group.executables)
        assert isinstance(info, dict)

    def test_shrink_below_every_tau_raises(self):
        ladder = _ladder()
        with pytest.raises(ValueError, match="no rung of grid"):
            ladder.respecialize(ladder.z_points[:1])

    def test_grow_extends_points_and_keeps_executables(self):
        ladder = _ladder()
        ladder.prewarm((8, 4), (8, 2))
        group = ladder.group
        keys_before = set(group.executables)
        z_ext = extend_points(ladder.z_points, 2)
        ladder.respecialize(z_ext)
        assert ladder.K == 8
        np.testing.assert_array_equal(ladder.z_points, z_ext)
        for rung in ladder.rungs:
            np.testing.assert_array_equal(ladder.plan(rung).z_points, z_ext)
        assert ladder.group is group
        assert keys_before <= set(group.executables)
        pc = ladder.facade(ladder.active).panel_cache
        builds = pc.builds
        pc.get(np.concatenate([np.ones(6), np.zeros(2)]))
        assert pc.builds == builds

    @pytest.mark.parametrize("z", [np.empty((0,)), np.zeros((2, 3))])
    def test_respecialize_validates_points(self, z):
        with pytest.raises(ValueError):
            _ladder().respecialize(z)

    def test_grown_ladder_still_decodes_exactly(self):
        rng = np.random.default_rng(5)
        A = torch.as_tensor(rng.integers(-3, 4, size=(8, 4)), dtype=torch.float64)
        B = torch.as_tensor(rng.integers(-3, 4, size=(8, 2)), dtype=torch.float64)
        ladder = _ladder()
        truth = uncoded_matmul(A, B)
        assert torch.equal(ladder(A, B), truth)
        ladder.respecialize(extend_points(ladder.z_points, 2))
        assert torch.equal(ladder(A, B, erased=[3, 6, 7]), truth)

    def test_cache_info_across_handoff_matches_reference(self):
        """builds, hits, entries, panel_builds, plans and switches after a
        prewarm, a shrink (which re-prewarms) and a grow, each followed by
        serving, equal the reference ladder's at every stage."""
        trail = {}
        for pkg in ("jax", "torch"):
            ladder = _ladder(pkg=pkg)
            if pkg == "jax":
                import jax.numpy as jnp
                arr = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
            else:
                arr = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
            A, B = arr(np.ones((8, 4))), arr(np.ones((8, 2)))
            infos = []
            ladder.prewarm((8, 4), (8, 2))
            ladder.switch(ladder.rungs[-1])
            ladder(A, B, erased=[1])
            infos.append(ladder.cache_info())
            infos.append(ladder.respecialize(ladder.z_points[[0, 2, 4]]))
            ladder(A, B, erased=[0])
            infos.append(ladder.cache_info())
            infos.append(ladder.respecialize(extend_points(ladder.z_points, 3)))
            ladder(A, B, erased=[5])
            infos.append(ladder.cache_info())
            infos.append((ladder.rungs, ladder.active, ladder.K))
            trail[pkg] = infos
        assert trail["torch"] == trail["jax"]


class TestServerElasticValidation:
    def _server(self, **kw):
        ladder = _ladder()
        width = kw.pop("width", 6)
        return AdaptiveServer(ladder, feed=lambda i: np.ones(width),
                              policy=ExpectedLatencyPolicy(ladder), **kw)

    @pytest.mark.parametrize("kw,match", [
        (dict(pool=np.arange(6)), "pool= requires universe="),
        (dict(universe=4), "smaller than the pool"),
        (dict(universe=10, pool=[0, 0, 1, 2, 3, 4]), "distinct universe members"),
        (dict(universe=10, pool=[0, 1, 2, 3, 4, 99]), "outside the universe"),
    ])
    def test_construction_validated(self, kw, match):
        with pytest.raises(ValueError, match=match):
            self._server(**kw)

    def test_grow_needs_elastic_server(self):
        with pytest.raises(ValueError, match="elastic server"):
            self._server().grow([6])

    @pytest.mark.parametrize("joiners,match", [
        ([0], "already in the pool"), ([42], "outside the universe"),
        ([6, 6], "duplicate")])
    def test_grow_rejects_bad_joiners(self, joiners, match):
        srv = self._server(universe=10, width=10)
        with pytest.raises(ValueError, match=match):
            srv.grow(joiners)


class TestElasticBenchTwin:
    def test_check_elastic_passes(self):
        from benchmarks import torch_control_bench as bench

        row = bench.run("elastic_sweep", "reference", CPU)["elastic_sweep"]
        bench.check_elastic(row)
        assert (row["pool_initial"], row["pool_shrunk"], row["pool_final"]) == (10, 7, 9)
        assert (row["rung_first"], row["rung_shrunk"], row["rung_final"]) == (
            "polycode", "bec", "polycode")

    def test_elastic_row_equals_reference_bench(self):
        from benchmarks import control_bench, torch_control_bench
        from repro.core.numerics import enable_x64

        with enable_x64():
            want = control_bench._run_elastic(control_bench.EL_SEED)
        got = torch_control_bench._run_elastic(
            torch_control_bench.EL_SEED,
            torch_control_bench.ladder_kw("reference", CPU))
        assert got == want
