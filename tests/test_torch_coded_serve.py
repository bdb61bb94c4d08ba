"""The port's serving CLI (``repro_torch.launch.coded_serve``) on the CPU.

Drives ``main([... , "--device", "cpu"])`` in every mode at small sizes and
holds it against the JAX package's CLI (``repro.launch.coded_serve``) on
the same flags: the static modes print ``exact`` for each request with the
reference's erasure draws; ``--serve-tier --record`` writes the reference's
records; the adaptive and elastic modes give the reference's step reports;
``--record``/``--replay`` round-trips; the obs exports are readable;
``--backend mesh`` serves the static and adaptive modes exactly on CPU
ranks, and the elastic and tier modes, with the reference's printed
reason, on the reference executor as the JAX CLI does;
and the reference's argument errors are raised the same way.

Prewarm measures each rung's step on the host clock, and the CLI's
policies (and the tier's decode stage) price rungs by that measurement, so
two runs agree only when it does: the ``pinned_overheads`` fixture fixes it
to the golden recipe's constants in both packages.
"""
import dataclasses

import jax
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro_torch import obs  # noqa: E402
from repro_torch.chaos import Trace  # noqa: E402
from repro_torch.launch import coded_serve  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.serve import GOLDEN_SERVE_OVERHEAD_S, ServeTrace  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _obs_off():
    yield
    obs.disable()


@pytest.fixture
def pinned_overheads(monkeypatch):
    """Both packages' ``PlanLadder.prewarm`` report the recipe's constant
    per-rung costs in place of their host-clock measurement."""
    from repro.control import ladder as ref_ladder
    from repro_torch.control import ladder as port_ladder

    for mod in (ref_ladder, port_ladder):
        measured = mod.PlanLadder.prewarm

        def prewarm(self, *args, _measured=measured, **kwargs):
            info = _measured(self, *args, **kwargs)
            self.step_overhead_s = {r: GOLDEN_SERVE_OVERHEAD_S[r]
                                    for r in self.rungs}
            info["overhead_s"] = dict(self.step_overhead_s)
            return info

        monkeypatch.setattr(mod.PlanLadder, "prewarm", prewarm)


def port(args):
    return coded_serve.main(list(args) + ["--device", CPU])


def ref(args):
    from repro.launch import coded_serve as ref_cli

    return ref_cli.main(list(args))


def _request_lines(text):
    return [line for line in text.splitlines() if line.startswith("req ")]


def _fields(report):
    out = dataclasses.asdict(report)
    out.pop("wall_ms")
    return out


class TestStaticModes:
    @pytest.mark.parametrize("backend", ["reference", "staged", "fused"])
    def test_every_request_exact(self, backend, capsys):
        lat = port(["--backend", backend, "--requests", "4", "--size", "64"])
        out = capsys.readouterr().out
        lines = _request_lines(out)
        assert len(lat) == len(lines) == 4
        assert all(line.endswith("exact") for line in lines)
        assert " 1 executable(s)" in out

    def test_batched_erasures_are_the_reference_draws(self, capsys):
        args = ["--backend", "reference", "--requests", "6", "--size", "32",
                "--batch", "2", "--fail-rate", "0.6"]
        port(args)
        mine = _request_lines(capsys.readouterr().out)
        ref(args)
        theirs = _request_lines(capsys.readouterr().out)
        erased = [line.split("erased=")[1].split()[0] for line in mine]
        assert erased == [line.split("erased=")[1].split()[0]
                          for line in theirs]
        assert any(e != "[]" for e in erased)
        assert all(line.endswith("exact") for line in mine)


class TestServeTierMode:
    def test_record_equals_the_reference_cli(self, pinned_overheads,
                                             tmp_path, capsys):
        args = ["--serve-tier", "--size", "64", "--scenario", "heavy_tail",
                "--requests", "6", "--seed", "3"]
        result = port(args + ["--record", str(tmp_path / "port.jsonl")])
        ref(args + ["--record", str(tmp_path / "jax.jsonl")])
        mine = ServeTrace.load(tmp_path / "port.jsonl")
        theirs = ServeTrace.load(tmp_path / "jax.jsonl")
        assert mine.diff(theirs) == [] and mine.meta == theirs.meta
        assert any(b["size"] > 1 for b in mine.batches)
        assert any(not r["admitted"] for r in mine.requests)
        assert all(b.report["exact"] for b in result.batches)
        out = capsys.readouterr().out
        assert "(unchanged since prewarm)" in out and "shed_reasons" in out

    def test_tenant_spec_from_a_file_without_pipelining(self, tmp_path):
        spec = tmp_path / "spec.json"
        spec.write_text('{"classes": [{"name": "c", "slo_s": 30.0}], '
                        '"tenants": [{"name": "a", "slo_class": "c", '
                        '"arrival_rps": 2.0}]}')
        result = port(["--serve-tier", "--size", "32", "--requests", "5",
                       "--tenant-spec", f"@{spec}", "--no-pipeline",
                       "--max-batch", "2"])
        assert result.meta["pipelined"] is False
        assert result.meta["max_batch"] == 2
        assert len(result.completed) == 5
        assert all(b.size <= 2 and b.report["exact"] for b in result.batches)

    def test_sub_tasks_serve_one_shot(self):
        result = port(["--serve-tier", "--size", "32", "--requests", "3",
                       "--scenario", "crawler", "--sub-tasks", "4"])
        assert result.meta["split_stages"] is False
        assert all(b.report["exact"] for b in result.batches)

    def test_operands_made_on_demand(self):
        shapes = ((16, 8), (16, 4))
        make_A, B = coded_serve.serve_tier_operands(5, 3, shapes, CPU)
        req = lambda rid: type("R", (), {"rid": rid})()  # noqa: E731
        A0, A3, A1 = make_A(req(0)), make_A(req(3)), make_A(req(1))
        assert A0.shape == shapes[0] and B.shape == shapes[1]
        assert A0.dtype == B.dtype == torch.float64
        assert torch.equal(A0, A3)          # rid 3 = rid 0 modulo the pool
        assert not torch.equal(A0, A1)
        for x in (A0, A1, B):
            assert x.min() >= -4 and x.max() <= 4
            assert torch.equal(x, x.round())
        _, B_other = coded_serve.serve_tier_operands(6, 3, shapes, CPU)
        assert not torch.equal(B, B_other)


class TestAdaptiveModes:
    @pytest.mark.parametrize("args", [
        ["--adaptive", "--requests", "8", "--size", "64", "--batch", "2",
         "--slo-quantile", "0.99", "--slo-ms", "1800"],
        ["--adaptive", "--scenario", "crawler", "--sub-tasks", "4",
         "--size", "64", "--requests", "8"],
        ["--adaptive", "--scenario", "pareto", "--feedback", "--slo-ms",
         "2500", "--requests", "8", "--size", "32"],
        ["--adaptive", "--elastic", "--requests", "10", "--size", "24"],
    ])
    def test_reports_equal_the_reference_cli(self, pinned_overheads, args,
                                             capsys):
        mine = port(args)
        out = capsys.readouterr().out
        theirs = ref(args)
        assert [_fields(r) for r in mine] == [_fields(r) for r in theirs]
        assert all(r.exact for r in mine)
        assert "unchanged since prewarm" in out or \
            "zero steady-state recompiles" in out

    def test_record_then_replay_round_trips(self, pinned_overheads,
                                            tmp_path, capsys):
        path = tmp_path / "run.jsonl"
        args = ["--adaptive", "--requests", "8", "--size", "32"]
        recorded = port(args + ["--scenario", "pareto", "--record",
                                str(path)])
        replayed = port(args + ["--replay", str(path)])
        trace = Trace.load(path)
        assert len(trace.steps) == 8 and trace.diff(replayed) == []
        assert [_fields(r) for r in replayed] == \
            [_fields(r) for r in recorded]
        out = capsys.readouterr().out
        assert "recorded trace ->" in out and "WARNING" not in out


class TestObsExports:
    @pytest.mark.parametrize("mode", [
        ["--serve-tier", "--scenario", "heavy_tail", "--requests", "4"],
        ["--adaptive", "--requests", "4"],
    ])
    def test_dumps_read_back_by_the_report(self, mode, tmp_path, capsys):
        metrics, spans = tmp_path / "m.prom", tmp_path / "t.json"
        port(mode + ["--size", "32", "--metrics-out", str(metrics),
                     "--perfetto-out", str(spans)])
        assert metrics.exists() and spans.exists()
        capsys.readouterr()
        # every span name: the facade's own spans outrank the control
        # plane's in total time
        assert obs_report.main(["--metrics", str(metrics),
                                "--perfetto", str(spans), "--top", "1000"]) == 0
        rendered = capsys.readouterr().out
        assert "control.begin_step" in rendered
        if "--serve-tier" in mode:
            assert "serve_admit" in metrics.read_text()


class TestMeshAndArgumentErrors:
    @pytest.mark.parametrize("mode", [[], ["--adaptive"],
                                      ["--adaptive", "--elastic"],
                                      ["--serve-tier"]])
    def test_mesh_backend_raises_in_every_mode(self, mode, monkeypatch, capsys,
                                               pinned_overheads, tmp_path):
        """The static and adaptive modes serve exactly on CPU ranks (K = 4
        and 12); the elastic and tier modes print the reference's reason,
        serve on the reference executor and give the JAX CLI's report."""
        monkeypatch.setattr(coded_serve, "MESH_TIMEOUT_S", 120)
        argv = ["--backend", "mesh", "--requests", "3", "--size", "32"] + mode
        if "--elastic" in mode or "--serve-tier" in mode:
            reason = ("--elastic does not drive the mesh backend yet; falling "
                      "back to the reference executor" if "--elastic" in mode
                      else "--serve-tier does not drive the mesh backend (the "
                      "split worker/decode stages run fused on mesh); falling "
                      "back to the reference executor")
            tier = "--serve-tier" in mode
            rec = lambda name: ["--record", str(tmp_path / name)] if tier else []  # noqa: E731
            mine = port(argv + rec("port.jsonl"))
            out_mine = capsys.readouterr().out
            theirs = ref(argv + rec("jax.jsonl"))
            out_theirs = capsys.readouterr().out
            assert reason in out_mine.splitlines()
            assert reason in out_theirs.splitlines()
            if tier:
                a = ServeTrace.load(tmp_path / "port.jsonl")
                b = ServeTrace.load(tmp_path / "jax.jsonl")
                assert a.diff(b) == [] and a.meta == b.meta
                assert all(batch.report["exact"] for batch in mine.batches)
            else:
                assert [_fields(r) for r in mine] == [_fields(r) for r in theirs]
                assert all(r.exact for r in mine)
            return
        result = port(argv)
        lines = _request_lines(capsys.readouterr().out)
        assert len(lines) == len(result) == 3
        assert all(line.endswith("exact") or " exact" in line for line in lines)
        assert not any("CHECK FAILED" in line for line in lines)
        if mode:
            assert all(rep.exact for rep in result)

    @pytest.mark.parametrize("argv", [
        ["--feedback"],
        ["--adaptive", "--scenario", "iid", "--replay", "x.jsonl"],
        ["--sub-tasks", "0"],
        ["--monitor-threshold", "0"],
        ["--serve-tier", "--adaptive"],
        ["--serve-tier", "--slo-ms", "5"],
        ["--no-pipeline"],
        ["--elastic"],
        ["--adaptive", "--elastic", "--sub-tasks", "2"],
        ["--adaptive", "--elastic", "--scenario", "iid"],
        ["--scenario", "iid"],
        ["--sub-tasks", "2"],
        ["--backend", "nonesuch"],
    ])
    def test_argument_errors_as_the_reference(self, argv, capsys):
        with pytest.raises(SystemExit) as mine:
            port(argv)
        err_mine = capsys.readouterr().err.strip().splitlines()[-1]
        with pytest.raises(SystemExit) as theirs:
            ref(argv)
        err_theirs = capsys.readouterr().err.strip().splitlines()[-1]
        assert mine.value.code == theirs.value.code == 2
        assert err_mine == err_theirs

    def test_unknown_scenario(self):
        with pytest.raises(SystemExit, match="unknown scenario"):
            port(["--adaptive", "--scenario", "nonesuch", "--size", "16"])

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for args in (["--requests", "1"], ["--adaptive"], ["--serve-tier"]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                coded_serve.main(args)
