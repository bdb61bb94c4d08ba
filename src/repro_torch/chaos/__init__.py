"""Scenario-driven fault injection, trace record/replay, golden runs.

The behavioural test substrate of the control plane (DESIGN Sec. 9):

    scenarios.py   declarative ``Scenario`` DSL + registry — straggler
                   regimes (iid, heavy/Pareto tails, bursts, flapping,
                   rack failure, pool resize, crawlers, degrading ramps)
                   compiled into deterministic seeded ``TimeFeed``s
    trace.py       ``TraceRecorder``/``Trace`` — capture per-step worker
                   times + ``StepReport`` streams as JSONL and replay them
                   bit-deterministically
    golden.py      the canonical recipe behind ``tests/golden/*.jsonl``

Scenario and trace handling are host-side numpy (no tensors touched),
though importing the package pulls torch in transitively — scenarios build
on ``repro_torch.core.simulator`` and ``repro_torch.core``'s package init
loads the plan API.  Nothing touches a device until a golden run serves
through a ladder (``golden.py`` takes ``device=`` and ``backend=``).
"""
from repro_torch.chaos.scenarios import (
    BurstySlowdown,
    CorrelatedRackFailure,
    Crawler,
    Degrading,
    FlappingWorkers,
    HeavyTailMixture,
    IIDShiftedExponential,
    ParetoTail,
    PoolResize,
    Scenario,
    make_scenario,
    register,
    scenario_names,
    trace_matrix,
)
from repro_torch.chaos.serialize import (
    dataclass_to_dict,
    jsonable,
    report_to_dict,
    tuplify,
)
from repro_torch.chaos.trace import (
    Trace,
    TraceRecorder,
    TraceStep,
    verify_replay,
)

__all__ = [
    "Scenario",
    "IIDShiftedExponential",
    "HeavyTailMixture",
    "ParetoTail",
    "BurstySlowdown",
    "FlappingWorkers",
    "CorrelatedRackFailure",
    "PoolResize",
    "Crawler",
    "Degrading",
    "register",
    "make_scenario",
    "scenario_names",
    "trace_matrix",
    "Trace",
    "TraceRecorder",
    "TraceStep",
    "verify_replay",
    "dataclass_to_dict",
    "jsonable",
    "report_to_dict",
    "tuplify",
]
