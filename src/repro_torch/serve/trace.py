"""Serve-tier metrics log: JSONL persistence + bit-exact replay contract.

A serve trace is one header line, then one ``request`` record per arrival
(admission verdict, queue delay, completion — the per-request fields
``tenant``/``queue_delay_s`` ride through the same shared serialiser the
chaos traces use, so they round-trip without hand-picking) and one
``batch`` record per dispatch (composition, stage timings, and the full
``StepReport`` payload via ``repro_torch.chaos.serialize.report_to_dict``).

Because a ``ServeTier`` run is a pure function of (spec, scenario, seed)
on the simulated clock, re-running the recipe must reproduce the trace
EXACTLY — ``diff`` returns field-level mismatches (empty = identical).
``golden_serve_trace`` is the canonical recipe pinned by
``tests/golden/serve_heavy_tail.jsonl``, which the JAX package's recipe
(``repro.serve.trace``) wrote; the port reproduces it on any device and
backend (``device=``/``backend=``, as ``chaos.golden`` takes them).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.chaos.golden import GOLDEN_GRID, GOLDEN_K, GOLDEN_L, \
    GOLDEN_SHAPES
from repro_torch.chaos.scenarios import make_scenario
from repro_torch.chaos.serialize import dataclass_to_dict
from repro_torch.control import PlanLadder
from repro_torch.serve.loop import ServeResult, ServeTier
from repro_torch.serve.tenants import DEFAULT_SPEC, parse_tenant_spec

__all__ = ["SERVE_TRACE_VERSION", "ServeTrace",
           "GOLDEN_SERVE_SCENARIO", "GOLDEN_SERVE_SEED",
           "GOLDEN_SERVE_REQUESTS", "GOLDEN_SERVE_OVERHEAD_S",
           "golden_operands", "golden_serve_result", "golden_serve_trace",
           "with_golden_meta"]

SERVE_TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ServeTrace:
    """A recorded tier run: meta + request/batch records as JSON-safe dicts."""

    meta: dict
    requests: Tuple[dict, ...]
    batches: Tuple[dict, ...]

    @classmethod
    def from_result(cls, result: ServeResult) -> "ServeTrace":
        """Serialise a ``ServeResult`` (records through the shared
        dataclass serialiser; decoded products are NOT recorded)."""
        return cls(
            meta=dict(result.meta),
            requests=tuple(dataclass_to_dict(r) for r in result.requests),
            batches=tuple(dataclass_to_dict(b) for b in result.batches))

    def diff(self, other: "ServeTrace") -> List[str]:
        """Field-level mismatches against another trace (empty = identical).

        Floats must match EXACTLY — the serve loop is deterministic on its
        simulated clock, so any drift is a real behaviour change.
        """
        out: List[str] = []
        for kind in ("requests", "batches"):
            mine, theirs = getattr(self, kind), getattr(other, kind)
            if len(mine) != len(theirs):
                out.append(f"{kind}: {len(mine)} vs {len(theirs)} records")
            for a, b in zip(mine, theirs):
                for field in sorted(set(a) | set(b)):
                    want, have = a.get(field), b.get(field)
                    if want != have:
                        label = a.get("rid", a.get("index", "?"))
                        out.append(f"{kind}[{label}].{field}: "
                                   f"{want!r} vs {have!r}")
        return out

    # -- persistence ---------------------------------------------------------
    def save(self, path) -> Path:
        """Write JSONL: header, then request records, then batch records."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [json.dumps(
            {"kind": "header", "version": SERVE_TRACE_VERSION,
             "requests": len(self.requests), "batches": len(self.batches),
             "meta": self.meta}, sort_keys=True)]
        lines += [json.dumps({"kind": "request", **r}, sort_keys=True)
                  for r in self.requests]
        lines += [json.dumps({"kind": "batch", **b}, sort_keys=True)
                  for b in self.batches]
        path.write_text("\n".join(lines) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "ServeTrace":
        """Read a trace written by :meth:`save`.

        Raises:
            ValueError: on a missing/foreign header, version mismatch, or
                an unknown record kind.
        """
        lines = Path(path).read_text().splitlines()
        if not lines:
            raise ValueError(f"{path}: empty serve trace")
        header = json.loads(lines[0])
        if header.get("kind") != "header":
            raise ValueError(f"{path}: first line is not a trace header")
        if header.get("version") != SERVE_TRACE_VERSION:
            raise ValueError(
                f"{path}: serve trace version {header.get('version')} != "
                f"supported {SERVE_TRACE_VERSION}")
        requests, batches = [], []
        for line in lines[1:]:
            rec = json.loads(line)
            kind = rec.pop("kind", None)
            if kind == "request":
                requests.append(rec)
            elif kind == "batch":
                batches.append(rec)
            else:
                raise ValueError(f"{path}: unknown record kind {kind!r}")
        return cls(meta=dict(header.get("meta", {})),
                   requests=tuple(requests), batches=tuple(batches))


# ---------------------------------------------------------------------------
# The canonical golden serve run (mirrors chaos.golden's recipe style).
# ---------------------------------------------------------------------------

GOLDEN_SERVE_SCENARIO = "heavy_tail"
GOLDEN_SERVE_SEED = 11
GOLDEN_SERVE_REQUESTS = 12          # per tenant; 3 tenants -> 36 arrivals
#: constant per-rung decode costs (measured prewarm overheads carry
#: wall-clock noise; golden runs must not time anything real).
GOLDEN_SERVE_OVERHEAD_S = {"bec": 2.0, "tradeoff(p'=2)": 1.0,
                           "polycode": 0.1}
_GOLDEN_BUCKETS = (1, 2, 4, 8)


def _golden_tier(device=None, backend: str = "reference"):
    """The canonical tier config over the chaos golden ladder geometry."""
    p, m, n = GOLDEN_GRID
    ladder = PlanLadder(p, m, n, K=GOLDEN_K, L=GOLDEN_L, backend=backend,
                        dtype=torch.float64, device=device)
    ladder.prewarm(*GOLDEN_SHAPES, batch_sizes=_GOLDEN_BUCKETS, stages=True)
    classes, tenants = parse_tenant_spec(DEFAULT_SPEC)
    feed = make_scenario(GOLDEN_SERVE_SCENARIO).compile(
        GOLDEN_K, seed=GOLDEN_SERVE_SEED)
    tier = ServeTier(
        ladder, classes=tuple(classes.values()),
        tenants=tuple(tenants.values()), feed=feed,
        overhead_s=GOLDEN_SERVE_OVERHEAD_S, seed=GOLDEN_SERVE_SEED,
        check_exact=True, keep_results=True)
    return tier


def golden_operands(device):
    """The recipe's deterministic operands (no rng: version-stable), float64
    on ``device``: ``(make_A, B)`` with ``make_A(request)`` the (v, r) left
    operand of request ``rid`` and B the shared (v, t) right operand."""
    (v, r), (_, t) = GOLDEN_SHAPES
    base = np.arange(v * r).reshape(v, r)

    def make_A(request):
        return torch.as_tensor((base * (request.rid + 3)) % 11 - 5,
                               dtype=torch.float64, device=device)

    B = torch.as_tensor(np.arange(v * t).reshape(v, t) % 7 - 3,
                        dtype=torch.float64, device=device)
    return make_A, B


def golden_serve_result(*, device=None,
                        backend: str = "reference") -> ServeResult:
    """Run the canonical serve recipe (heavy_tail, seeded, simulated clock).

    ``device`` (default the CUDA card) and ``backend`` (default the plain
    ``"reference"``, as in the recipe) choose where the ladder serves; no
    recorded field depends on either.  The kept products lie on the
    ladder's device.
    """
    tier = _golden_tier(device, backend)
    make_A, B = golden_operands(tier.ladder.device)
    return tier.run(make_A, B, GOLDEN_SERVE_REQUESTS)


def golden_serve_trace(*, device=None,
                       backend: str = "reference") -> ServeTrace:
    """The canonical run as a trace, with recipe provenance in the meta."""
    result = golden_serve_result(device=device, backend=backend)
    return with_golden_meta(ServeTrace.from_result(result))


def with_golden_meta(trace: ServeTrace) -> ServeTrace:
    """``trace`` with the golden recipe's provenance added to its meta, as
    the checked-in file's header carries it."""
    meta = dict(trace.meta)
    meta.update(scenario=GOLDEN_SERVE_SCENARIO, seed=GOLDEN_SERVE_SEED,
                requests_per_tenant=GOLDEN_SERVE_REQUESTS,
                version_note="regenerate via scripts/regen_golden_traces.py "
                             "--serve")
    return dataclasses.replace(trace, meta=meta)
