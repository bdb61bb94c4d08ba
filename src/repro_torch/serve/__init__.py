"""Async multi-tenant serving tier over the coded-matmul control plane.

The tier layers four pieces on top of :class:`repro_torch.control.PlanLadder`
and :class:`repro_torch.control.AdaptiveServer`, all driven by one seeded
SIMULATED clock so chaos ``TimeFeed`` scenarios and golden traces keep
working unchanged:

1. **Admission** (:mod:`repro_torch.serve.admission`) — per-tenant token
   buckets and bounded queues; overload sheds with explicit reasons.
2. **Continuous batching** (:mod:`repro_torch.serve.batcher`) — every step,
   waiting same-class requests coalesce up to the largest prewarmed
   batch bucket; the ladder's pad-and-slice lands each dispatch on an
   existing executable (zero recompiles).
3. **SLO classes** (:mod:`repro_torch.serve.tenants`) — each class gets its
   own ``AdaptiveServer`` (own quantile, own ``ViolationFeedback``)
   over a SHARED worker-health monitor and ladder, with an optional
   :class:`RungFloorPolicy` erasure-budget floor; dispatch among
   classes is earliest-deadline-first.
4. **Two-stage pipeline** (:mod:`repro_torch.serve.loop`) — decode of step t
   overlaps encode+products of step t+1 on the simulated timeline,
   using the split ``worker_stage``/``decode_stage`` entry points.

:class:`ServeTier` is the event loop tying these together;
:class:`repro_torch.serve.trace.ServeTrace` persists a run as JSONL and backs
the golden serve trace replayed in CI.
"""
from repro_torch.serve.admission import (
    REJECT_QUEUE_FULL,
    REJECT_RATE_LIMITED,
    AdmissionController,
    Request,
    TokenBucket,
)
from repro_torch.serve.batcher import Batch, ContinuousBatcher
from repro_torch.serve.loop import (
    BatchRecord,
    RequestRecord,
    ServeResult,
    ServeTier,
    StageTiming,
    TwoStagePipeline,
)
from repro_torch.serve.tenants import (
    DEFAULT_SPEC,
    RungFloorPolicy,
    SLOClass,
    TenantSpec,
    parse_tenant_spec,
)
from repro_torch.serve.trace import (
    GOLDEN_SERVE_OVERHEAD_S,
    GOLDEN_SERVE_REQUESTS,
    GOLDEN_SERVE_SCENARIO,
    GOLDEN_SERVE_SEED,
    ServeTrace,
    golden_serve_result,
    golden_serve_trace,
)

__all__ = [
    "REJECT_QUEUE_FULL",
    "REJECT_RATE_LIMITED",
    "AdmissionController",
    "Request",
    "TokenBucket",
    "Batch",
    "ContinuousBatcher",
    "BatchRecord",
    "RequestRecord",
    "ServeResult",
    "ServeTier",
    "StageTiming",
    "TwoStagePipeline",
    "DEFAULT_SPEC",
    "RungFloorPolicy",
    "SLOClass",
    "TenantSpec",
    "parse_tenant_spec",
    "GOLDEN_SERVE_OVERHEAD_S",
    "GOLDEN_SERVE_REQUESTS",
    "GOLDEN_SERVE_SCENARIO",
    "GOLDEN_SERVE_SEED",
    "ServeTrace",
    "golden_serve_result",
    "golden_serve_trace",
]
