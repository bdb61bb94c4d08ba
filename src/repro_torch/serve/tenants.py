"""Tenant and SLO-class configuration for the multi-tenant serve tier.

An :class:`SLOClass` maps a latency contract onto the existing control
machinery: its quantile becomes the class's ``AdaptiveServer``
``slo_quantile`` (and its own ``ViolationFeedback`` state when enabled),
its bound becomes ``slo_s``, and its optional rung floor becomes a
:class:`RungFloorPolicy` — a ``QuantileLatencyPolicy`` that refuses to
select any rung with a SMALLER erasure budget than the floor rung, so a
premium class never gets parked on a thin-budget scheme just because the
mean ranking liked its decode cost.

A :class:`TenantSpec` binds a tenant to a class and carries its admission
knobs (token-bucket rate limit + burst, bounded queue depth) and the
simulated arrival rate its workload is generated at.

Both parse from the small JSON document ``coded_serve --serve-tier``
accepts (``{"classes": [...], "tenants": [...]}``); :data:`DEFAULT_SPEC`
is the built-in three-tenant example.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.control.policy import QuantileLatencyPolicy

__all__ = ["SLOClass", "TenantSpec", "RungFloorPolicy",
           "parse_tenant_spec", "DEFAULT_SPEC"]


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One latency contract: quantile + bound + optional rung floor.

    Args:
        name: class identifier tenants reference.
        quantile: the tail quantile the SLO is stated at (the class
            server's ``slo_quantile``).
        slo_s: the latency bound in (simulated) seconds.  Per-request
            ``violated`` flags judge END-TO-END latency (queueing
            included) against this bound.
        rung_floor: optional rung name; the class never serves on a rung
            with a smaller erasure budget than this rung's.
        feedback: enable the class's own ``ViolationFeedback`` window
            (observed service-time violations adapt its quantile and
            flagging threshold independently of every other class).
    """

    name: str
    quantile: float = 0.99
    slo_s: float = 10.0
    rung_floor: Optional[str] = None
    feedback: bool = False

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {self.quantile}")
        if self.slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {self.slo_s}")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: its SLO class, admission limits, and arrival process.

    Args:
        name: tenant identifier (queue key, metrics key).
        slo_class: name of the :class:`SLOClass` this tenant serves under.
        rate_rps: token-bucket refill rate (admitted requests/s);
            ``inf`` disables rate limiting.
        burst: token-bucket capacity (back-to-back admissions allowed).
        max_queue: bounded queue depth; arrivals beyond it are shed with
            reason ``"queue_full"``.
        arrival_rps: mean Poisson arrival rate the simulated workload
            generates for this tenant.
    """

    name: str
    slo_class: str
    rate_rps: float = math.inf
    burst: int = 8
    max_queue: int = 64
    arrival_rps: float = 1.0

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.arrival_rps <= 0:
            raise ValueError(
                f"arrival_rps must be > 0, got {self.arrival_rps}")


class RungFloorPolicy(QuantileLatencyPolicy):
    """Quantile ranking with a minimum-protection rung floor.

    ``select`` first takes the base policy's winner; if that rung's
    erasure budget is SMALLER than the floor rung's (rungs order by
    ascending tau = descending budget, so "below the floor" means less
    straggler protection) and the floor itself is feasible, the floor
    rung is served instead.  With ``floor=None`` this IS
    ``QuantileLatencyPolicy`` — including its feedback hooks (``q`` and
    ``score_threshold`` restatement), which is why the serve tier uses
    this subclass rather than wrapping.
    """

    def __init__(self, ladder, *, floor: Optional[str] = None, **kwargs):
        super().__init__(ladder, **kwargs)
        if floor is not None:
            ladder.plan(floor)  # KeyError on an unknown rung, up front
        self.floor = floor

    def select(self, model, scores=None):
        """The ranked winner, clamped to the floor rung's budget."""
        best = super().select(model, scores)
        if self.floor is None:
            return best
        if (self.ladder.budget(best.rung) < self.ladder.budget(self.floor)
                and self.feasible(self.floor)):
            return self.estimate(self.floor, model, scores)
        return best


#: The built-in example spec: three tenants over two classes.  ``free``
#: arrives faster than its token bucket refills, so it demonstrably sheds.
DEFAULT_SPEC: dict = {
    "classes": [
        {"name": "premium", "quantile": 0.99, "slo_s": 15.0,
         "rung_floor": "tradeoff(p'=2)"},
        {"name": "standard", "quantile": 0.9, "slo_s": 60.0},
    ],
    "tenants": [
        {"name": "gold", "slo_class": "premium", "arrival_rps": 0.4},
        {"name": "silver", "slo_class": "standard", "arrival_rps": 0.8},
        {"name": "free", "slo_class": "standard", "arrival_rps": 2.5,
         "rate_rps": 0.5, "burst": 3, "max_queue": 8},
    ],
}


def parse_tenant_spec(
    spec,
) -> Tuple[Dict[str, SLOClass], Dict[str, TenantSpec]]:
    """``{"classes": [...], "tenants": [...]}`` -> typed, validated maps.

    Args:
        spec: a dict, a JSON string, or a sequence of per-tenant dicts
            (classes defaulting from :data:`DEFAULT_SPEC`).

    Returns:
        ``(classes, tenants)`` keyed by name, insertion-ordered.

    Raises:
        ValueError: on duplicate names, a tenant referencing an unknown
            class, or an empty section.
    """
    if isinstance(spec, str):
        spec = json.loads(spec)
    if isinstance(spec, Sequence) and not isinstance(spec, (str, bytes)):
        spec = {"classes": DEFAULT_SPEC["classes"], "tenants": list(spec)}
    class_rows = spec.get("classes") or DEFAULT_SPEC["classes"]
    tenant_rows = spec.get("tenants") or []
    if not tenant_rows:
        raise ValueError("tenant spec has no tenants")
    classes: Dict[str, SLOClass] = {}
    for row in class_rows:
        cls = SLOClass(**row)
        if cls.name in classes:
            raise ValueError(f"duplicate SLO class {cls.name!r}")
        classes[cls.name] = cls
    tenants: Dict[str, TenantSpec] = {}
    for row in tenant_rows:
        ten = TenantSpec(**row)
        if ten.name in tenants:
            raise ValueError(f"duplicate tenant {ten.name!r}")
        if ten.slo_class not in classes:
            raise ValueError(
                f"tenant {ten.name!r} references unknown SLO class "
                f"{ten.slo_class!r}; have {sorted(classes)}")
        tenants[ten.name] = ten
    return classes, tenants
