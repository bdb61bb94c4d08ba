"""Per-tenant admission control: token buckets + bounded queues.

Every arrival is either ADMITTED into its tenant's FIFO queue or SHED
with an explicit machine-readable reason — never silently dropped:

    ``"rate_limited"``   the tenant's token bucket was empty
    ``"queue_full"``     the tenant's bounded queue was at depth

Everything runs on the serve tier's SIMULATED clock (buckets refill from
elapsed simulated seconds), so admission decisions are a pure function of
the arrival stream and the drain schedule — deterministic under a seeded
run, which is what lets the golden serve trace replay bit-exactly.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, Optional

from repro_torch.serve.tenants import TenantSpec

__all__ = ["Request", "TokenBucket", "AdmissionController",
           "REJECT_RATE_LIMITED", "REJECT_QUEUE_FULL"]

REJECT_RATE_LIMITED = "rate_limited"
REJECT_QUEUE_FULL = "queue_full"


@dataclasses.dataclass(frozen=True)
class Request:
    """One tenant request in the simulated workload.

    ``deadline_s`` = arrival + the tenant's class bound; the batcher's
    earliest-deadline-first ordering keys on it.
    """

    rid: int
    tenant: str
    slo_class: str
    arrival_s: float
    deadline_s: float


class TokenBucket:
    """Deterministic token bucket refilled on the simulated clock.

    Starts full (``burst`` tokens).  ``rate_rps=inf`` admits everything.
    ``take`` must be called with non-decreasing timestamps (the serve
    loop processes arrivals in arrival order per tenant).
    """

    def __init__(self, rate_rps: float, burst: int):
        self.rate = float(rate_rps)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last_s = 0.0

    @property
    def tokens(self) -> float:
        """Tokens available at the last ``take`` timestamp."""
        return self._tokens

    def take(self, now_s: float) -> bool:
        """Refill to ``now_s`` and consume one token if one is available."""
        if math.isinf(self.rate):
            return True
        elapsed = max(0.0, now_s - self._last_s)
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._last_s = max(self._last_s, now_s)
        if self._tokens >= 1.0 - 1e-12:
            self._tokens -= 1.0
            return True
        return False


class AdmissionController:
    """Token bucket + bounded FIFO queue per tenant.

    The queues are exposed (``queues``) because the continuous batcher
    drains them directly; the controller only decides who gets IN.
    """

    def __init__(self, tenants: Dict[str, TenantSpec]):
        self.tenants = dict(tenants)
        self.buckets: Dict[str, TokenBucket] = {
            name: TokenBucket(t.rate_rps, t.burst)
            for name, t in self.tenants.items()}
        self.queues: Dict[str, Deque[Request]] = {
            name: deque() for name in self.tenants}

    def offer(self, request: Request, now_s: float) -> Optional[str]:
        """Admit ``request`` into its tenant queue, or return a shed reason.

        Returns:
            ``None`` on admission (the request is now queued), else one of
            :data:`REJECT_RATE_LIMITED` / :data:`REJECT_QUEUE_FULL`.

        Raises:
            KeyError: for a tenant the controller was not built with.
        """
        spec = self.tenants[request.tenant]
        if not self.buckets[request.tenant].take(now_s):
            return REJECT_RATE_LIMITED
        queue = self.queues[request.tenant]
        if len(queue) >= spec.max_queue:
            return REJECT_QUEUE_FULL
        queue.append(request)
        return None

    def queued(self) -> int:
        """Total requests waiting across every tenant queue."""
        return sum(len(q) for q in self.queues.values())
