"""Continuous batching: coalesce queued requests into prewarmed buckets.

``form`` is called EVERY serving step (continuous batching), not once per
full batch: whatever compatible work is waiting right now is coalesced,
up to the largest prewarmed ``PlanLadder`` batch bucket — the ladder's
round-up pad-and-slice then lands every dispatch on an existing
executable, zero recompiles.

"Compatible" means SAME SLO class: requests in one batch share a rung
decision, an erasure mask, and a ``ViolationFeedback`` state, all of
which are per-class.  Among classes with waiting work, dispatch order is
earliest-deadline-first (ties break by arrival, then request id — total
and deterministic); within the winning class, waiting requests are taken
in the same EDF order across ALL of that class's tenant queues.
"""
from __future__ import annotations

import dataclasses
from typing import Deque, Dict, Optional, Tuple

from repro_torch.serve.admission import Request

__all__ = ["Batch", "ContinuousBatcher"]


def _edf_key(request: Request) -> Tuple[float, float, int]:
    return (request.deadline_s, request.arrival_s, request.rid)


@dataclasses.dataclass(frozen=True)
class Batch:
    """One dispatchable unit: same-class requests + their earliest deadline."""

    slo_class: str
    requests: Tuple[Request, ...]
    deadline_s: float

    @property
    def size(self) -> int:
        """Number of requests coalesced into this batch."""
        return len(self.requests)


class ContinuousBatcher:
    """EDF selection over per-tenant queues, capped at the bucket ceiling.

    Args:
        class_of: tenant name -> SLO class name (batch compatibility).
        max_batch: batch-size ceiling; the largest prewarmed bucket, so
            every dispatch pads up to an existing executable.
    """

    def __init__(self, class_of: Dict[str, str], max_batch: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.class_of = dict(class_of)
        self.max_batch = int(max_batch)

    def form(self, queues: Dict[str, Deque[Request]]) -> Optional[Batch]:
        """Pop and return the next batch to dispatch (None = nothing waits).

        The winning class is the one owning the globally earliest-deadline
        waiting request; up to ``max_batch`` of that class's requests are
        REMOVED from their tenant queues (EDF order) and returned.
        """
        waiting: Dict[str, list] = {}
        for tenant, queue in queues.items():
            if queue:
                waiting.setdefault(self.class_of[tenant], []).extend(queue)
        if not waiting:
            return None
        for reqs in waiting.values():
            reqs.sort(key=_edf_key)
        winner = min(waiting, key=lambda cls: _edf_key(waiting[cls][0]))
        take = waiting[winner][: self.max_batch]
        taken = {r.rid for r in take}
        for tenant, queue in queues.items():
            if self.class_of[tenant] == winner:
                kept = [r for r in queue if r.rid not in taken]
                queue.clear()
                queue.extend(kept)
        return Batch(slo_class=winner, requests=tuple(take),
                     deadline_s=take[0].deadline_s)
