"""Elastic scaling: re-specialise the job when the healthy device set shrinks.

Large jobs lose nodes.  Two recovery tiers here:

1. IN-STEP (the paper's contribution): coded matmuls tolerate up to K - tau
   erased workers per step with NO re-lowering - the erasure mask is data.
   ``CodedElasticPolicy`` tracks the healthy mask and decides when losses
   exceed the code's slack.

2. RE-SPECIALISE: when slack is exhausted, pick the largest supported mesh
   that fits the healthy device count and re-lower onto it.
   ``plan_shrink`` chooses the target mesh; the control plane's elastic
   mode (``control/driver.py``) executes the coded half of the handoff by
   re-lowering its plan ladder onto the survivor pool.

This module is numpy only; the coded on-mesh layer is ``coded.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["CodedElasticPolicy", "plan_shrink"]


@dataclasses.dataclass
class CodedElasticPolicy:
    """Tracks worker health against the code's erasure budget."""

    K: int
    tau: int
    healthy: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.healthy is None:
            self.healthy = np.ones(self.K, dtype=bool)

    @property
    def slack(self) -> int:
        return int(self.healthy.sum()) - self.tau

    def mark_failed(self, worker: int) -> None:
        self.healthy[worker] = False

    def mark_recovered(self, worker: int) -> None:
        self.healthy[worker] = True

    def observe_mask(self, mask) -> None:
        """Adopt a health monitor's 0/1 survivor mask as the healthy set.

        Control-plane integration point: ``WorkerHealthMonitor.erasure_mask``
        feeds here each step, so ``slack``/``must_respecialize`` track the
        LIVE straggler picture instead of only explicit failure events.
        """
        m = np.asarray(mask)
        if m.shape != (self.K,):
            raise ValueError(f"mask shape {m.shape} != ({self.K},)")
        self.healthy = (m != 0).copy()

    def mask(self) -> np.ndarray:
        return self.healthy.astype(np.float64)

    def shrink(self, keep) -> None:
        """Drop every worker not in ``keep`` (pool-local indices, ordered).

        The executed-respecialisation path: after the ladder re-lowers
        onto the survivor pool, the policy's K and health state follow —
        survivors keep their health bits at their new (compacted)
        indices.

        Raises:
            ValueError: on duplicate/out-of-range indices or an empty
                survivor set.
        """
        idx = np.asarray(keep, dtype=np.intp)
        if idx.ndim != 1 or idx.size < 1:
            raise ValueError(f"keep must be 1-D and non-empty, got {keep!r}")
        if len(set(idx.tolist())) != idx.size:
            raise ValueError(f"keep has duplicate indices: {keep!r}")
        if idx.min() < 0 or idx.max() >= self.K:
            raise ValueError(f"keep indexes outside the pool of {self.K}")
        self.healthy = self.healthy[idx].copy()
        self.K = int(idx.size)

    def grow(self, g: int) -> None:
        """Admit ``g`` new workers, healthy until observed otherwise.

        New workers append at the end of the pool — matching the
        point-extension contract, where joiners take the freshly
        extended evaluation points and survivors keep theirs.
        """
        if g < 0:
            raise ValueError(f"g must be >= 0, got {g}")
        self.healthy = np.concatenate(
            [self.healthy, np.ones(g, dtype=bool)])
        self.K += g

    @property
    def must_respecialize(self) -> bool:
        """True when another failure would make steps undecodable."""
        return self.slack <= 0


_SUPPORTED_MESHES: Tuple[Tuple[int, int], ...] = (
    (16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1),
)


def plan_shrink(healthy_devices: int,
                meshes: Sequence[Tuple[int, int]] = _SUPPORTED_MESHES
                ) -> Tuple[int, int]:
    """Largest (data, model) mesh that fits the healthy device count.

    Shrinking the data axis preserves the model-parallel layout (cheap
    reshard)."""
    for d, m in meshes:
        if d * m <= healthy_devices:
            return (d, m)
    raise ValueError(f"no supported mesh fits {healthy_devices} devices")
