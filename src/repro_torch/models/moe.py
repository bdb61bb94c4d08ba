"""Mixture-of-Experts configuration.

Only the dataclass is ported so far: the routed FFN itself (routing, expert
parallelism) is its own slice of the port (ROADMAP.md queue 1, item 8), and
a config whose pattern holds a ``"moe"`` FFN raises ``NotImplementedError``
in ``models.lm``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["MoEConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0           # shared-expert width, in units of d_expert_ff
    capacity_factor: float = 1.25
    act: str = "swiglu"

    @property
    def e_pad(self) -> int:
        """Experts padded so the EP axis divides them (dummy experts are
        never routed to)."""
        return self.n_experts
