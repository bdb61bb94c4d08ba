"""A request is one partial-straggler call: ``CodedMatmul(plan, sub_tasks=Q)
(A, B, progress=...)``, each worker's completed share of its Q row chunks."""
from __future__ import annotations

import numpy as np

from coded_bench import program
from coded_bench import trace as tracing


class Entry:
    """One ``CodedMatmul`` of the configuration's plan, Q sub-tasks."""

    def __init__(self, ctx):
        from repro_torch.runtime import CodedMatmul

        self.plan = program.make_plan(ctx.cfg)
        self.tau = self.plan.tau
        self.taus = (self.tau,)
        self.Q = int(ctx.mix["erasures"]["sub_tasks"])
        self.cm = CodedMatmul(self.plan, sub_tasks=self.Q, dtype=ctx.dtype,
                              device=ctx.device)

    def warm(self, A, B) -> None:
        """Build the pipeline with every worker done, which the traffic
        (decoded at the first moment each chunk has tau) never sends."""
        self.cm(A, B, progress=np.ones(self.plan.K))

    def instrument(self) -> None:
        """Mark the worker stage and the host's panel-stack lookups."""
        program.mark_worker_stage(self.cm)
        tracing.span_method(self.cm.panel_cache, "get_partial", "decode.panel")

    def __call__(self, A, B, req):
        return self.cm(A, B, progress=req.erasure["progress"])

    def served(self, req) -> tuple:
        """(tau, the per-chunk survivor masks) under the cyclic schedule."""
        K = self.plan.K
        counts = np.floor(req.erasure["progress"] * self.Q + 1e-9)
        holds = (np.arange(self.Q)[:, None] - np.arange(K)[None, :]) % self.Q
        return self.tau, [program.mask_key(row) for row in holds < counts]

    def counters(self) -> dict:
        """The program's pipeline and panel-cache counters."""
        return self.cm.cache_info()

    def close(self) -> None:
        """Drop the program's objects."""
        self.cm = None
