"""A request is one call of the facade as users make it: ``CodedMatmul(plan)
(A, B, mask=...)`` on its default backend, with a host survivor mask."""
from __future__ import annotations

import numpy as np

from coded_bench import program
from coded_bench import trace as tracing


class Entry:
    """One ``CodedMatmul`` of the configuration's plan."""

    def __init__(self, ctx):
        from repro_torch.runtime import CodedMatmul

        self.plan = program.make_plan(ctx.cfg)
        self.tau = self.plan.tau
        self.taus = (self.tau,)
        self.cm = CodedMatmul(self.plan, dtype=ctx.dtype, device=ctx.device)

    def warm(self, A, B) -> None:
        """Build the pipeline with every worker alive, a set the traffic
        (exactly tau survivors) never sends."""
        self.cm(A, B, mask=np.ones(self.plan.K))

    def instrument(self) -> None:
        """Mark the worker stage and the host's decode-panel lookups."""
        program.mark_worker_stage(self.cm)
        tracing.span_method(self.cm.panel_cache, "get", "decode.panel")

    def __call__(self, A, B, req):
        return self.cm(A, B, mask=req.erasure["mask"])

    def served(self, req) -> tuple:
        """(tau, survivor masks) the request was decoded from."""
        return self.tau, [program.mask_key(req.erasure["mask"])]

    def counters(self) -> dict:
        """The program's pipeline and panel-cache counters."""
        return self.cm.cache_info()

    def close(self) -> None:
        """Drop the program's objects."""
        self.cm = None
