"""A request is one step of the adaptive control plane as the serving CLI
(``launch/coded_serve.py --adaptive``) runs it: ``AdaptiveServer(PlanLadder
(p, m, n, K, L, backend="fused"), policy=mean).step(A, B)``, which takes the
worker times of the step from the mix's feed, picks the rung and the
erasure, and serves the product through that rung's facade.

``--control float32`` keeps the ladder and its choices in float64 and
serves every rung through a float32 facade of the program.
"""
from __future__ import annotations

from coded_bench import program, traffic
from coded_bench import trace as tracing


class Entry:
    """A prewarmed ``PlanLadder`` behind an ``AdaptiveServer``."""

    def __init__(self, ctx):
        import torch
        from repro_torch.control import (AdaptiveServer, ExpectedLatencyPolicy,
                                         PlanLadder)
        from repro_torch.runtime import CodedMatmul

        cfg = ctx.cfg
        self.ladder = PlanLadder(cfg["p"], cfg["m"], cfg["n"], K=cfg["K"],
                                 L=program.entry_bound_L(cfg), backend="fused",
                                 points=cfg["points"], device=ctx.device)
        if ctx.dtype != torch.float64:
            for rung in self.ladder.rungs:
                self.ladder._facades[rung] = CodedMatmul(
                    self.ladder.plan(rung), "fused", dtype=ctx.dtype,
                    device=ctx.device, cache_group=self.ladder.group)
        self.tau = self.ladder.tau(self.ladder.active)
        self.taus = tuple(self.ladder.tau(r) for r in self.ladder.rungs)
        threshold = float(ctx.mix.get("monitor_threshold", 0.5))
        policy = ExpectedLatencyPolicy(self.ladder, score_threshold=threshold,
                                       sub_tasks=1)
        self.server = AdaptiveServer(
            self.ladder, policy=policy,
            feed=traffic.model(ctx.mix["worker_times"]).feed(
                ctx.mix["worker_times"], cfg["K"], ctx.seed),
            seed=int(traffic.seed_words(ctx.seed, 5).generate_state(1)[0]),
            score_threshold=threshold)

    def warm(self, A, B) -> None:
        """The ladder's own prewarm: every rung built and priced."""
        self.ladder.prewarm(tuple(A.shape), tuple(B.shape))

    def instrument(self) -> None:
        """Mark the control plane's halves, every rung's worker stage and the
        host's panel lookups."""
        tracing.span_method(self.server, "begin_step", "control.begin_step")
        tracing.span_method(self.server, "complete_step", "control.complete_step")
        for rung in self.ladder.rungs:
            program.mark_worker_stage(self.ladder.facade(rung))
            pc = self.ladder.facade(rung).panel_cache
            if not hasattr(pc.get, "__wrapped__"):
                tracing.span_method(pc, "get", "decode.panel")

    def __call__(self, A, B, req):
        C, _ = self.server.step(A, B)
        return C

    def served(self, req) -> tuple:
        """(tau of the rung served, its survivor mask), from the step's report."""
        rep = self.server.reports[-1]
        mask = [0 if k in rep.erased else 1 for k in range(self.ladder.K)]
        return self.ladder.tau(rep.rung), [tuple(mask)]

    def counters(self) -> dict:
        """The ladder's group-wide pipeline and panel-cache counters."""
        return self.ladder.cache_info()

    def close(self) -> None:
        """Drop the program's objects."""
        self.server = self.ladder = None
