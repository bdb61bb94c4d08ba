"""Adaptive straggler control plane (the layer between runtime/ and launch/).

Closes the loop from observed per-worker latencies to scheme selection over
the paper's L <-> tau ladder:

    WorkerHealthMonitor   EWMA latency/variance, straggler scores, erasure
                          mask + fitted LatencyModel          (monitor.py)
    Policy protocol       tau-th order-statistic completion model ranking
      ExpectedLatencyPolicy   by MEAN completion              (policy.py)
      QuantileLatencyPolicy   by q-QUANTILE completion (tail SLOs)
                          over bec <-> tradeoff(p') <-> polycode, gated by L
    PlanLadder            one CodedMatmul facade per rung over a shared
                          CacheGroup on one device; prewarm() makes switch()
                          rebuild-free, incl. batched leading-dim buckets
                                                              (ladder.py)
    AdaptiveServer        the serving loop wiring the three together, with
                          an SLO-violation fallback switch and a
                          CodedElasticPolicy handoff when the erasure
                          budget is exhausted                 (driver.py)
    ViolationFeedback     sliding-window REALIZED-violation tracker that
                          tightens/loosens the prediction quantile, adapts
                          the flagging threshold, and can force the
                          tail-optimal rung                  (feedback.py)
    plan_partial_progress fractional progress plans: consume chunk
                          prefixes from flagged stragglers   (partial.py)

Every decision is host-side numpy, the same code as the JAX package's
``repro.control``: the port reproduces its golden traces bit for bit.  Only
the ladder's facades (and ``driver.py``'s exactness check) touch the device.
"""
from repro_torch.control.driver import AdaptiveServer, StepReport
from repro_torch.control.feedback import FeedbackConfig, ViolationFeedback
from repro_torch.control.ladder import PlanLadder
from repro_torch.control.monitor import WorkerHealthMonitor
from repro_torch.control.partial import plan_partial_progress
from repro_torch.control.policy import (
    ExpectedLatencyPolicy,
    Policy,
    QuantileLatencyPolicy,
    RungEstimate,
)

__all__ = [
    "AdaptiveServer",
    "StepReport",
    "FeedbackConfig",
    "ViolationFeedback",
    "PlanLadder",
    "WorkerHealthMonitor",
    "Policy",
    "ExpectedLatencyPolicy",
    "QuantileLatencyPolicy",
    "RungEstimate",
    "plan_partial_progress",
]
