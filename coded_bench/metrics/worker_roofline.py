"""The worker stage (encode and all K block products) against its bound,
from the window's own trace.

The device time of the traced requests' worker stages (the work launched
inside the program's ``worker_products``, marked ``stage.worker`` by the
entry) against, for each of those requests, the larger of the stage's
counted FLOPs over the FP64 tensor peak and its bytes (A and B read once,
the K products written once) over HBM's.
"""
from coded_bench import accounting


def read(ctx):
    """Percent of the bound; nothing where the trace holds no worker stage."""
    prof = ctx.profile
    seconds = (prof or {}).get("stages", {}).get("stage.worker", 0.0)
    if seconds <= 0 or not prof["requests"]:
        return None
    bound = accounting.bound_s(accounting.worker_stage_flops(ctx.cfg),
                               accounting.worker_stage_bytes(ctx.cfg))
    return 100.0 * prof["requests"] * bound / seconds
