"""The decode stage (erase, decode, recompose, and the panel's copy to the
card) against its bound, from the window's own trace.

The traced requests' device time outside their worker stages (the trace
holds whole requests only) against, for each of those requests, the K
products read once and C written once over HBM's bandwidth.
"""
from coded_bench import accounting


def read(ctx):
    """Percent of the bound; nothing where the trace holds no worker stage
    to set apart."""
    prof = ctx.profile
    worker = (prof or {}).get("stages", {}).get("stage.worker", 0.0)
    seconds = prof["device_s"] - worker if prof else 0.0
    if worker <= 0 or seconds <= 0 or not prof["requests"]:
        return None
    bound = accounting.bound_s(accounting.decode_flops(ctx.cfg),
                               accounting.decode_bytes(ctx.cfg))
    return 100.0 * prof["requests"] * bound / seconds
