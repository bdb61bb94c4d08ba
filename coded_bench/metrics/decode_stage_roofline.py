"""The decode stage (erase, decode, recompose) against its bound, from the
window's own trace, measured where the program runs it.

The device time launched inside the program's own ``stage.decode`` spans
(which reach the profiler as ranges) per traced request, against the K
products read once and C written once over HBM's bandwidth, the bound of
``decode_roofline``.
"""
from coded_bench import accounting


def read(ctx):
    """Percent of the bound; nothing where the trace holds no ``stage.decode``
    (a program without the span, or no device work, as on the CPU)."""
    prof = ctx.profile
    seconds = (prof or {}).get("stages", {}).get("stage.decode", 0.0)
    if seconds <= 0 or not prof["requests"]:
        return None
    bound = accounting.bound_s(accounting.decode_flops(ctx.cfg),
                               accounting.decode_bytes(ctx.cfg))
    return 100.0 * prof["requests"] * bound / seconds
