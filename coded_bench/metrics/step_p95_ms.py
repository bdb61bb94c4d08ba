"""The 95th percentile of all request latencies of the window; a latency is
the host clock from the call to a synchronize of the card after it."""
import numpy as np


def read(ctx):
    """Milliseconds."""
    return 1e3 * float(np.percentile(ctx.latencies, 95)) if ctx.latencies else None
