"""The counted work of all requests of the window (for the coded product
every worker's encoded product, encode and decode: the problem's
``flops_per_request``) over the window, as a share of the card's FP64
tensor peak."""
from coded_bench import peaks


def read(ctx):
    """Percent of the peak."""
    if not ctx.completed:
        return None
    flops = ctx.completed * ctx.problem.flops_per_request()
    return 100.0 * flops / ctx.window_s / peaks.FP64_TENSOR_FLOPS
