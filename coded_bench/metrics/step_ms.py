"""The window divided by the requests completed in it."""


def read(ctx):
    """Milliseconds a request, over all the window's work and time."""
    return 1e3 * ctx.window_s / ctx.completed if ctx.completed else None
