"""Decode panels the program factored on the host in the window, per request
(the facade's, or the ladder's group-wide, ``cache_info()["panel_builds"]``)."""


def read(ctx):
    """Builds a request."""
    if not ctx.completed or "panel_builds" not in ctx.counters_after:
        return None
    builds = ctx.counters_after["panel_builds"] - ctx.counters_before["panel_builds"]
    return builds / ctx.completed
