"""Host time of the control plane's decision half, ``AdaptiveServer.begin_step``
(monitor, policy, rung and erasure), by the harness's clock around each call
of the window; the mean a step."""
import time


def prepare(ctx):
    """Time every call of the server's ``begin_step``."""
    server = getattr(ctx.entry, "server", None)
    if server is None:
        return
    inner = server.begin_step
    calls = ctx.state.setdefault("begin_step_s", [])

    def timed():
        t0 = time.perf_counter()
        decision = inner()
        calls.append(time.perf_counter() - t0)
        return decision

    server.begin_step = timed


def read(ctx):
    """Milliseconds a step; nothing where no server runs."""
    calls = ctx.state.get("begin_step_s")
    return 1e3 * sum(calls) / len(calls) if calls else None
