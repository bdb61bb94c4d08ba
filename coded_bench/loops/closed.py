"""A closed loop: the next request is offered when the last one has been
answered and the card has finished its work, for ``ctx.seconds``.  A
request's latency is the host clock from the call to that synchronize."""
import time
import traceback


def serve(ctx, stream) -> None:
    """Serve ``stream`` for the window; one request in flight only."""
    in_flight = int(ctx.mix.get("in_flight", 1))
    if in_flight != 1:
        raise ValueError(f"the closed loop keeps one request in flight; the mix "
                         f"asks for {in_flight}")
    tracer = ctx.tracer
    t0 = t_end = time.perf_counter()
    while t_end - t0 < ctx.seconds:
        req = next(stream)
        tracer.between(t_end - t0)
        ts = time.perf_counter()
        try:
            with tracer.request():
                answer = ctx.entry(*ctx.problem.inputs(req.pair), req)
                ctx.sync()
        except Exception:  # noqa: BLE001 - a failed request is counted
            ctx.sync()
            ctx.failed += 1
            ctx.errors.append(traceback.format_exc(limit=4))
            t_end = time.perf_counter()
            continue
        t_end = time.perf_counter()
        ctx.done(req, answer, t_end - ts)
        del answer
    tracer.between(t_end - t0, last=True)
    ctx.window_s = t_end - t0
