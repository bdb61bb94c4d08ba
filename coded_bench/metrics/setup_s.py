"""Set-up: from the start of the process to the first request of the
window (imports, card start, operands, the program's objects, warm-up; and
in a checkout's first run, the nvcc build)."""


def read(ctx):
    """Seconds of set-up."""
    return ctx.setup_s
