"""The share of the traced part of the window (its middle fifth) in which
no operation ran on the card, from ``torch.profiler``'s device activity."""


def read(ctx):
    """Percent idle; nothing where the trace holds no device work."""
    prof = ctx.profile
    if not prof or prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
