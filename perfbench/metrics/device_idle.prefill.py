"""device_idle.prefill: the share of the traced stretch (one cycle of the
mix's lengths after the window) in which no operation ran on the card."""


def read(ctx):
    if ctx.kind != "prefill" or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
