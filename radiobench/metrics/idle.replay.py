"""Share of the profiled part of the window in which no kernel, copy or
fill ran on the card: 1 - (union of device intervals / window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
