"""Device milliseconds a block: the union of the kernel, copy and fill
intervals on the profiler's timeline, over the blocks dispatched in the
profiled part of the window."""


def read(ctx):
    if ctx.trace is None or not ctx.blocks_profiled:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.blocks_profiled
