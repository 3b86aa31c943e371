"""Kernel launches a block: kernels on the profiler's timeline over the
blocks dispatched in the profiled part of the window."""


def read(ctx):
    if ctx.trace is None or not ctx.blocks_profiled:
        return None
    return len(ctx.trace.kernels()) / ctx.blocks_profiled
