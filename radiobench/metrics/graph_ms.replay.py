"""Host milliseconds a block in the program's ``dispatch.graph``: the
Python launches of the Flowgraph step (profiled part of the window)."""

from radiobench import program


def read(ctx):
    return program.mean_ms(ctx, "dispatch.graph")
