"""Host milliseconds a block in the program's ``fetch.copy``: the copies
of the outputs to host memory, with whatever the stream ran before them
(profiled part of the window)."""

from radiobench import program


def read(ctx):
    return program.mean_ms(ctx, "fetch.copy")
