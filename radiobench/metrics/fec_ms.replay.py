"""Host milliseconds a block in the program's ``block.fec``: the auto-FEC
Block's launches, its transform, decode, check and search (profiled part
of the window)."""

from radiobench import program


def read(ctx):
    return program.mean_ms(ctx, "block.fec")
