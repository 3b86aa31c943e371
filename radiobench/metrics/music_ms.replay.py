"""Host milliseconds a block in the program's ``block.music``: the MUSIC
Block's covariance, subspace iteration with its host reads, scan and
peaks (profiled part of the window)."""

from radiobench import program


def read(ctx):
    return program.mean_ms(ctx, "block.music")
