"""Host milliseconds a block in the program's ``dispatch.stage``: the wait
for the pinned buffer's previous upload and the copy of the block into
it (profiled part of the window)."""

from radiobench import program


def read(ctx):
    return program.mean_ms(ctx, "dispatch.stage")
