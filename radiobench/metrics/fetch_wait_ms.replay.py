"""Host milliseconds a block in the program's ``fetch.wait``: waiting for
the event at the end of the step's launches (profiled part of the
window)."""

from radiobench import program


def read(ctx):
    return program.mean_ms(ctx, "fetch.wait")
