"""Host milliseconds a block waits in the pump's queue (``pump.queue``:
from the feeder offering it to the runner taking it; profiled part of
the window)."""

from radiobench import program


def read(ctx):
    return program.mean_ms(ctx, "pump.queue")
