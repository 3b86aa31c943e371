"""Share of the profiled window in which the card was idle while the
runner was inside the program's ``dispatch.graph`` (the step's launches)."""

from radiobench import program


def read(ctx):
    return program.idle_inside(ctx, "dispatch.graph")
