"""Share of the profiled window in which the card was idle while the
runner was inside the program's ``dispatch.stage`` (the copy into pinned
memory and the wait before it)."""

from radiobench import program


def read(ctx):
    return program.idle_inside(ctx, "dispatch.stage")
