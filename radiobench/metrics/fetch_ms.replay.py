"""Host milliseconds a block spends in ``StreamExecutor.fetch`` (waiting
for the card, copying the outputs out), mean over the window's blocks."""


def read(ctx):
    d = ctx.durations("fetch")
    return 1e3 * sum(d) / len(d) if d else None
