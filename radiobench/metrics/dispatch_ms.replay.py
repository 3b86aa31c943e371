"""Host milliseconds a block spends in ``StreamExecutor.dispatch`` (the
copy into pinned memory, the upload, launching the step), mean over the
window's blocks of every stream."""


def read(ctx):
    d = ctx.durations("dispatch")
    return 1e3 * sum(d) / len(d) if d else None
