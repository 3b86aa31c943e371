"""B1's row entry's share of its roofline: ``work/b1_rows.py``'s least
time at the cell's block over the mean device time of the row entry's
launches in the trace."""

from radiobench.work import b1_rows


def read(ctx):
    if ctx.trace is None:
        return None
    d = ctx.trace.kernels(b1_rows.KERNEL)
    if not d:
        return None
    return 100.0 * b1_rows.bound(ctx.cfg, ctx.traffic["block"]) \
        / (sum(d) / len(d))
