"""B1's share of its roofline: ``work/b1.py``'s least time at the cell's
block over the mean device time of B1's launches in the trace."""

from radiobench.work import b1


def read(ctx):
    if ctx.trace is None:
        return None
    d = ctx.trace.kernels(b1.KERNEL)
    if not d:
        return None
    return 100.0 * b1.bound(ctx.cfg, ctx.traffic["block"]) / (sum(d) / len(d))
