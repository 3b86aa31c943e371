"""The bank kernel's share of its roofline: ``work/bank.py``'s least
time for every slot at the cell's block over the mean device time of
its launches in the trace."""

from radiobench.work import bank


def read(ctx):
    if ctx.trace is None:
        return None
    d = ctx.trace.kernels(bank.KERNEL)
    if not d:
        return None
    return 100.0 * bank.bound(ctx.cfg, ctx.traffic["block"]) / (sum(d)
                                                                / len(d))
