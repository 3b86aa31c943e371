"""K3's share of its roofline: ``work/viterbi.py``'s least time at the
cell's block over the mean device time of one decode, the mean launch
of each of its kernels (the forward pass, the maps, the bits) summed."""

from radiobench.work import viterbi


def read(ctx):
    if ctx.trace is None:
        return None
    times = [ctx.trace.kernels(k) for k in viterbi.KERNELS]
    if not all(times):
        return None
    decode_s = sum(sum(d) / len(d) for d in times)
    return 100.0 * viterbi.bound(ctx.cfg, ctx.traffic["block"]) / decode_s
