"""B1's row entry (``csrc/xlating_fir.cu``, ``xlating_fir_rows``): B1's
function over the M coherent rows of an antenna array's block of n
snapshots, ``[n, M]`` in and ``[n // decim, M]`` out, one launch."""

from radiobench.reference import dsp
from radiobench.work import b1, bound_s

# the polyphase core's instance over interleaved rows
KERNEL = r"polyphase_fir_kernel<.*RotatedTaps.*StoreRotated.*Interleaved"


def work(n: int, tpad: int, decim: int, rows: int):
    """(bytes, FLOP): ``rows`` times B1's (``work/b1.py``), the taps, the
    phase and the increment read once for every row."""
    nbytes, flops = b1.work(n, tpad, decim)
    return rows * nbytes - (rows - 1) * (4 * tpad + 16), rows * flops


def bound(cfg: dict, block: int) -> float:
    """Seconds a launch needs at least, at a cell's shape."""
    decim = cfg["decim"]
    ntaps = len(dsp.low_pass_taps(cfg["sample_rate"], cfg["channel_width"] / 2
                                  + cfg["transition"] / 2, cfg["transition"]))
    return bound_s(*work(block, dsp.padded_taps(ntaps, decim), decim,
                         cfg["antennas"]))
