"""B1, the channelizer (``csrc/xlating_fir.cu``, ``xlating_fir_block``):
rotate a block of n complex samples by the LO, filter with a real
lowpass of ``tpad`` taps (padded to whole polyphase rows) and keep every
``decim``-th output."""

from radiobench.reference import dsp
from radiobench.work import bound_s

# the polyphase core's instance with rotated taps and a rotated store
KERNEL = r"polyphase_fir_kernel<.*RotatedTaps.*StoreRotated"


def work(n: int, tpad: int, decim: int):
    """(bytes, FLOP): the block in and the carried tail, the taps, the
    phase and increment, the outputs out; 6 FLOP a sample to rotate and
    4 a tap an output (real taps on complex samples)."""
    n_out = n // decim
    return (8 * n + 12 * tpad + 8 * n_out + 16,
            6 * n + 4 * tpad * n_out)


def bound(cfg: dict, block: int) -> float:
    """Seconds a launch needs at least, at a cell's shape."""
    decim = cfg["decim"]
    ntaps = len(dsp.low_pass_taps(cfg["sample_rate"], cfg["channel_width"] / 2
                                  + cfg["transition"] / 2, cfg["transition"]))
    return bound_s(*work(block, dsp.padded_taps(ntaps, decim), decim))
