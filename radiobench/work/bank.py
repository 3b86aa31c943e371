"""The channel bank's kernel (``csrc/channel_bank.cu``): B1's function
for every slot over one shared block."""

from radiobench.reference import dsp
from radiobench.work import bound_s

KERNEL = r"channel_bank_kernel"


def work(n: int, tpad: int, decim: int, slots: int):
    """(bytes, FLOP): the block in once, each slot's tail in and out
    (tpad - 1 samples), the taps, each slot's phase and increment, each
    slot's outputs; per slot 6 FLOP a sample to rotate and 4 a tap an
    output."""
    n_out = n // decim
    return (8 * n + 16 * slots * (tpad - 1) + 4 * tpad + 16 * slots
            + 8 * slots * n_out,
            slots * (6 * n + 4 * tpad * n_out))


def bound(cfg: dict, block: int) -> float:
    decim = cfg["decim"]
    ntaps = len(dsp.low_pass_taps(cfg["sample_rate"], cfg["channel_width"] / 2
                                  + cfg["transition"] / 2, cfg["transition"]))
    return bound_s(*work(block, dsp.padded_taps(ntaps, decim), decim,
                         cfg["capacity"]))
