"""The plain references against the port's plain backend on the CPU, at
small sizes, block by block across the ring's wrap."""

import numpy as np
import pytest
import torch

from radiobench import manifest

CPU = torch.device("cpu")


@pytest.mark.parametrize("config,block", [("rtl_fm", 1 << 13),
                                          ("scanner", 1 << 12)])
def test_reference_matches_the_plain_backend(config, block):
    cfg, prog = manifest.config(config), manifest.program(config)
    ref = manifest.reference(config)
    ring = prog.ring(cfg, 1, 3, block, 2 ** 31 + 5, CPU)[0]
    ex = prog.executor(cfg, block, CPU)
    for j in range(7):
        outs = ex.step({"iq": ring[j % 3]})
        want = ref.outputs(cfg, ring, j, "f64", CPU)
        got = {p: outs[p] for p in prog.PORTS}
        nums = ref.numbers(got, want)
        for name, v in nums.items():
            assert v <= 1e-5 if name.endswith("gap") else v == 0, (j, nums)


def test_audio_counts_follow_the_exact_positions():
    """Outputs a block, from the 32.32 positions alone, add up to the
    total and match the ratio."""
    from radiobench.reference import dsp, rtl_fm
    inc = dsp.ratio_to_fixed(50e3 / 48e3)
    ends = [0] + [rtl_fm.audio_end(b, 256, inc) for b in range(40)]
    per = np.diff(ends)
    # the first block's last 8 samples wait for the next block's
    assert per[0] == 240 and set(per[1:].tolist()) <= {245, 246}
    assert ends[-1] == pytest.approx(40 * 256 * 48 / 50, abs=8)


def test_tf32_rounding():
    from radiobench.reference.dsp import tf32
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -3.0 - 2 ** -9 - 2 ** -12], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got == [1.0, 1.0, 1.0 + 2 ** -9, -3.0 - 2 ** -9]
