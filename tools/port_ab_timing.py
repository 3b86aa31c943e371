#!/usr/bin/env python3
"""Time checkouts of the PyTorch/CUDA port against each other on one card.

    python3 tools/port_ab_timing.py PARENT . . PARENT

Each argument is the root of a checkout (for example ``git archive`` of
the parent commit unpacked into a git-ignored directory). In the order
given, one process per checkout imports that checkout's own
``chip_smoke.py`` and, with its functions, builds the kernels, holds
each against its plain version, and prints per-launch kernel times (us,
CUDA events, 200 launches) and the WBFM chains' step times
(``chain_timing``: the cascade chain, the fused chain, then the cascade
chain again after the two profiled runs). Every output line is prefixed
with the checkout it came from; timings compare only within one call.
Exits non-zero if any checkout fails.
"""

from __future__ import annotations

import os
import subprocess
import sys


def one() -> None:
    """The timings of the checkout in the working directory."""
    import torch
    import chip_smoke as c

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    c.build.build_all()
    cases = c.kernel_cases(dev)
    c.check_kernels(cases)
    for k in cases:
        us = c.time_ms(k["kernel"], 200) * 1e3
        print(f"kernel {k['name']} [{k.get('shape', '-')}] {us:.3f} us",
              flush=True)
    iq = c.synth_fm(c.N_BLOCKS * c.BLOCK, dev)
    cascade = c.WBFMConfig(block_size=c.BLOCK, audio_chain="cascade",
                           center_freq=c.STATION_HZ)
    fused = c.WBFMConfig(block_size=c.BLOCK, fused=True,
                         center_freq=c.STATION_HZ)
    c.chain_timing(dev, iq, cascade, "chain")
    c.chain_timing(dev, iq, fused, "fused_chain")
    c.chain_timing(dev, iq, cascade, "chain_again")


def main(dirs) -> int:
    rc = 0
    for d in dirs:
        root = os.path.abspath(d)
        env = dict(os.environ, PYTHONPATH=root)
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one"], cwd=root, env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           timeout=600)
        for line in p.stdout.splitlines():
            print(f"{d}: {line}", flush=True)
        print(f"{d}: rc {p.returncode}", flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    if sys.argv[1:] == ["--one"]:
        one()
    else:
        sys.exit(main(sys.argv[1:]))
