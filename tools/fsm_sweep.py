#!/usr/bin/env python3
"""Sweep an FSM kernel's launch geometry on one card.

    python3 tools/fsm_sweep.py [CHUNK,WARM ...]
    python3 tools/fsm_sweep.py --fastrak [TILE ...]

From the root of a checkout. For each (chunk, warm) pair (by default a
grid of 64-512 by 64-512) it runs ``csrc/peak_fsm.cu`` through
``ops/cuda/peak_fsm.peak_fsm`` on four scenes: the burst path's power
(block 0 of ``chip_smoke.burst_scene``, [1, 2^20]), ``chip_smoke``'s
FSM blocks at [1, 2^20] and [64, 2^14] with the burst path's
``PeakDetector`` config, and the forced-miss ramp at [1, 2^20]. Every
output (marks, idx_diff, state) must equal the plain version's, walked
once a scene; it then prints the kernel's time (CUDA events,
``chip_smoke.time_ms``, 20 launches) and the chunks it walked again.
Timings compare only within one call.

``--fastrak`` sweeps the pass-1 tile of ``csrc/fastrak_fsm.cu`` (by
default 1024-16384 samples) on the FasTrak path's decoder inputs (block
0 of ``chip_smoke.fastrak_scene`` through the path's graph, [1, 2^20]),
``chip_smoke.fastrak_rows`` at the path's density and back to back at
[1, 2^20], the decoder bank's [64, 2^14], and the sync stream held high
(the worst case); events, counts and the whole state must equal the
plain version's, and it prints the candidates and the chain's frames.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from grbaz_tpu_torch.ops.cuda import fastrak_fsm as ff  # noqa: E402
from grbaz_tpu_torch.ops.cuda import peak_fsm as pf  # noqa: E402
from grbaz_tpu_torch.ops.detect import PeakDetector  # noqa: E402
from grbaz_tpu_torch.ops.misc import FastrakDecoder  # noqa: E402

GRID = [(chunk, warm) for chunk in (64, 128, 256, 512)
        for warm in (64, 128, 256, 512)]
FASTRAK_TILES = [1024, 2048, 4096, 8192, 16384]


def scenes(dev):
    """(label, x [B, n] on the card, config) of each scene."""
    iq = c.burst_scene(dev)[0][:c.BLOCK]
    power = (iq.real * iq.real + iq.imag * iq.imag)[None].contiguous()
    out = [("burst power [1, 2^20]", power, c.FSM_CONFIG)]
    for seed, rows, n, shape in ((3, 1, c.BLOCK, "[1, 2^20]"),
                                 (4, 64, 1 << 14, "[64, 2^14]")):
        rng = np.random.default_rng(seed)
        out.append((f"fsm_block {shape}", torch.from_numpy(
            c.fsm_block(rng, rows, n)).to(dev), c.FSM_CONFIG))
    rng = np.random.default_rng(6)
    out.append(("forced miss [1, 2^20]", torch.from_numpy(
        c.ramp_block(rng, 1, c.BLOCK)).to(dev), c.FSM_RAMP))
    return out


def fastrak_scenes(dev):
    """(label, metric, sync [B, n] on the card, threshold) of each scene."""
    iq, _ = c.fastrak_scene(dev)
    outs, _, _ = c.run_inputs(c.fastrak_graph(dev), [dict(iq=iq[:c.BLOCK])],
                              c.FT_FS)
    out = [("FasTrak path block 0 [1, 2^20]", outs[0]["metric"][0][None],
            outs[0]["sync"][0][None], c.FT_SYNC_THR)]
    for seed, rows, n, gap, shape in (
            (7, 1, c.BLOCK, c.FT_PATH_GAP, "path density [1, 2^20]"),
            (10, 1, c.BLOCK, (1, 200), "back to back [1, 2^20]"),
            (8, 64, 1 << 14, (1, 200), "decoder bank [64, 2^14]")):
        metric, sync = c.fastrak_rows(np.random.default_rng(seed), rows, n,
                                      c.FT_OS, gap)
        out.append((shape, torch.from_numpy(metric).to(dev),
                    torch.from_numpy(sync).to(dev), 1.0))
    metric = out[-2][1]
    out.append(("sync held high [1, 2^20]", metric,
                torch.full_like(metric, 5.0), 1.0))
    return out


def fastrak_sweep(dev, tiles) -> int:
    for label, metric, sync, thr in fastrak_scenes(dev):
        rows = metric.shape[0]
        st = {k: v.reshape(1).expand(rows).contiguous()
              for k, v in FastrakDecoder(device=dev).init_state().items()}
        t = torch.full((1,), thr, device=dev)
        ref = ff.fastrak_fsm_plain(metric, sync, st, t, c.FT_OS)
        for tile in tiles:
            got = ff.fastrak_fsm(metric, sync, st, t, c.FT_OS, tile=tile)
            torch.cuda.synchronize()
            same = (c.same_bits(got[0], ref[0]) and torch.equal(got[1], ref[1])
                    and all(torch.equal(got[2][k], ref[2][k]) for k in ref[2]))
            c.check(same, f"{label}, tile {tile}: differs from the plain "
                    "version")
            cand = int(ff.fastrak_fsm.last_candidates.sum())
            frames = int(ff.fastrak_fsm.last_frames.sum())
            ms = c.time_ms(lambda i: ff.fastrak_fsm(
                metric, sync, st, t, c.FT_OS, tile=tile), 20)
            print(f"sweep {label} tile {tile}: {ms:.4f} ms, {cand} "
                  f"candidates, {frames} chain frames, "
                  f"{int(ref[1].sum())} passing", flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("fsm_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    args = sys.argv[1:]
    fastrak = "--fastrak" in args
    args = [a for a in args if a != "--fastrak"]
    c.report()
    if fastrak:
        return fastrak_sweep(dev, [int(a) for a in args] or FASTRAK_TILES)
    grid = [tuple(map(int, a.split(","))) for a in args] or GRID
    for label, x, config in scenes(dev):
        rows = x.shape[0]
        cfg = PeakDetector(**config, device="cpu").fsm_config()
        st = {k: v.reshape(1).expand(rows).contiguous()
              for k, v in PeakDetector(device=dev).init_state().items()}
        thr = torch.full((1,), float("-inf"), device=dev)
        ref = pf.peak_fsm_plain(x, st, thr, **cfg)
        for chunk, warm in grid:
            got = pf.peak_fsm(x, st, thr, **cfg, chunk=chunk, warm=warm)
            torch.cuda.synchronize()
            same = torch.equal(got[0], ref[0]) and torch.equal(
                got[1], ref[1]) and all(torch.equal(got[2][k], ref[2][k])
                                        for k in ref[2])
            c.check(same, f"{label}, chunk {chunk} warm {warm}: differs "
                    "from the plain version")
            repairs = int(pf.peak_fsm.last_repairs.sum())
            ms = c.time_ms(lambda i: pf.peak_fsm(
                x, st, thr, **cfg, chunk=chunk, warm=warm), 20)
            chunks = rows * -(-x.shape[1] // chunk)
            print(f"sweep {label} chunk {chunk} warm {warm}: {ms:.4f} ms, "
                  f"repaired {repairs} of {chunks} chunks", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
