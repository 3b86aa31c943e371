#!/usr/bin/env python3
"""Time checkouts of the PyTorch/CUDA port against each other on one card.

    python3 tools/port_ab_timing.py PARENT . . PARENT
    python3 tools/port_ab_timing.py --bank DIR ...
    python3 tools/port_ab_timing.py --decoders DIR ...
    python3 tools/port_ab_timing.py --fsm DIR ...

Each argument is the root of a checkout (for example ``git archive`` of
the parent commit unpacked into a git-ignored directory). In the order
given, one process per checkout imports that checkout's own
``chip_smoke.py`` and, with its functions, builds the kernels, holds
each against its plain version, and prints per-launch kernel times (us,
CUDA events, 200 launches), the WBFM chains' step times
(``chain_timing``: the cascade chain, the fused chain, then the cascade
chain again after the two profiled runs) and the 16-slot channel bank's
step time (:func:`bank_timing`). With ``--bank``, each process builds
only the channel bank's kernel, runs ``chip_smoke.bank_case``'s check
(printing each error and ``held True`` or ``held False``) and times the
kernel per launch (:func:`bank_one`; ``tools/bank_variants.py`` runs its
mutants so). With ``--decoders``, each process builds only the decoders'
kernels (Viterbi, ACARS, Manchester, DPLL), holds and times their cases
per launch (ACARS and Manchester at the decoders path's [1, 2^14] and the
bank's [64, 2^14] only, the cases every checkout has) and times the
ViterbiDecoder, ACARS, Manchester and DPLL graphs' steps
(:func:`decoders`). With ``--fsm``, each process builds only the FSM
kernels (the FasTrak decoder's K1, the peak FSM) and B3, holds and times
``chip_smoke``'s K1 and peak FSM cases per call (CUDA events, and the
device time of the kernel's passes from torch.profiler) and times the
FasTrak path's step (:func:`fsm`). Every output
line is prefixed with the checkout it came from; timings compare only
within one call. Exits non-zero if any checkout's process fails.
"""

from __future__ import annotations

import os
import statistics
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
    bank_timing(c, dev)


def bank_timing(c, dev, rounds=6, steps=20) -> None:
    """Step time of the 16-slot ``DynamicChannelBank`` (BASELINE config 5,
    ``chip_smoke.bank_graph``) on its kernel arm with every channel added,
    over ``BANK_BLOCKS`` blocks of noise; every output goes into the
    checksum (``chip_smoke.graph_timer``)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    xs = [torch.view_as_complex(torch.randn(c.BANK_BLOCK, 2, generator=gen,
                                            device=dev))
          for _ in range(c.BANK_BLOCKS)]
    fg, bank = c.bank_graph(dev)
    params = fg.init_params()
    c.bank_control(bank)(params, 0)
    run = c.graph_timer(fg, xs, c.FS, params)
    ts = [run(steps) for _ in range(rounds)]
    med = statistics.median(ts)
    print("bank step ms per round (events): "
          + ", ".join(f"{t:.4f}" for t in ts)
          + f"; median {med:.4f} ms = {c.BANK_BLOCK / med / 1e3:.2f} "
          "Msamp/s wideband", flush=True)


def bank_one() -> None:
    """The bank's kernel of the checkout in the working directory: the
    check of ``chip_smoke.bank_case`` (16 slots, 2^17 samples, chained
    and retuned), then its time per launch; then the kernel's and the
    plain version's times at a narrow-band plan (4 slots, 12.5 kHz
    channels, 1544 taps)."""
    import torch
    import chip_smoke as c

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    c.build.build_all(["channel_bank"])
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.from_numpy(c.fir.prepare_taps(
        c.fir.low_pass_taps(1.0, c.FS, 112.5e3, 75e3), c.DECIM)).to(dev)
    case = c.bank_case(dev, gen, h)
    try:
        case["check"]()
        held = True
    except RuntimeError as e:
        print(e, flush=True)
        held = False
    us = c.time_ms(case["kernel"], 200) * 1e3
    print(f"held {held}; kernel {us:.3f} us", flush=True)
    # the narrow-band plan of the check: 4 slots, 1544 taps in slabs
    nb = torch.from_numpy(c.fir.prepare_taps(c.fir.low_pass_taps(
        1.0, c.FS, 8.75e3, 5e3), c.DECIM)).to(dev)
    xs = c.copies(lambda: torch.view_as_complex(torch.randn(
        c.BANK_BLOCK, 2, generator=gen, device=dev)), 8 * c.BANK_BLOCK)
    tail = torch.view_as_complex(torch.randn(
        4, nb.shape[0] - 1, 2, generator=gen, device=dev)).contiguous()
    ph = torch.randint(0, 2 ** 32, (4,), generator=gen, device=dev)
    inc = torch.randint(0, 2 ** 32, (4,), generator=gen, device=dev)
    times = [c.time_ms(lambda i: fn(xs[i % len(xs)], tail, nb, c.DECIM,
                                    ph, inc), iters) * 1e3
             for fn, iters in ((c.cb.channel_bank, 200),
                               (c.cb.channel_bank_plain, 5))]
    print(f"narrow band [4 slots, {nb.shape[0]} taps]: kernel "
          f"{times[0]:.3f} us, plain {times[1]:.3f} us", flush=True)


def decoders() -> None:
    """K3-K6 of the checkout in the working directory: each K3 and K6 case
    of its ``chip_smoke.decode_kernel_cases`` and the K4 and K5 cases at
    the decoders path's and the bank's shapes held to its plain version,
    then timed a launch (CUDA events, 20 launches); the ViterbiDecoder
    step (overlap 96) over 8 blocks of 2^16 soft pairs and the ACARS,
    Manchester and both DPLL graphs' steps over the decoders path's scene
    (``graph_timer``, 6 rounds of 8 steps, every output in the
    checksum)."""
    import numpy as np
    import torch
    import chip_smoke as c

    dev = torch.device("cuda")
    c.build.build_all(["viterbi", "acars_fsm", "manchester_fsm",
                       "dpll_walk"])
    cases = [k for k in c.decode_kernel_cases(dev)
             if k["name"] in ("viterbi", "dpll_walk")
             or k["shape"].split(",")[0] in ("decoders path", "decoder bank")]
    c.check_kernels(cases)
    for k in cases:
        us = c.time_ms(k["kernel"], 20) * 1e3
        print(f"kernel {k['name']} [{k['shape']}] {us:.3f} us", flush=True)
    _, soft = c.soft_pairs(np.random.default_rng(32),
                           c.N_BLOCKS * c.FEC_BLOCK)
    xs = [torch.from_numpy(soft[b * c.FEC_BLOCK:(b + 1) * c.FEC_BLOCK])
          .to(dev) for b in range(c.N_BLOCKS)]
    vdec = c.ViterbiDecoder(overlap=c.FEC_OVERLAP, name="vdec", device=dev)
    steps("viterbi_decoder", c.graph_timer(c.one_block_graph(vdec), xs,
                                           72e3))
    feeds, _, _ = c.decoder_scene(dev)
    graphs = c.decoder_graphs(dev)
    for key in ("acars", "manchester", "dpll", "dpll16"):
        steps(key, c.graph_timer(graphs[key], feeds[key], c.DEC_RATE[key]))


def fsm() -> None:
    """K1 and the peak FSM of the checkout in the working directory: the
    K1 cases of its ``chip_smoke.kernel_cases`` (the FasTrak path's [1,
    2^20], the decoder bank's [64, 2^14], frames back to back at [1, 2^20],
    the sync held high) and the peak FSM's at the burst path's and the
    decoder bank's shapes, each held to its plain version over two
    chained calls, then timed a call (CUDA events over 20 calls, which
    read the host's pace where the wrapper's host work outlasts the
    card's; and the device time of the kernel's passes, torch.profiler);
    then the FasTrak path's step over its 8 blocks (``graph_timer``, 6 rounds
    of 8 steps, every output in the checksum)."""
    import torch
    import chip_smoke as c

    dev = torch.device("cuda")
    c.build.build_all(["fastrak_fsm", "peak_fsm", "fir_decimate"])
    cases = [
        c.fastrak_case(dev, 7, 1, c.BLOCK, "FasTrak path", gap=c.FT_PATH_GAP),
        c.fastrak_case(dev, 8, 64, 1 << 14, "decoder bank"),
        c.fastrak_case(dev, 10, 1, c.BLOCK, "frames back to back",
                       gap=(1, 200)),
        c.fastrak_case(dev, 9, 1, c.BLOCK, "sync held high", held=True),
        c.fsm_case(dev, 3, 1, c.BLOCK, "burst path"),
        c.fsm_case(dev, 4, 64, 1 << 14, "decoder bank")]
    c.check_kernels(cases)
    for k in cases:
        names = (c.FASTRAK_PASSES if k["name"] == "fastrak_fsm"
                 else c.FSM_PASSES)
        us = c.time_ms(k["kernel"], 20) * 1e3
        passes, every = device_us(k["kernel"], names)
        print(f"kernel {k['name']} [{k['shape']}] {us:.3f} us a call "
              f"(CUDA events, 20 calls); device {passes:.3f} us in its "
              f"passes, {every:.3f} us in every kernel of the call "
              "(torch.profiler)", flush=True)
    iq, _ = c.fastrak_scene(dev)
    feeds = [dict(iq=iq[b * c.BLOCK:(b + 1) * c.BLOCK])
             for b in range(c.N_BLOCKS)]
    steps("fastrak_path", c.graph_timer(c.fastrak_graph(dev), feeds,
                                        c.FT_FS))


def device_us(fn, names, iters=20):
    """Device us per call of ``fn(i)`` (torch.profiler, after warm-up): in
    the kernels whose names hold one of ``names``, and in every kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total]
    mine = sum(e.self_device_time_total for e in events
               if any(k in e.key for k in names))
    return (mine / iters,
            sum(e.self_device_time_total for e in events) / iters)


def steps(label, run, rounds=6, n=8) -> None:
    ts = [run(n) for _ in range(rounds)]
    print(f"{label} step ms per round (events): "
          + ", ".join(f"{t:.4f}" for t in ts)
          + f"; median {statistics.median(ts):.4f} ms", flush=True)


JOBS = {"--one": one, "--bank-one": bank_one, "--decoders-one": decoders,
        "--fsm-one": fsm}


def run(dirs, job="--one"):
    """Runs ``job`` in one process per checkout, in turn; prints its
    output prefixed with the checkout and returns ``[(rc, output)]``."""
    out = []
    for d in dirs:
        root = os.path.abspath(d)
        env = dict(os.environ, PYTHONPATH=root)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), job],
                           cwd=root, env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           timeout=600)
        for line in p.stdout.splitlines():
            print(f"{d}: {line}", flush=True)
        print(f"{d}: rc {p.returncode}", flush=True)
        out.append((p.returncode, p.stdout))
    return out


def main(args) -> int:
    if args[:1] == ["--bank"]:
        return max(rc for rc, _ in run(args[1:], "--bank-one"))
    if args[:1] == ["--decoders"]:
        return max(rc for rc, _ in run(args[1:], "--decoders-one"))
    if args[:1] == ["--fsm"]:
        return max(rc for rc, _ in run(args[1:], "--fsm-one"))
    return max(rc for rc, _ in run(args))


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] in JOBS:
        JOBS[sys.argv[1]]()
    else:
        sys.exit(main(sys.argv[1:]))
