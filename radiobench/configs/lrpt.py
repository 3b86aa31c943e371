"""Meteor-M N2 LRPT passes on the port: one ``AutoFECBlock`` (the auto-FEC
search, the K3 Viterbi decoder and the BER, all on the card) in a
one-block ``Flowgraph`` under a ``StreamExecutor``, one per recorded
pass. Sizes come from ``lrpt.json``; the block size from the cell's
traffic."""

from __future__ import annotations

import numpy as np
import torch

from radiobench import signals

# the outputs the sinks receive, in the order the pump hands them on
PORTS = ("pm", "bits", "ber", "state")
ROTATIONS = (1, 1j, -1, -1j)


def executor(cfg: dict, block: int, device):
    from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
    from grbaz_tpu_torch.core.graph import Flowgraph
    from grbaz_tpu_torch.models.auto_fec import AutoFECBlock

    fec = AutoFECBlock(cfg["threshold"], cfg["settle"], cfg["k"],
                       tuple(cfg["polys"]), cfg["overlap"], name="fec",
                       device=device)
    fg = Flowgraph("lrpt")
    fg.input("iq", fec)
    for i, port in enumerate(PORTS):
        fg.output(port, (fec, i))
    return StreamExecutor(fg, {"iq": InputSpec((block,), "complex64",
                                               cfg["symbol_rate"])},
                          device=device)


def _parity(v: torch.Tensor) -> torch.Tensor:
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


def passes(cfg: dict, streams: int, n: int, seed: int, device,
           states=None):
    """(bits [streams, n] uint8, symbols [streams, n] complex64, channel
    states [streams]), made on ``device`` from the seed.

    Each pass: n random bits, cyclic, encoded tail-biting (the register
    wraps round the end), so that a ring of the symbols is one continuous
    coded stream; the code bits (1 as +1) paired into QPSK symbols, the
    first bit of a pair in the real part. Its channel state c, drawn from
    the seed among 16, misaligns the pairs by one code bit (c >> 3:
    symbol i carries code bits 2i + 1 and 2i + 2), conjugates (c >> 2 &
    1) and rotates by 1j^(c & 3); then complex noise of ``noise_rms`` a
    component. ``states`` plants the channel states instead."""
    k, sig = cfg["k"], cfg["signal"]
    if states is None:
        rng = np.random.default_rng([int(seed) % (1 << 63), 23])
        states = rng.integers(0, sig["channel_states"], streams)
    states = np.asarray(states, np.int64)
    gen = signals.seed_generator(seed, device)
    bits = torch.randint(0, 2, (streams, n), generator=gen, device=device)
    # the register at bit i holds bits i-k+1 .. i, the newest at its MSB
    reg = sum(torch.roll(bits, m, 1) << (k - 1 - m) for m in range(k))
    flat = torch.stack([_parity(reg & int(p)) for p in cfg["polys"]],
                       -1).reshape(streams, 2 * n)
    del reg
    st = torch.from_numpy(states).to(device)
    flat = torch.where((st >> 3 == 1)[:, None], torch.roll(flat, -1, 1),
                       flat)
    pairs = flat.reshape(streams, n, 2).to(torch.float32) * 2 - 1
    sym = torch.complex(pairs[..., 0], pairs[..., 1])
    rot = torch.tensor([ROTATIONS[c & 3] for c in states],
                       dtype=torch.complex64, device=device)
    sym = torch.where((st >> 2 & 1 == 1)[:, None], sym.conj(), sym) \
        * rot[:, None]
    noise = torch.randn(streams, n, 2, generator=gen, device=device) \
        * sig["noise_rms"]
    return (bits.to(torch.uint8), sym + torch.view_as_complex(noise),
            states)


def ring(cfg: dict, streams: int, ring_blocks: int, block: int, seed: int,
         device) -> np.ndarray:
    """complex64 [streams, ring_blocks, block] on the host: a pass each."""
    _, sym, _ = passes(cfg, streams, ring_blocks * block, seed, device)
    out = np.empty((streams, ring_blocks, block), np.complex64)
    out[...] = sym.reshape(streams, ring_blocks, block).cpu().numpy()
    return out
