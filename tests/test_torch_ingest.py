"""The port's ingest path on the CPU: BorIP UDP on loopback -> the
port's UDPSampleReceiver (the native engine) -> ``chip_smoke``'s
WireSource, which accumulates partial reads into whole blocks -> the
port's StreamPump -> ``build_wbfm`` (the cascade chain) at a small size.
The audio is bit-equal to the port's Flowgraph over the same quantized
samples and within 1e-4 of the JAX chain's. Every run asserts that no
packet or block was dropped. The sender never runs more than a few
packets ahead of the receiver, and the pump applies back-pressure
(``drop=False``: a CPU chain slowed by other processes would otherwise
drop blocks in the real-time mode), so the runs are deterministic under
load; the card runs the real-time mode (``chip_smoke.ingest_path``).

The JAX package's ingest test (tests/test_ingest_e2e.py) returns None
from its pump source on a short read and so throws partial reads away;
these tests do not.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from grbaz_tpu.core.executor import InputSpec as JInputSpec
from grbaz_tpu.core.executor import StreamExecutor as JExecutor
from grbaz_tpu.models import wbfm as jwbfm
from grbaz_tpu_torch.core.stream import stream_flags
from grbaz_tpu_torch.models.wbfm import WBFMConfig, build_wbfm
from grbaz_tpu_torch.net import udp

FS = 256e3
BLOCK = 1 << 14
STATION_HZ = 40e3
CFG = dict(sample_rate=FS, center_freq=STATION_HZ, decim=4, audio_rate=32e3,
           max_deviation=25e3, channel_width=50e3, transition=25e3,
           block_size=BLOCK, audio_chain="cascade")
AHEAD = 32     # packets the sender may run ahead of the receiver


def station(n, seed=0):
    """An FM station (1 kHz tone, 25 kHz deviation) at STATION_HZ with
    noise, as BorIP ishort wire bytes."""
    t = np.arange(n) / FS
    ph = 2 * np.pi * STATION_HZ * t + 25.0 * np.sin(2 * np.pi * 1e3 * t)
    rng = np.random.default_rng(seed)
    x = 0.5 * np.exp(1j * ph) + 0.005 * (rng.standard_normal(n)
                                         + 1j * rng.standard_normal(n))
    return udp.complex_to_ishort_bytes(x.astype(np.complex64))


def flowgraph_audio(wire):
    """The port's Flowgraph over the samples on the wire (the partial last
    block with its count): audio per block."""
    blocks, counts = cs.wire_blocks(wire, BLOCK, "cpu")
    outs = cs.run_counted(build_wbfm(WBFMConfig(**CFG), device="cpu")[0],
                          blocks, counts, FS)
    return [d[:int(c)].numpy() for d, c in (o["audio"] for o in outs)]


def jax_audio(wire):
    fg, _ = jwbfm.build_wbfm(jwbfm.WBFMConfig(**CFG))
    ex = JExecutor(fg, {"iq": JInputSpec((BLOCK,), "complex64", FS)})
    blocks, counts = cs.wire_blocks(wire, BLOCK, "cpu")
    out = []
    for b, c in zip(blocks, counts):
        d, k = ex.step({"iq": b.numpy()}, counts={"iq": c})["audio"]
        out.append(np.asarray(d)[:k])
    return out


@pytest.fixture(scope="module")
def executor():
    return cs.ingest_executor(WBFMConfig(**CFG), torch.device("cpu"))


@pytest.mark.parametrize("case", ["paced", "irregular_bursts"])
def test_borip_udp_to_wbfm_audio(executor, case):
    n = 6 * BLOCK + 5000        # a partial last block
    wire = station(n)
    send = dict(ahead=AHEAD, drop=False)
    if case == "paced":
        rate = 4e6
    else:   # bursts of packet counts that land reads mid-block
        rate, send["bursts"] = None, (1, 7, 3, 29, 2, 13, 64, 5)
    run = cs.ingest_run(executor, wire, rate, **send)
    ref = flowgraph_audio(wire)
    cs.check_ingest(run, ref, f"ingest {case}")
    assert run["full_blocks"] == 6 and run["partial"] == 1
    got = np.concatenate(run["audio"])
    want = np.concatenate(jax_audio(wire))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    f, sinad = cs.tone_sinad(np.concatenate(run["audio"][1:]), 32e3)
    assert abs(f - 1000.0) < 5.0 and sinad > 30.0, (f, sinad)


class _Rx:
    """A receiver that hands out given reads (payloads and flags)."""

    def __init__(self, reads):
        self.reads = list(reads)

    def read_complex(self, max_samples):
        if not self.reads:
            return np.zeros(0, np.complex64), 0
        x, flags = self.reads.pop(0)
        assert len(x) <= max_samples
        return x, flags


def test_wire_source_keeps_every_partial_read():
    """Reads of any length, a block ending mid-read, the end flagged
    before the last data was read (the receiver's flags are sticky over
    packets it has not handed out): every sample comes out once, in
    order, the rest as a partial block with its count."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(3 * 100 + 37)).astype(np.complex64)
    sizes, off, reads = [1, 40, 99, 3, 77, 50, 30], 0, []
    for k in sizes:
        reads.append((x[off:off + k], 0))
        off += k
    reads[3] = (reads[3][0], stream_flags.STREAM_END)  # sticky, early
    reads.append((x[off:], 0))
    src = cs.WireSource(_Rx(reads), 100)
    blocks = []
    for _ in range(40):
        got = src()
        if got is not None:
            blocks.append(got)
    full = [b["iq"] for b in blocks if isinstance(b, dict)]
    part = [b for b in blocks if isinstance(b, tuple)]
    assert len(full) == 3 and len(part) == 1 and src.done
    (pad,), (count,) = part[0][0].values(), part[0][1].values()
    assert count == 37 and np.all(pad[37:] == 0)
    np.testing.assert_array_equal(np.concatenate(full + [pad[:37]]), x)
