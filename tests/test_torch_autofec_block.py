"""``AutoFECBlock``, auto_fec on the served path, on the CPU (the plain
backend, blocks of 2^10 symbols): block by block equal to the LRPT
deployment's plain reference (``radiobench/reference/lrpt.py``), locked
on the planted bits, re-transforming its raw carry on a retune, stepping
the same search as ``AutoFEC.feed``, and served through
``StreamExecutor`` and ``StreamPump``."""

import time

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.core.pump import StreamPump
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.models import auto_fec
from grbaz_tpu_torch.models.auto_fec import AutoFEC, AutoFECBlock, FECSearch
from radiobench import manifest
from radiobench.configs import lrpt
from radiobench.reference import lrpt as ref

N = 1 << 10
RING = 4
BLOCKS = 24
CPU = torch.device("cpu")
CFG = manifest.config("lrpt")
# channel states (lrpt.passes): none; rotation 1 and conjugation;
# rotation 2 and the misaligned pairs; all three axes at once
CHANNELS = [0, 5, 10, 15]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_block(**kw):
    args = dict(threshold=CFG["threshold"], settle=CFG["settle"], k=CFG["k"],
                polys=tuple(CFG["polys"]), overlap=CFG["overlap"])
    args.update(kw)
    return AutoFECBlock(device="cpu", **args)


def make_ring(channel, seed=2 ** 31 + 23):
    """(ring [RING, N] complex64, the planted bits [RING, N])."""
    bits, sym, _ = lrpt.passes(CFG, 1, RING * N, seed, CPU,
                               states=[channel])
    ring = np.empty((1, RING, N), np.complex64)
    ring[...] = sym.reshape(1, RING, N).numpy()
    return ring[0], bits.reshape(RING, N).numpy()


def run_block(blk, ring, blocks):
    """Each block's outputs {port: numpy}, stepped through ``apply``."""
    st, got = blk.init_state(), []
    for j in range(blocks):
        st, outs = blk.apply(st, None, Stream.full(
            torch.from_numpy(ring[j % len(ring)]), sample_rate=72e3))
        got.append({p: o.data.numpy() for p, o in zip(lrpt.PORTS, outs)})
    return got


@pytest.fixture(scope="module", params=CHANNELS)
def served(request):
    torch.set_num_threads(2)
    ring, bits = make_ring(request.param)
    return ring, bits, run_block(make_block(), ring, BLOCKS)


def test_block_matches_the_reference(served):
    ring, _, got = served
    for j, outs in enumerate(got):
        want = ref.outputs(CFG, ring, j, "f64", CPU)
        nums = ref.numbers({p: (v, len(v)) for p, v in outs.items()}, want)
        assert nums["pm_gap"] <= 1e-6, (j, nums)
        assert {k: v for k, v in nums.items() if k != "pm_gap"} == dict(
            bit_miss=0, ber_gap=0, state_miss=0, count_miss=0), (j, nums)


def test_search_locks_and_decodes_the_planted_bits(served):
    ring, bits, got = served
    states = [FECSearch.unpack(int(o["state"][0])) for o in got]
    lock = next(j for j, (_, locked, _) in enumerate(states) if locked)
    assert lock < 34
    for j in range(lock + 1, BLOCKS):
        assert states[j][1], j
        want = bits[j % RING]
        errs = min(np.mean(got[j]["bits"] != want),
                   np.mean(got[j]["bits"] != 1 - want))
        assert errs < 1e-3 and got[j]["ber"][0] < CFG["threshold"], (j, errs)


def test_retune_retransforms_the_carried_tail():
    """The carry is raw symbols: after a retune the warm-up pairs are the
    new transform's. A short warm-up makes the block's first bits depend
    on them."""
    ov, new = 8, 8 + 3            # the delay on, rotation 3
    blk = make_block(overlap=ov)
    ring, _ = make_ring(15)
    st, _ = blk.apply(blk.init_state(), None,
                      Stream.full(torch.from_numpy(ring[0])))
    assert torch.equal(st["carry"], torch.from_numpy(ring[0][-ov - 1:]))
    st["search"] = torch.tensor([FECSearch.pack(new, False, 0)],
                                dtype=torch.int32)
    _, outs = blk.apply(st, None, Stream.full(torch.from_numpy(ring[1])))
    raw = torch.cat([st["carry"], torch.from_numpy(ring[1])])
    exp = ref.trellis(CFG["k"], CFG["polys"])
    bits, pm = ref.viterbi(ref.transform(raw, new)[None], exp)
    assert torch.equal(outs[1].data, bits[0, ov:])
    assert torch.equal(outs[0].data, pm[0])
    # the pairs of block 0's transform (0) kept for the tail would have
    # decoded otherwise
    stale = torch.cat([ref.transform(raw, 0)[:ov],
                       ref.transform(raw, new)[ov:]])
    sbits, spm = ref.viterbi(stale[None], exp)
    assert not (torch.equal(sbits[0, ov:], bits[0, ov:])
                and torch.equal(spm, pm))


def test_feed_and_block_step_the_same_transforms(monkeypatch):
    """Given the same BERs, ``AutoFEC.feed``, the block and the
    reference's plain search step the same states; the float32 BER is
    compared in float64 (float32(0.4) is above the unlock level, NaN
    neither below nor above)."""
    f32 = np.float32
    bers = ([0.3] * 5 + [0.01, 0.2, 0.01, 0.02, 0.03, f32(0.4), 0.5]
            + [0.04] * 3 + [f32(0.05), 0.049, 0.01, float("nan"), 0.39,
                            np.nextafter(f32(0.4), f32(0)), 0.41]
            + [0.5] * 20 + [float("nan")] + [0.5] * 19 + [0.0] * 3)
    bers = [f32(b) for b in bers]
    it = iter(bers)
    monkeypatch.setattr(auto_fec, "fec_eval", lambda sym, *a: (
        torch.zeros(len(sym), dtype=torch.uint8),
        torch.tensor(next(it), dtype=torch.float32)))
    afec = AutoFEC(threshold=0.05, settle=2, device="cpu")
    blk = make_block()
    feed_bers = iter(bers)
    monkeypatch.setattr(auto_fec, "fec_ber", lambda *a: torch.tensor(
        [next(feed_bers)], dtype=torch.float32))
    st, plain = blk.init_state(), (0, False, 0)
    sym = torch.zeros(64, dtype=torch.complex64)
    for b in bers:
        _, _, locked = afec.feed(sym)
        st, outs = blk.apply(st, None, Stream.full(sym))
        plain = ref.search(plain, float(b), 0.05, 2)
        assert int(outs[3].data[0]) == afec.state == ref.pack(plain), b
        assert locked == plain[1]
    assert afec.steps == 5 + 1 + 1 + 40 and afec.locked


def test_block_served_through_executor_and_pump():
    ring, _ = make_ring(10)
    fec = make_block(name="fec")
    fg = Flowgraph("lrpt")
    fg.input("iq", fec)
    for i, port in enumerate(lrpt.PORTS):
        fg.output(port, (fec, i))
    ex = StreamExecutor(fg, {"iq": InputSpec((N,), "complex64", 72e3)},
                        device="cpu")
    n_blocks = 14
    feed = [{"iq": ring[j % RING]} for j in range(n_blocks)]
    got = []
    pump = StreamPump(ex, lambda: feed.pop(0) if feed else None,
                      {p: (lambda p: lambda d, c: got.append((p, d, c)))(p)
                       for p in lrpt.PORTS}, depth=2, inflight=3)
    pump.start()
    deadline = time.monotonic() + 60
    while pump.stats()["blocks_out"] < n_blocks \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    pump.stop()
    assert pump.stats()["blocks_out"] == n_blocks
    assert [p for p, _, _ in got] == list(lrpt.PORTS) * n_blocks
    for j in range(n_blocks):
        outs = {p: (d, c) for p, d, c in got[4 * j:4 * j + 4]}
        nums = ref.numbers(outs, ref.outputs(CFG, ring, j, "f64", CPU))
        assert nums == dict(pm_gap=0.0, bit_miss=0, ber_gap=0.0,
                            state_miss=0, count_miss=0), (j, nums)
