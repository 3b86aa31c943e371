"""Port misc blocks (ops/misc.py) == grbaz_tpu on the CPU.

``FastrakDecoder``'s plain version (``misc.fastrak_fsm_plain``, a host loop
of ``ft_step``) is held bit for bit to the JAX block's scan: event rows,
event count and the whole state, over chained blocks. The numpy model of
its kernel's speculative walk is in ``test_torch_fsm_speculation.py``,
which the machine with the card (no JAX) imports too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from grbaz_tpu.ops import misc as jm
from grbaz_tpu_torch.convert import to_numpy
from grbaz_tpu_torch.ops import misc as tm
from tests.torch_parity import jax_run, port_run, split

CPU = "cpu"


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def assert_outputs(jo, to):
    assert len(jo) == len(to)
    for j, t in zip(jo, to):
        for (jd, jc), (td, tc) in zip(j, t):
            assert jc == tc
            assert jd.shape == td.shape, (jd.shape, td.shape)
            if jd.dtype == np.float32:
                np.testing.assert_array_equal(bits(jd), bits(td))
            else:
                np.testing.assert_array_equal(jd, td)


def assert_state(js, ts):
    for k, v in js.items():
        np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)


# ---------------------------------------------------------------------------
# the small blocks
# ---------------------------------------------------------------------------

def test_matrix_interleaver(rng):
    vi, vo = 4, 3
    x = (rng.standard_normal((24, vi)) + 1j * rng.standard_normal((24, vi))
         ).astype(np.complex64)
    blocks, _ = split(x, 12)
    jo, _ = jax_run(jm.MatrixInterleaver(vi, vo), blocks, [12, 7])
    to, _ = port_run(tm.MatrixInterleaver(vi, vo), blocks, [12, 7])
    assert_outputs(jo, to)
    assert [o[0][1] for o in to] == [16, 8]


def test_crc16_matches_jax():
    crcs = [0, 1, 0x1D0F, 0xFFFF, 0x8408]
    for crc in crcs:
        for byte in (0, 0x5A, 0xFF):
            want = int(jm._crc16_ccitt_update(jnp.int32(crc), jnp.int32(byte)))
            assert tm._crc16_ccitt_update(crc, byte) == want
            assert int(tm._crc16_ccitt_update(torch.tensor(crc),
                                              torch.tensor(byte))) == want


def test_test_counter_counts_drops_across_blocks(rng):
    x = np.arange(1024, dtype=np.float32)
    x[300:] += 50.0          # a jump inside block 1
    x[512] = 7.0             # a corrupt value at block 2's head
    blocks, _ = split(x, 256)
    counts = [256, 256, 256, 200]
    jo, js = jax_run(jm.TestCounter(), blocks, counts)
    to, ts = port_run(tm.TestCounter(device=CPU), blocks, counts)
    assert_outputs(jo, to)
    assert_state(js, ts)
    assert int(ts["errors"]) == 3


def test_swap_ff(rng):
    x = rng.standard_normal(512).astype(np.float32)
    blocks, _ = split(x, 128)
    for swap in (True, False):
        params = dict(swap=np.bool_(swap))
        jo, _ = jax_run(jm.SwapFF(), blocks, [128, 128, 128, 60],
                        params=params)
        tblk = tm.SwapFF(swap, device=CPU)
        to, _ = port_run(tblk, blocks, [128, 128, 128, 60])
        assert_outputs(jo, to)


def test_field_tracker_holds_the_latest_mark_across_blocks(rng):
    n = 640
    sig = rng.standard_normal(n).astype(np.float32)
    even = np.zeros(n, np.float32)
    odd = np.zeros(n, np.float32)
    even[[10, 300, 450]] = 1.0
    odd[[60, 200, 451, 600]] = 1.0
    ins = list(zip(*(split(a, 128)[0] for a in (sig, even, odd))))
    # a partial count: the carried parity is still the block's last
    # sample's (the JAX block ignores the count there)
    counts = [(128,) * 3, (128,) * 3, (40,) * 3, (128,) * 3, (128,) * 3]
    jo, js = jax_run(jm.FieldTracker(), ins, counts)
    to, ts = port_run(tm.FieldTracker(device=CPU), ins, counts)
    assert_outputs(jo, to)
    assert_state(js, ts)
    assert float(ts["parity"]) == -1.0


def test_block_status_reports_on_interval(rng):
    x = rng.standard_normal(1024).astype(np.float32)
    blocks, _ = split(x, 128)
    counts = [128, 128, 100, 128, 128, 128, 128, 128]
    jo, js = jax_run(jm.BlockStatus(256), blocks, counts)
    to, ts = port_run(tm.BlockStatus(256, device=CPU), blocks, counts)
    assert_outputs(jo, to)
    assert_state(js, ts)
    assert [o[1][1] for o in to] == [0, 1, 0, 0, 1, 0, 1, 0]


# ---------------------------------------------------------------------------
# FastrakDecoder's plain version == the JAX scan
# ---------------------------------------------------------------------------

def frames_signal(ids, os_, gap=50, bad=(), lead=50):
    """(metric, sync): the JAX tests' frames (+-1 bits held ``os_``
    samples, a sync spike of 5.0 at each frame's start), ``gap`` idle
    samples between frames; frames whose index is in ``bad`` carry a
    wrong CRC."""
    metric, sync = [-np.ones(lead, np.float32)], [np.zeros(lead, np.float32)]
    for k, tid in enumerate(ids):
        m = np.repeat(np.array(chip_smoke.fastrak_bits(tid, k not in bad),
                               np.float32) * 2 - 1, os_)
        s = np.zeros_like(m)
        s[0] = 5.0
        metric += [m, -np.ones(gap, np.float32)]
        sync += [s, np.zeros(gap, np.float32)]
    return np.concatenate(metric), np.concatenate(sync)


def fastrak_both(metric, sync, bs, os_, counts=None, thr=1.0):
    """Both blocks over ``metric``/``sync`` cut into blocks of ``bs``:
    outputs, states."""
    mb, cs = split(metric, bs)
    sb, _ = split(sync, bs)
    cs = counts or cs
    ins = list(zip(mb, sb))
    jo, js = jax_run(jm.FastrakDecoder(thr, os_), ins, cs)
    to, ts = port_run(tm.FastrakDecoder(thr, os_, device=CPU), ins, cs)
    return jo, js, to, ts


def test_fastrak_decodes_the_jax_tests_frames():
    """tests/test_misc_obs.py's frames: one ID, then the same frame again
    (the count climbs), and a bad CRC that emits nothing."""
    metric, sync = frames_signal([0x12345678, 0x12345678, 0xDEADBEEF], 4,
                                 bad=(2,))
    jo, js, to, ts = fastrak_both(metric, sync, len(metric), 4)
    assert_outputs(jo, to)
    assert_state(js, ts)
    ev, count = to[0][0]
    assert count == 2
    assert [(int(r[0]) << 16 | int(r[1]), int(r[2])) for r in ev[:2]] == \
        [(0x12345678, 1), (0x12345678, 2)]


@pytest.mark.parametrize("bs", [200, 333, 1024])
def test_fastrak_frames_split_across_blocks(rng, bs):
    """Frames cut by block boundaries at every phase, IDs repeated and
    changing, a bad CRC; partial counts are ignored, as in the JAX
    block (it walks every sample)."""
    ids = [0x12345678] * 3 + [0xCAFEBABE] * 2 + [0x12345678]
    metric, sync = frames_signal(ids, 4, gap=37, bad=(3,))
    metric = metric + 0.1 * rng.standard_normal(len(metric)).astype(
        np.float32)
    n_blocks = -(-len(metric) // bs)
    counts = [bs if b % 2 == 0 else bs // 3 for b in range(n_blocks)]
    jo, js, to, ts = fastrak_both(metric, sync, bs, 4, counts)
    assert_outputs(jo, to)
    assert_state(js, ts)
    got = [(int(r[0]) << 16 | int(r[1]), int(r[2]))
           for o in to for r in o[0][0][:o[0][1]]]
    assert got == [(0x12345678, 1), (0x12345678, 2), (0x12345678, 3),
                   (0xCAFEBABE, 1), (0x12345678, 1)]


def test_fastrak_more_than_32_frames_sum_into_the_last_row():
    ids = [0x00010002 + k for k in range(20)] + [0xFFFF0001] * 30
    metric, sync = frames_signal(ids, 1, gap=3)
    jo, js, to, ts = fastrak_both(metric, sync, len(metric), 1)
    assert_outputs(jo, to)
    assert_state(js, ts)
    assert to[0][0][1] == 32


@pytest.mark.parametrize("os_,gap", [(8, (1, 200)), (2, (0, 3))])
def test_fastrak_plain_equals_jax_on_noisy_rows(rng, os_, gap):
    """chip_smoke's generator: decoy syncs, bad sync words, bad types and
    bad CRCs, frames cut by the block edges."""
    metric, sync = chip_smoke.fastrak_rows(rng, 1, 3 * 2048, os_, gap)
    jo, js, to, ts = fastrak_both(metric[0], sync[0], 2048, os_)
    assert_outputs(jo, to)
    assert_state(js, ts)
    assert sum(o[0][1] for o in to) > 0


def test_chip_smoke_fastrak_path_decodes_on_the_cpu():
    """chip_smoke.py's FasTrak scene and graph (envelope, matched filter,
    alignment, decoder), rehearsed on the CPU over its first two blocks:
    every planted passing ID with its repeat count, the bad CRC and the
    decoy not."""
    dev = torch.device(CPU)
    iq, expect = chip_smoke.fastrak_scene(dev)
    n = chip_smoke.BLOCK
    outs, _, _ = chip_smoke.run_inputs(
        chip_smoke.fastrak_graph(CPU), [dict(iq=iq[b * n:(b + 1) * n])
                                        for b in range(2)],
        chip_smoke.FT_FS)
    got = chip_smoke.fastrak_ids(outs)
    assert got == expect[:len(got)] and len(got) == 2 * chip_smoke.FT_FRAMES
    assert max(c for _, c in got) > 1
