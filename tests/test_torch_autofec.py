"""The port's auto_fec, fec_sync and ACARS formatting == the JAX
package's, on the CPU.

``fec_eval`` gives the same bits and BER for all 32 transforms (rotation x
conjugation x delay x swap), ``AutoFEC`` locks at the same block and step
as the JAX controller on tests/test_autofec_fsk4.py's streams, and the
host-only copies (``models/fec_sync.py``, ``utils/acars.py``) behave as the
JAX package's.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.models import auto_fec as ja
from grbaz_tpu.models import fec_sync as js
from grbaz_tpu.ops.fec import conv_encode
from grbaz_tpu.utils import acars as jacars
from grbaz_tpu_torch.models import auto_fec as ta
from grbaz_tpu_torch.models import fec_sync as ts
from grbaz_tpu_torch.utils import acars as tacars

import chip_smoke
from test_autofec_fsk4 import make_qpsk_stream
from test_torch_decode import same


def test_reencode_is_the_encoder():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 500).astype(np.uint8)
    for k, polys in ((7, (0o171, 0o133)), (5, (0o23, 0o35))):
        np.testing.assert_array_equal(
            ta.reencode(torch.from_numpy(bits), k, polys).numpy(),
            conv_encode(bits, k, polys))


@pytest.mark.parametrize("rotation,conjugate,delay,swap", list(
    itertools.product(range(4), (False, True), (False, True), (False, True))))
def test_fec_eval_matches_jax(rotation, conjugate, delay, swap):
    rng = np.random.default_rng(8 * rotation + 4 * conjugate + 2 * delay
                                + swap)
    bits = rng.integers(0, 2, 384).astype(np.uint8)
    sym = make_qpsk_stream(bits, 3, True, noise=0.3, seed=rotation)
    # jitted, as AutoFEC calls it (XLA turns the BER's division by a
    # constant into a product with its reciprocal)
    jb, jber = jax.jit(ja.fec_eval)(jnp.asarray(sym), jnp.int32(rotation),
                                    jnp.bool_(conjugate), jnp.bool_(delay),
                                    jnp.bool_(swap))
    tb, tber = ta.fec_eval(torch.from_numpy(sym), rotation, conjugate, delay,
                           swap)
    assert same(np.asarray(jb), tb.numpy())
    assert same(np.asarray(jber), tber.numpy())


def lock_run(mod, rotation, conjugate, **kw):
    """tests/test_autofec_fsk4.py:test_autofec_locks' loop: (block locked
    at, steps, transform, last BER)."""
    rng = np.random.default_rng(42)
    afec = mod.AutoFEC(threshold=0.05, settle=2, **kw)
    for blk in range(40):
        bits = rng.integers(0, 2, 2048).astype(np.uint8)
        _, ber, locked = afec.feed(make_qpsk_stream(bits, rotation, conjugate,
                                                    seed=blk))
        if locked:
            break
    return (blk, afec.steps, afec.rotation, afec.conjugate, afec.vit_delay,
            afec.vit_swap, ber)


@pytest.mark.parametrize("rotation,conjugate", [(0, False), (2, False),
                                                (1, True), (3, True)])
def test_autofec_locks_as_jax(rotation, conjugate):
    jr = lock_run(ja, rotation, conjugate)
    tr = lock_run(ta, rotation, conjugate, device="cpu")
    assert jr == tr
    assert tr[-1] < 0.05


def test_autofec_relocks_after_change():
    # tests/test_autofec_fsk4.py:test_autofec_relocks_after_change, both
    # controllers side by side
    rng = np.random.default_rng(1)
    ctl = [ja.AutoFEC(threshold=0.05, settle=1),
           ta.AutoFEC(threshold=0.05, settle=1, device="cpu")]
    for blk in range(20):
        sym = make_qpsk_stream(rng.integers(0, 2, 1024).astype(np.uint8), 0,
                               False, seed=blk)
        res = [c.feed(sym) for c in ctl]
        assert res[0][1:] == res[1][1:]
        if res[1][2]:
            break
    for blk in range(40):
        sym = make_qpsk_stream(rng.integers(0, 2, 1024).astype(np.uint8), 2,
                               False, seed=100 + blk)
        res = [c.feed(sym) for c in ctl]
        assert res[0][1:] == res[1][1:]
        assert same(np.asarray(res[0][0]), res[1][0].numpy())
        if res[1][2] and res[1][1] < 0.05:
            break
    assert ctl[1].locked and ctl[1].last_ber < 0.05
    assert ctl[0].steps == ctl[1].steps


def test_fec_sync_xform_odometer_order():
    # tests/test_mux_misc_compat.py:124-143 on both copies
    for mod in (js, ts):
        x, ref = mod.FECSyncXform(), mod.FECSyncXform()
        more, ch = x.next(ref, 2)
        assert more and x.puncture_delay == 1
        more, ch = x.next(ref, 2)
        assert more and x.puncture_delay == 0
        assert mod.CHANGE_ROTATION in ch and x.rotation == 1
        more, ch = x.next(ref, 2)
        assert x.puncture_delay == 1 and x.rotation == 1
        more, ch = x.next(ref, 2)
        assert mod.CHANGE_CONJUGATION in ch and x.conjugate is False
        more, _ = x.next(ref, 2)
        assert more
        for _ in range(3):
            more, _ = x.next(ref, 2)
        assert not more


def test_fec_sync_locks_and_times_out():
    # tests/test_mux_misc_compat.py:146-167, the two copies in step
    logs = []
    for mod in (js, ts):
        clock, applied = [0.0], []
        fs = mod.FECSync(lambda c, r, d, ch: applied.append((c, r, d, ch)),
                         depunc_length=2, trial_duration=1.0,
                         lock_timeout=5.0, time_fn=lambda: clock[0])
        log = [len(applied)]
        clock[0] = 1.5
        fs.handle_clock()
        log.append((len(applied), fs.locked))
        fs.handle_pdu()
        log.append((fs.locked, fs.xform_lock.puncture_delay,
                    fs.xform_search.puncture_delay))
        clock[0] = 4.0
        fs.handle_clock()
        log.append((fs.locked, len(applied)))
        clock[0] = 20.0
        fs.handle_clock()
        log.append((fs.locked, len(applied)))
        fs.handle_status()
        log.append((fs.status_count, fs.locked, fs.pdu_count, applied))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][0] == 1 and logs[1][2][0] and not logs[1][4][0]


def test_acars_formatting_matches_jax():
    rng = np.random.default_rng(9)
    rows = []
    for text in (b"", b"SHORT", b"M01AXA1234 POS N47 W122", b"\x7f\x03"):
        pay = chip_smoke.acars_payload(rng, text)
        row = np.zeros(254, np.float32)
        row[0], row[1] = len(pay), int(rng.integers(0, 3))
        row[2:2 + len(pay)] = pay
        rows.append(row)
    short = np.zeros(254, np.float32)
    short[0] = 5
    rows.append(short)
    for row in rows:
        assert jacars.parse_packet(row) == tacars.parse_packet(row)
        assert jacars.format_packet(row) == tacars.format_packet(row)


def test_chip_smoke_fec_scene_decodes_on_the_cpu():
    # the FEC path's scene at a small block: the transform that undoes
    # the channel decodes the planted bits (up to the complement)
    sym, bits = chip_smoke.fec_scene("cpu", 1)
    n = 4096
    rot, conj = chip_smoke.FEC_LOCKED
    got, ber = ta.fec_eval(sym[:n], rot, conj, False, False)
    assert chip_smoke.bit_errors(got.numpy(), bits[:n]) == 0.0
    assert float(ber) < 0.02
