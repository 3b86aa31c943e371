"""Port DynamicChannelBank (BASELINE config 5) == grbaz_tpu, and the
plain version of the bank's kernel == B1's plain twin slot by slot."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core import checkpoint as jckpt
from grbaz_tpu.parallel.channel_bank import DynamicChannelBank as JBank
from grbaz_tpu_torch.convert import to_numpy
from grbaz_tpu_torch.core import checkpoint as tckpt
from grbaz_tpu_torch.ops import exact, fir
from grbaz_tpu_torch.ops.cuda import channel_bank as cb
from grbaz_tpu_torch.ops.cuda import xlating_fir as xf
from grbaz_tpu_torch.parallel.channel_bank import DynamicChannelBank
from tests.torch_parity import jax_run, port_run

CPU = "cpu"
FS = 3.2e6
KW = dict(sample_rate=FS, decim=8, channel_width=150e3, transition=75e3)


def _wideband(n, seed=0):
    """Noise plus three FM stations."""
    gen = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.1 * (gen.standard_normal(n) + 1j * gen.standard_normal(n))
    for f0, tone in ((400e3, 1e3), (-600e3, 2.5e3), (1.1e6, 700.0)):
        x = x + np.exp(1j * (2 * np.pi * f0 / FS * t
                             + 3.0 * np.sin(2 * np.pi * tone / FS * t)))
    return x.astype(np.complex64)


def _script(bank, params, b):
    """Host control before block b: channels added, one removed, one
    retuned, the freed slot reused at a new frequency."""
    if b == 0:
        for f in (400e3, -600e3, 1.1e6):
            bank.add_channel(params, f)
    elif b == 2:
        bank.remove_channel(params, 1)
    elif b == 3:
        bank.retune(params, 0, -610e3)
    elif b == 4:
        assert bank.add_channel(params, 395e3) == 1


def _run_both(backend, n, counts, capacity=4):
    x = _wideband(n * 6)  # the same samples for any number of blocks
    jb, tb = JBank(capacity, **KW), DynamicChannelBank(
        capacity, **KW, backend=backend, device=CPU)
    jpr, tpr = jb.init_params(), tb.init_params()
    jst = jax.tree_util.tree_map(jnp.asarray, jb.init_state())
    tst = tb.init_state()
    outs = []
    for b, c in enumerate(counts):
        _script(jb, jpr, b)
        _script(tb, tpr, b)
        xb = [x[b * n:(b + 1) * n]]
        (jo,), jst = jax_run(jb, xb, [c], state=jst, params=jpr, rate=FS)
        (to,), tst = port_run(tb, xb, [c], state=tst, params=tpr, rate=FS)
        outs.append((jo, to))
    assert jb.channels() == tb.channels()
    return outs, jst, tst


@pytest.mark.parametrize("backend", ["plain", "kernel"])
@pytest.mark.parametrize("n,counts", [(4096, (4096,) * 6),
                                      (2048, (2048, 2048, 1000, 2048, 2048,
                                              700)),
                                      (64, (64,) * 6)])
def test_bank_matches_jax_with_add_remove_retune_reuse(backend, n, counts):
    """Six blocks with channels added, removed, retuned and a slot reused
    (partial blocks where count < capacity; blocks shorter than the
    filter's history): quad within 1e-4 of its max, the active flags
    equal, state within f32. The kernel arm (the bank kernel's wrapper,
    its plain version on the CPU) holds the JAX package's rotated tail
    through the retune."""
    outs, jst, tst = _run_both(backend, n, counts)
    for jo, to in outs:
        (jq, jc), (ja, _) = jo
        (tq, tc), (ta, _) = to
        assert jc == tc and tq.shape == jq.shape and tq.dtype == np.float32
        assert np.abs(tq - jq).max() <= 1e-4 * max(np.abs(jq).max(), 1e-6)
        np.testing.assert_array_equal(ja, ta)
        assert ta.dtype == np.uint8
    assert np.abs(outs[-1][1][0][0]).max() > 0.1
    port = to_numpy(tst)
    np.testing.assert_array_equal(np.asarray(jst["phase"]), port["phase"])
    for k in ("tail", "prev"):
        ref = np.asarray(jst[k])
        assert np.abs(port[k] - ref).max() <= 1e-5 * np.abs(ref).max(), k


def test_bank_inactive_slots_are_zero_and_frozen():
    outs, jst, tst = _run_both("kernel", 2048, (2048,) * 4, capacity=6)
    for _, to in outs:
        assert not to[0][0][3:].any()
    assert not tst["tail"][3:].any()
    assert torch.equal(tst["prev"][3:], torch.ones(3, dtype=torch.complex64))
    # slot 1 went inactive before block 2: its state froze there
    outs2, _, tst2 = _run_both("kernel", 2048, (2048,) * 2, capacity=6)
    assert torch.equal(tst["phase"][1], tst2["phase"][1])
    assert torch.equal(tst["tail"][1], tst2["tail"][1])


def test_bank_host_api_writes_params_in_place():
    bank = DynamicChannelBank(2, **KW, device=CPU)
    pr = bank.init_params()
    lo, act = pr["lo_inc"], pr["active"]
    s = bank.add_channel(pr, 250e3)
    assert pr["lo_inc"] is lo and pr["active"] is act
    jb = JBank(2, **KW)
    jpr = jb.init_params()
    jb.add_channel(jpr, 250e3)
    np.testing.assert_array_equal(to_numpy(pr)["lo_inc"], jpr["lo_inc"])
    np.testing.assert_array_equal(act.numpy(), jpr["active"])
    bank.add_channel(pr, -250e3)
    with pytest.raises(RuntimeError, match="capacity"):
        bank.add_channel(pr, 0.0)
    bank.remove_channel(pr, s)
    with pytest.raises(KeyError):
        bank.retune(pr, s, 1e5)
    assert bank.channels() == {1: -250e3}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bank_checkpoint_loads_both_ways(tmp_path, direction):
    """State and params saved after 3 blocks by one package continue in
    the other, to the first package's outputs."""
    n = 4096
    x = _wideband(6 * n, seed=4)
    blocks = [x[b * n:(b + 1) * n] for b in range(6)]
    jb, tb = JBank(4, **KW), DynamicChannelBank(4, **KW, device=CPU)
    jpr, tpr = jb.init_params(), tb.init_params()
    for f in (400e3, -600e3, 1.1e6):
        jb.add_channel(jpr, f)
        tb.add_channel(tpr, f)
    p = str(tmp_path / "bank.npz")
    if direction == "jax_to_port":
        jo, jst = jax_run(jb, blocks, params=jpr, rate=FS)
        _, mid = jax_run(jb, blocks[:3], params=jpr, rate=FS)
        jckpt.save_state(p, {"bank": mid}, {"bank": jpr})
        st, pr, _ = tckpt.load_state(p, {"bank": tb.init_state()},
                                     {"bank": tb.init_params()})
        assert st["bank"]["phase"].dtype == torch.int64
        to, _ = port_run(tb, blocks[3:], state=st["bank"],
                         params=pr["bank"], rate=FS)
        got, want = to, jo[3:]
    else:
        to, _ = port_run(tb, blocks, params=tpr, rate=FS)
        _, mid = port_run(tb, blocks[:3], params=tpr, rate=FS)
        tckpt.save_state(p, {"bank": mid}, {"bank": tpr})
        st, pr, _ = jckpt.load_state(p, {"bank": jb.init_state()},
                                     {"bank": jb.init_params()})
        assert np.asarray(st["bank"]["phase"]).dtype == np.uint32
        jo, _ = jax_run(jb, blocks[3:], state=jax.tree_util.tree_map(
            jnp.asarray, st["bank"]), params=pr["bank"], rate=FS)
        got, want = jo, to[3:]
    for g, w in zip(got, want):
        assert np.abs(g[0][0] - w[0][0]).max() <= 1e-4 * np.abs(w[0][0]).max()


@pytest.mark.parametrize("slots", [1, 3, 16, 20])
@pytest.mark.parametrize("n,decim", [(4096, 8), (1000, 4), (37, 8)])
def test_channel_bank_plain_equals_per_slot_b1_plain(slots, n, decim):
    """The bank kernel's plain version: slot c's outputs equal B1's plain
    twin over the slot's rotated tail derotated under its phase and
    increment (the tail [0, tail[c] * conj(lo)]) within 1e-5 of their
    max, at wrap-heavy phases and increments; the new tail is the last
    tpad-1 samples of [tail[c], x * lo] (the old tail's remainder first
    when n < tpad-1), within f32 rounding of the LO."""
    gen = np.random.default_rng(slots + n)
    h = torch.from_numpy(fir.prepare_taps(
        fir.low_pass_taps(1.0, FS, 112.5e3, 75e3), decim))
    hist = h.shape[0] - 1
    tail = torch.from_numpy((gen.standard_normal((slots, hist))
                             + 1j * gen.standard_normal((slots, hist)))
                            .astype(np.complex64))
    x = torch.from_numpy((gen.standard_normal(n) + 1j
                          * gen.standard_normal(n)).astype(np.complex64))
    ph = torch.from_numpy(gen.integers(2 ** 32 - 4096, 2 ** 32, slots))
    inc = torch.from_numpy(gen.integers(2 ** 31, 2 ** 32, slots))
    y, new_tail = cb.channel_bank(x, tail, h, decim, ph, inc)
    assert y.shape == (slots, n // decim)
    assert new_tail.shape == tail.shape
    past = torch.arange(-hist, 0)
    for c in range(slots):
        unrot = tail[c] * exact.lo_at(ph[c], inc[c], past, conj=True)
        ref = xf.xlating_fir_block_plain(
            x, torch.cat([torch.zeros(1, dtype=torch.complex64), unrot]), h,
            decim, ph[c], inc[c])
        if n // decim:
            assert (y[c] - ref).abs().max() <= 1e-5 * ref.abs().max()
        frame = torch.cat([tail[c], x * exact.lo_at(ph[c], inc[c],
                                                    torch.arange(n))])
        want = frame[-hist:]
        assert (new_tail[c] - want).abs().max() <= 1e-6 * want.abs().max()
