"""Port Burster (interval and trigger modes), Merge after it, and
HopperDemux == grbaz_tpu on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.ops import burst as jb
from grbaz_tpu.ops.hopper import HopperDemux as JHopper
from grbaz_tpu_torch.ops import burst as tb
from grbaz_tpu_torch.ops.hopper import HopperDemux
from tests.test_torch_burst import assert_same_outputs, assert_same_state
from tests.torch_parity import jax_run, port_run

CPU = "cpu"


def cnoise(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


@pytest.mark.parametrize("length,interval,bs,cap", [
    (4, 10, 32, 8), (16, 100, 256, 4), (64, 37, 256, 16), (256, 300, 256, 2),
    (1024, 32768, 1 << 15, 32)])
@pytest.mark.parametrize("abs_index", [0, 2 ** 32 - 3000])
def test_burster_interval_mode_equals_jax(rng, length, interval, bs, cap,
                                          abs_index):
    """Frames (windows opening in the previous block from the history),
    event rows bit for bit (limbs across the 2^32 wrap), counts and state;
    too many windows for max_bursts in some configurations."""
    cfg = dict(sample_rate=1000, burst_length=length, interval=interval,
               sample_interval=True, max_bursts=cap)
    x = cnoise(rng, 4 * bs)
    blocks = [x[i:i + bs] for i in range(0, len(x), bs)]
    jo, js = jax_run(jb.Burster(jb.BursterConfig(**cfg)), blocks,
                     abs_index=abs_index)
    to, ts = port_run(tb.Burster(tb.BursterConfig(**cfg), device=CPU), blocks,
                      abs_index=abs_index)
    assert_same_outputs(jo, to, event_ports=(1,))
    assert_same_state(js, ts)
    assert sum(t[0][1] for t in to) > 0


def test_burster_seconds_interval_and_float_stream():
    cfg = dict(sample_rate=1000, burst_length=8, interval=0.016)
    assert tb.BursterConfig(**cfg).interval_samples() == 16
    x = np.arange(192, dtype=np.float32)
    blocks = [x[:64], x[64:128], x[128:]]
    jo, js = jax_run(jb.Burster(jb.BursterConfig(**cfg), dtype=jnp.float32),
                     blocks, rate=1000.0, abs_index=5)
    to, ts = port_run(tb.Burster(tb.BursterConfig(**cfg), dtype=torch.float32,
                                 device=CPU), blocks, rate=1000.0,
                      abs_index=5)
    assert_same_outputs(jo, to, event_ports=(1,))
    assert_same_state(js, ts)
    assert [t[0][1] for t in to] == [4, 4, 4]


@pytest.mark.parametrize("tag_lengths", [True, False])
def test_burster_trigger_mode_equals_jax(rng, tag_lengths):
    """Event rows (rel index, value, length) open bursts; lengths from the
    events are masked against the capacity; events past the block or the
    count are dropped."""
    cfg = dict(burst_length=6, trigger_on_tags=True,
               use_tag_lengths=tag_lengths, max_bursts=4)
    x = np.arange(80, dtype=np.float32)
    ev = np.array([[5, 0, 6], [20, 0, 3], [36, 0, 9], [0, 0, 0]], np.float32)
    ev2 = np.array([[1, 0, 2], [30, 0, 6], [38, 0, 6], [12, 0, 4]],
                   np.float32)
    blocks = [(x[:40], ev), (x[40:], ev2)]
    counts = [(40, 3), (40, 4)]
    jo, js = jax_run(jb.Burster(jb.BursterConfig(**cfg), dtype=jnp.float32),
                     blocks, counts)
    to, ts = port_run(tb.Burster(tb.BursterConfig(**cfg), dtype=torch.float32,
                                 device=CPU), blocks, counts)
    assert_same_outputs(jo, to, event_ports=(1,))
    assert_same_state(js, ts)


def test_burster_into_merge_rebuilds_the_windows(rng):
    """Interval bursts merged back onto a zero stream by their event rows'
    low limbs: each window equals the input, zeros elsewhere, as the JAX
    blocks give; the limb wraps mid-run."""
    n, length, interval = 512, 32, 128
    cfg = dict(burst_length=length, interval=interval, sample_interval=True,
               max_bursts=4)
    x = cnoise(rng, 4 * n)
    blocks = [x[i:i + n] for i in range(0, len(x), n)]
    base = 2 ** 32 - 700
    burster = tb.Burster(tb.BursterConfig(**cfg), device=CPU)
    bo, _ = port_run(burster, blocks, abs_index=base)
    merge_in = [(np.zeros(n, np.complex64), f[0], e[0][:, 1])
                for f, e in ((o[0], o[1]) for o in bo)]
    counts = [(n, f[1], f[1]) for f in (o[0] for o in bo)]
    to, _ = port_run(tb.Merge(length), merge_in, counts, abs_index=base)
    jo, _ = jax_run(jb.Merge(length), merge_in, counts, abs_index=base)
    assert_same_outputs(jo, to)
    got = np.concatenate([t[0][0] for t in to])
    win = (np.arange(len(x)) % interval) < length
    np.testing.assert_array_equal(got[win], x[win])
    assert not got[~win].any()


@pytest.mark.parametrize("n_freqs,dwell,drop", [(3, 8, 2), (2, 4, 0),
                                                (5, 100, 17)])
@pytest.mark.parametrize("bs", [20, 48, 256])
def test_hopper_demux_equals_jax(rng, n_freqs, dwell, drop, bs):
    """Lanes, counts and the carried dwell phase over unaligned blocks,
    the last with count < capacity."""
    x = cnoise(rng, 4 * bs)
    blocks = [x[i:i + bs] for i in range(0, len(x), bs)]
    counts = [bs, bs, bs, bs - 7]
    jo, js = jax_run(JHopper(n_freqs, dwell, drop), blocks, counts)
    to, ts = port_run(HopperDemux(n_freqs, dwell, drop, device=CPU), blocks,
                      counts)
    assert_same_outputs(jo, to)
    assert_same_state(js, ts)


def test_hopper_demux_rejects_a_drop_past_the_dwell():
    with pytest.raises(ValueError):
        HopperDemux(2, 4, 4, device=CPU)
