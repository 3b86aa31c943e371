"""Port NativeCallbackX, threshold_events, dispatch_events and NativeMux
== grbaz_tpu (ops/mux.py) on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.ops import mux as jm
from grbaz_tpu_torch.ops import mux as tm
from tests.test_torch_burst import assert_same_outputs
from tests.torch_parity import jax_run, port_run

CPU = "cpu"


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("n,max_events,p", [(64, 16, 0.1), (300, 8, 0.4),
                                            (10, 16, 0.5)])
def test_threshold_events_equal_jax(rng, enabled, n, max_events, p):
    x = (rng.random(n) < p).astype(np.float32) * 2.0 + rng.random(n) * 0.1
    for prev in (False, True):
        j = jm.threshold_events(jnp.asarray(x), jnp.float32(1.0),
                                jnp.bool_(prev), max_events, enabled=enabled)
        t = tm.threshold_events(torch.from_numpy(x), torch.tensor(1.0),
                                torch.tensor(prev), max_events,
                                enabled=enabled)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert t[0].dtype == torch.int32 and t[2].dtype == torch.int32


@pytest.mark.parametrize("enable", [True, False])
def test_native_callback_equals_jax_with_short_block(rng, enable):
    """Events over chained blocks (the hysteresis flag carried), the last
    block with count < capacity drops events in its tail."""
    x = ((rng.random(512) < 0.05) * 3.0).astype(np.float32)
    blocks = [x[i:i + 128] for i in range(0, 512, 128)]
    counts = [128, 128, 128, 60]
    kw = dict(threshold_enable=enable, threshold_level=1.0, max_events=8)
    jo, js = jax_run(jm.NativeCallbackX(**kw), blocks, counts)
    to, ts = port_run(tm.NativeCallbackX(**kw, device=CPU), blocks, counts)
    assert_same_outputs(jo, to)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_dispatch_events_calls_back_with_absolute_indices():
    class Target:
        def __init__(self):
            self.got = []

        def callback(self, value, index):
            self.got.append((value, index))

    ev = torch.tensor([[3.0, 0.5], [9.0, 1.5], [2 ** 30, 0.0]])
    a, b = Target(), Target()
    assert tm.dispatch_events(a, ev, torch.tensor(2), abs_base=100) == 2
    jm.dispatch_events(b, ev.numpy(), 2, abs_base=100)
    assert a.got == b.got == [(0.5, 103), (1.5, 109)]


@pytest.mark.parametrize("latency,count,values", [
    (10, 4, None), (8, 6, None), (4, 2, [0.5, 0.9, 1.3]),
    (300, 50, [2.0, -1.0])])
def test_native_mux_equals_jax(rng, latency, count, values):
    """Windows scheduled from events, crossing block boundaries and
    pending over several blocks; substitution values cycling; state."""
    n = 64
    main = rng.standard_normal(4 * n).astype(np.float32)
    alt = rng.standard_normal(4 * n).astype(np.float32) + 10.0
    blocks = []
    for b in range(4):
        times = np.sort(rng.choice(n, 3, replace=False)).astype(np.float32)
        ev = np.stack([times, np.ones(3, np.float32)], axis=1)
        blocks.append((main[b * n:(b + 1) * n], alt[b * n:(b + 1) * n], ev))
    counts = [(n, n, c) for c in (2, 3, 0, 1)]
    kw = dict(latency=latency, trigger_count=count, values=values)
    jo, js = jax_run(jm.NativeMux(**kw), blocks, counts)
    to, ts = port_run(tm.NativeMux(**kw, device=CPU), blocks, counts)
    assert_same_outputs(jo, to)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert ts[0].dtype == ts[1].dtype == torch.int32
