"""Port segment scans and PeakDetector == grbaz_tpu (bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core import checkpoint as jckpt
from grbaz_tpu.ops import segments as jseg
from grbaz_tpu.ops.detect import PeakDetector as JPeak
from grbaz_tpu_torch.convert import states_from_numpy, to_numpy
from grbaz_tpu_torch.core import checkpoint as tckpt
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops import segments as tseg
from grbaz_tpu_torch.ops.detect import PeakDetector
from tests.torch_parity import jax_run, port_run

CPU = "cpu"


def _values(gen, n, kind):
    """Float values with many ties and -inf samples, or int32 values."""
    if kind == "ties":
        v = gen.integers(-3, 3, n).astype(np.float32)
        v[gen.random(n) < 0.3] = -np.inf
        return v
    if kind == "normal":
        return gen.standard_normal(n).astype(np.float32)
    return gen.integers(-5, 5, n).astype(np.int32)


def _both(fn, *args):
    j = fn(jseg, *(jnp.asarray(a) for a in args))
    t = fn(tseg, *(torch.from_numpy(a) for a in args))
    return j, t


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("p_reset", [0.0, 0.03, 0.5])
@pytest.mark.parametrize("kind", ["ties", "normal", "int"])
def test_seg_prefix_max_and_maxpos_bit_equal(seed, n, p_reset, kind):
    """Values with ties (the earlier position kept), -inf before the first
    reset (NO_POS) and at resets (a reset keeps its own position)."""
    gen = np.random.default_rng(seed * 1000 + n)
    reset = gen.random(n) < p_reset
    v = _values(gen, n, kind)
    if kind == "ties" and n > 2:
        v[0] = -np.inf
        reset[1] = True
        v[1] = -np.inf
    pos = gen.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    (jm, jp), (tm, tp) = _both(lambda m, r, x, p: m.seg_prefix_maxpos(r, x, p),
                               reset, v, pos)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert tp.dtype == torch.int32
    jm, tm = _both(lambda m, r, x: m.seg_prefix_max(r, x), reset, v)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [1, 300, 5000])
def test_running_and_next_true_index_bit_equal(seed, n):
    gen = np.random.default_rng(seed + n)
    mask = gen.random(n) < 0.05
    idx = gen.integers(0, 1 << 30, n).astype(np.int32)
    for s in (tseg.NO_POS, 17):
        j, t = _both(lambda m, a, b: m.running_last_true(a, b, s), mask, idx)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    j, t = _both(lambda m, a: m.next_true_index(a, n), mask)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("p_reset", [0.0, 0.01, 0.3])
def test_seg_prefix_sum_within_f32(p_reset):
    """Another summation order: within f32 rounding of the segment sums."""
    gen = np.random.default_rng(3)
    n = 20000
    reset = gen.random(n) < p_reset
    v = (gen.standard_normal(n) * 3).astype(np.float32)
    j, t = _both(lambda m, r, x: m.seg_prefix_sum(r, x), reset, v)
    j = np.asarray(j)
    assert t.dtype == torch.float32
    mag = np.abs(v).sum()
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6 * mag)


def _signal(kind, n, gen):
    if kind == 0:
        return np.abs(gen.standard_normal(n)).astype(np.float32)
    if kind == 1:
        x = gen.random(n).astype(np.float32)
        x[::50] += 3.0
        return x
    return np.cumsum(gen.standard_normal(n)).astype(np.float32)


CASES = [dict(min_diff=0.0, min_len=1),
         dict(min_diff=0.3, min_len=2, drop=0.1),
         dict(min_diff=1.0, min_len=1, alpha=0.3),
         dict(min_diff=0.3, min_len=3, threshold=0.5)]


@pytest.mark.parametrize("kw", CASES, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("bs", [256, 2048, 700])
def test_peak_detector_bit_equal_to_jax_and_serial_mirror(kw, kind, bs):
    """Marks and idx_diff against the JAX block-parallel apply and its
    per-sample serial mirror (_apply_scan), over chained blocks (rises
    that span blocks; a short last block where bs does not divide n),
    the last block with count < capacity; and the carried state."""
    gen = np.random.default_rng(kind * 7 + bs)
    n = 2048
    x = _signal(kind, n, gen)
    blocks = [x[i:i + bs] for i in range(0, n, bs)]
    counts = [len(b) for b in blocks]
    counts[-1] = max(counts[-1] - 5, 0)
    jo, js = jax_run(JPeak(**kw), blocks, counts)
    so, _ = jax_run(JPeak(**kw), blocks, counts,
                    fn=JPeak(**kw)._apply_scan)
    to, ts = port_run(PeakDetector(**kw, device=CPU), blocks, counts)
    for j, s, t in zip(jo, so, to):
        for port in range(2):
            np.testing.assert_array_equal(j[port][0], t[port][0])
            np.testing.assert_array_equal(s[port][0], t[port][0])
            assert j[port][1] == t[port][1]
        assert t[1][0].dtype == np.int32
    assert sum(float(t[0][0].sum()) for t in to) > 0
    for k, v in js.items():
        if k == "ave":  # with alpha != 1, a scan rounded another way
            np.testing.assert_allclose(to_numpy(ts[k]), np.asarray(v),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)


@pytest.mark.parametrize("kw", [dict(lockout=10), dict(look_ahead=4)])
def test_peak_detector_sequential_family_raises(kw):
    pd = PeakDetector(min_diff=0.5, device=CPU, **kw)
    x = torch.zeros(64)
    with pytest.raises(NotImplementedError, match="item 11"):
        pd.apply(pd.init_state(), pd.init_params(), Stream.full(x))


def test_peak_detector_state_checkpoint_both_ways(tmp_path):
    """int32 and bool leaves keep their types through the converters and
    both packages' checkpoints; a detector resumed from the JAX file
    continues bit-equal."""
    gen = np.random.default_rng(2)
    x = _signal(1, 3000, gen)
    kw = dict(min_diff=0.3, min_len=2)
    _, js = jax_run(JPeak(**kw), [x[:1000]])
    pd = PeakDetector(**kw, device=CPU)
    template = pd.init_state()
    assert {k: v.dtype for k, v in template.items()
            if v.dtype != torch.float32} == dict(
        rising=torch.bool, rise_count=torch.int32, peak_age=torch.int32,
        lockout_count=torch.int32, last_peak_global=torch.int32,
        global_idx=torch.int32)
    p = str(tmp_path / "pd.npz")
    jckpt.save_state(p, {"pd": js})
    st, _, _ = tckpt.load_state(p, {"pd": template})
    jo, _ = jax_run(JPeak(**kw), [x[1000:]], state=js)
    to, ts = port_run(pd, [x[1000:]], state=st["pd"])
    np.testing.assert_array_equal(jo[0][0][0], to[0][0][0])
    np.testing.assert_array_equal(jo[0][1][0], to[0][1][0])
    tckpt.save_state(p, {"pd": ts})
    back, _, _ = jckpt.load_state(p, {"pd": JPeak(**kw).init_state()})
    for k, v in back["pd"].items():
        assert np.asarray(v).dtype == np.asarray(JPeak().init_state()[k]).dtype
        np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]))
    again = states_from_numpy(to_numpy(ts), CPU)
    assert all(again[k].dtype == ts[k].dtype for k in ts)
