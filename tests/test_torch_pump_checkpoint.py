"""Port StreamPump and checkpoint / resume == grbaz_tpu's, over the fused
WBFM chain at a small block on the CPU."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core import checkpoint as jckpt
from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.models import wbfm as jwbfm
from grbaz_tpu_torch.convert import to_numpy
from grbaz_tpu_torch.core import checkpoint as tckpt
from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.pump import StreamPump
from grbaz_tpu_torch.core.stream import Stream as TStream
from grbaz_tpu_torch.models import wbfm as twbfm

FS = 3.2e6
N = 4096
CPU = "cpu"


def _blocks(k, seed=3):
    gen = np.random.default_rng(seed)
    t = np.arange(k * N)
    x = np.exp(1j * (2 * np.pi * 250e3 / FS * t
                     + 75 * np.sin(2 * np.pi * 1e3 / FS * t)))
    x = x + 0.05 * (gen.standard_normal(k * N) + 1j * gen.standard_normal(k * N))
    x = x.astype(np.complex64)
    return [x[b * N:(b + 1) * N] for b in range(k)]


def _cfg(**kw):
    return dict(dict(block_size=N, center_freq=250e3, fused=True,
                     squelch_db=-20.0), **kw)


def _executor(**kw):
    fg, _ = twbfm.build_wbfm(twbfm.WBFMConfig(**_cfg(**kw)), device=CPU)
    return StreamExecutor(fg, {"iq": InputSpec((N,), "complex64", FS)},
                          device=CPU)


def _wait(cond, seconds=30.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cond(), "timed out"


def _logged(ex):
    """Log each block ``ex`` dispatches, as ``(input arrays, counts)`` copied
    when the block was staged: what the executor was handed, in order."""
    copies, order = {}, []
    stage, dispatch = ex.stage, ex.dispatch

    def staged(ins, counts=None, **kw):
        s = stage(ins, counts, **kw)
        copies[id(s)] = ({k: np.array(v) for k, v in ins.items()}, counts)
        return s

    def dispatched(s, *a, **kw):
        order.append(copies.pop(id(s)))
        return dispatch(s, *a, **kw)
    ex.stage, ex.dispatch = staged, dispatched
    return order


def _outs(ex, ins, counts=None):
    o = ex.step(ins, counts)
    return [("audio", o["audio"][0][:o["audio"][1]]),
            ("quad", o["quad"][0][:o["quad"][1]])]


# each mode: (pump options, source blocks, blocks out to wait for)
_MODES = dict(
    blocking=(dict(), 6, 6),
    drop=(dict(depth=1, drop=True), 12, None),
    zero_fill=(dict(zero_fill=True), 4, 7),
    partial=(dict(), 6, 6),
)


@pytest.mark.parametrize("inflight, mode", [
    pytest.param(1, "blocking", id="1"),
    pytest.param(3, "blocking", id="3"),
    pytest.param(2, "blocking", id="2"),
    pytest.param(4, "blocking", id="4"),
    pytest.param(3, "drop", id="drop"),
    pytest.param(3, "zero_fill", id="zero_fill"),
    pytest.param(3, "partial", id="partial"),
])
def test_pump_blocking_mode_equals_executor_step(inflight, mode):
    """A pump's outputs, in every mode, equal the same blocks through
    ``ex.step``: each block the executor was handed, in order; in
    blocking mode every source block, each staged on the feeder."""
    kw, n, out = _MODES[mode]
    blocks = [{"iq": b} for b in _blocks(n)]
    if mode == "partial":  # the stream ends mid-block
        blocks[-1] = (blocks[-1], {"iq": N // 2 + 3})
    ex = _executor()
    order = _logged(ex)
    feed, got = list(blocks), []
    delay = 0.01 if mode == "drop" else 0.0  # a slow sink: blocks drop

    def sink(port):
        return lambda d, c: (got.append((port, d[:c])), time.sleep(delay))
    pump = StreamPump(ex, lambda: feed.pop(0) if feed else None,
                      {p: sink(p) for p in ("audio", "quad")},
                      inflight=inflight, **kw)
    pump.start()
    _wait(lambda: pump.stats()["blocks_out"] >= out if out else
          pump.stats()["blocks_out"] + pump.stats()["overruns"] == n)
    pump.stop()
    stats = pump.stats()
    assert stats["staged"] == stats["blocks_out"] == len(order)
    if mode == "drop":
        assert stats["blocks_in"] == n == stats["blocks_out"] + \
            stats["overruns"]
    elif mode == "zero_fill":
        assert stats["underruns"] >= len(order) - n >= out - n
        assert all(not ins["iq"].any() for ins, _ in order[n:])
    else:
        assert stats["blocks_in"] == stats["blocks_out"] == n
        assert stats["overruns"] == stats["underruns"] == 0
    if mode != "drop":  # every source block, in order, as it was
        for (ins, counts), b in zip(order, blocks):
            ins_b, counts_b = b if isinstance(b, tuple) else (b, None)
            np.testing.assert_array_equal(ins["iq"], ins_b["iq"])
            assert counts == counts_b
    ref = _executor()
    want = [o for ins, counts in order for o in _outs(ref, ins, counts)]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pump_drop_mode_counts_overruns():
    ex = _executor()
    block = {"iq": _blocks(1)[0]}
    pump = StreamPump(ex, lambda: block,
                      {"quad": lambda d, c: time.sleep(0.02)},
                      depth=1, drop=True)
    pump.start()
    _wait(lambda: pump.stats()["overruns"] >= 3
          and pump.stats()["blocks_out"] >= 2)
    pump.stop()
    st = pump.stats()
    assert st["blocks_in"] >= st["blocks_out"] + st["overruns"]


def test_pump_zero_fill_counts_underruns():
    ex = _executor(squelch_db=None)
    got = []
    pump = StreamPump(ex, lambda: None,
                      {"audio": lambda d, c: got.append((d, c))},
                      zero_fill=True)
    pump.start()
    _wait(lambda: len(got) >= 3)
    pump.stop()
    assert pump.stats()["underruns"] >= 3
    assert all(np.all(d[:c] == 0) for d, c in got)


def test_pump_stop_drains_and_reraises():
    ex = _executor()
    feed = [{"iq": b} for b in _blocks(5)]
    out = []
    pump = StreamPump(ex, lambda: feed.pop(0) if feed else None,
                      {"quad": lambda d, c: out.append(c)}, inflight=3)
    pump.start()
    _wait(lambda: pump.stats()["blocks_in"] == 5
          and pump.stats()["queued"] == 0)
    pump.stop()
    assert pump.stats()["blocks_out"] == len(out) == 5
    bad = StreamPump(_executor(), lambda: {"iq": np.zeros(N - 1, np.complex64)},
                     {})
    bad.start()
    _wait(lambda: bad._error is not None)
    with pytest.raises(ValueError, match="expected"):
        bad.stop()


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def _steps(ex, blocks):
    return [ex.step({"iq": b}) for b in blocks]


def _assert_outs_equal(a, b):
    for oa, ob in zip(a, b):
        for port in ("audio", "quad"):
            assert oa[port][1] == ob[port][1]
            np.testing.assert_array_equal(oa[port][0], ob[port][0])


def test_executor_save_restore_is_bit_exact(tmp_path):
    blocks = _blocks(6)
    ex = _executor()
    _steps(ex, blocks[:3])
    ex.params["frontend"] = dict(
        ex.params["frontend"], **twbfm.WBFMFrontend.freq_params(250.5e3, FS))
    path = str(tmp_path / "session.npz")
    ex.save(path, extra=dict(blocks_done=3))
    tail_a = _steps(ex, blocks[3:])

    fresh = _executor()
    extra = fresh.restore(path)
    assert int(extra["blocks_done"]) == 3 and sorted(extra) == ["blocks_done"]
    assert int(fresh.params["frontend"]["lo_inc"]) == int(
        twbfm.WBFMFrontend.freq_params(250.5e3, FS)["lo_inc"])
    assert int(fresh._meta["iq"].abs_lo) == 3 * N
    assert int(fresh._meta["iq"].seq) == 3
    _assert_outs_equal(tail_a, _steps(fresh, blocks[3:]))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A file of the JAX save_state, written after 2 blocks of the JAX
    fused chain, loads into the port, which continues to the JAX
    chain's outputs."""
    blocks = _blocks(4)
    jfg, _ = jwbfm.build_wbfm(jwbfm.WBFMConfig(**_cfg()))
    tfg, _ = twbfm.build_wbfm(twbfm.WBFMConfig(**_cfg()), device=CPU)
    # auto-named blocks take a process-wide counter, so the two packages'
    # names differ; the topologies are the same, block by block
    names = {j.name: t.name for j, t in zip(jfg.blocks, tfg.blocks)}
    assert [type(b).__name__ for b in jfg.blocks] == \
        [type(b).__name__ for b in tfg.blocks]
    step = jax.jit(jfg.build_step())
    jst = jax.tree_util.tree_map(jnp.asarray, jfg.init_states())
    jpr = jfg.init_params()
    jq = []
    for b, x in enumerate(blocks):
        jst, o = step(jst, jpr, {"iq": JStream.full(jnp.asarray(x),
                                                    sample_rate=FS)})
        jq.append(np.asarray(o["quad"].data))
        if b == 1:
            path = str(tmp_path / "jax.npz")
            jckpt.save_state(path, {names[k]: v for k, v in jst.items()},
                             {names[k]: v for k, v in jpr.items()},
                             extra=dict(blocks_done=2))
    st, pr, extra = tckpt.load_state(path, tfg.init_states(),
                                     tfg.init_params())
    assert int(extra["blocks_done"]) == 2
    assert st["frontend"]["phase"].dtype == torch.int64
    tstep = tfg.build_step()
    for b, x in enumerate(blocks[2:], start=2):
        st, o = tstep(st, pr, {"iq": TStream.full(torch.from_numpy(x),
                                                  sample_rate=FS)})
        got = o["quad"].data.numpy()
        assert np.abs(got - jq[b]).max() <= 1e-4 * np.abs(jq[b]).max()


def test_port_checkpoint_loads_in_jax(tmp_path):
    ex = _executor()
    _steps(ex, _blocks(2))
    path = str(tmp_path / "port.npz")
    ex.save(path)
    jfg, _ = jwbfm.build_wbfm(jwbfm.WBFMConfig(**_cfg()))
    names = {t.name: j.name for j, t in zip(jfg.blocks, ex.graph.blocks)}
    def renamed(key):  # the block names of the JAX graph
        prefix, block, rest = key.split("/", 2)
        return "/".join((prefix, names.get(block, block), rest))

    with np.load(path) as z:
        data = {renamed(k): z[k] for k in z.files}
    np.savez(path, **data)
    jst, jpr, extra = jckpt.load_state(path, jfg.init_states(),
                                       jfg.init_params())
    port = to_numpy(ex._states)
    for t_name, j_name in names.items():
        for k, v in (port[t_name] or {}).items():
            np.testing.assert_array_equal(np.asarray(jst[j_name][k]), v)
    assert int(extra["meta/iq/abs_lo"]) == 2 * N


def test_checkpoint_rejects_mismatched_topology(tmp_path):
    fg, _ = twbfm.build_wbfm(twbfm.WBFMConfig(**_cfg()), device=CPU)
    p = str(tmp_path / "s.npz")
    tckpt.save_state(p, fg.init_states())
    fg2, _ = twbfm.build_wbfm(twbfm.WBFMConfig(**_cfg(transition=50e3)),
                              device=CPU)  # a longer channel filter
    with pytest.raises(ValueError, match="template"):
        tckpt.load_state(p, fg2.init_states())
    fg3, _ = twbfm.build_wbfm(twbfm.WBFMConfig(**_cfg(squelch_db=None)),
                              device=CPU)
    tckpt.save_state(p, fg3.init_states())
    with pytest.raises(KeyError, match="sq_avg"):
        tckpt.load_state(p, fg.init_states())

