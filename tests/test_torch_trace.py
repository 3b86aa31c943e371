"""The port's tracer (``core/trace.py``) and its spans on the served path:
the pump, the executor's dispatch and fetch, one span per Block; off by
default, armed by a profiler session, on the benchmark's host clock."""

import collections
import gc
import threading
import time

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.core import trace
from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.pump import StreamPump
from grbaz_tpu_torch.models.wbfm import WBFMConfig, build_wbfm

FS = 3.2e6
N = 4096
BLOCKS = ("channel", "demod", "audio_aa", "resampler", "deemph")
DISPATCH = ("dispatch.stage", "dispatch.params", "dispatch.upload",
            "dispatch.meta", "dispatch.graph")


def _executor(device="cpu"):
    fg, _ = build_wbfm(WBFMConfig(block_size=N, center_freq=250e3,
                                  audio_chain="cascade"), device=device)
    return StreamExecutor(fg, {"iq": InputSpec((N,), "complex64", FS)},
                          device=device)


def _blocks(k, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, N)) + 1j * rng.standard_normal((k, N))
    return [{"iq": b.astype(np.complex64)} for b in x]


def _pump_run(ex, blocks, depth=2, inflight=3):
    feed = list(blocks)
    got = []
    pump = StreamPump(ex, lambda: feed.pop(0) if feed else None,
                      {"audio": lambda d, c: got.append(c)},
                      depth=depth, inflight=inflight)
    pump.start()
    deadline = time.monotonic() + 60
    while pump.stats()["blocks_out"] < len(blocks) \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    pump.stop()
    assert pump.stats()["blocks_out"] == len(blocks)
    return got


@pytest.fixture
def tracing():
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()


def _by_block(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[(s.stream, s.seq)].append(s)
    return out


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


def test_off_by_default_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with tracing off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(trace, "begin", refuse)
    monkeypatch.setattr(trace, "add", refuse)
    trace.clear()
    assert not trace.on()
    _pump_run(_executor(), _blocks(6))
    assert trace.spans() == []


def test_dispatch_splits_into_its_parts_and_blocks(tracing):
    ex = _executor()
    _pump_run(ex, _blocks(6))
    spans = trace.spans()
    tops = [s for s in spans if s.name == "executor.dispatch"]
    assert [s.seq for s in tops] == list(range(6))
    assert {s.stream for s in tops} == {ex.stream_id}
    per = _by_block(spans)
    for top in tops:
        mine = per[(top.stream, top.seq)]
        kids = [s for s in mine if s.parent == "executor.dispatch"]
        assert [s.name for s in kids] == list(DISPATCH)
        assert all(_inside(k, top) for k in kids)
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
        stage = kids[0]
        assert stage.n == 0  # the feeder staged the block
        copy, = [s for s in mine if s.name == "pump.stage"]
        assert copy.n == N * 8 and copy.t1 <= top.t0  # complex64 bytes
        graph = kids[-1]
        blocks = [s for s in mine if s.parent == "dispatch.graph"]
        assert [s.name for s in blocks] == [f"block.{b}" for b in BLOCKS]
        assert all(_inside(b, graph) for b in blocks)


def test_fetch_splits_and_blocks_agree(tracing):
    ex = _executor()
    _pump_run(ex, _blocks(6))
    per = _by_block(trace.spans())
    for seq in range(6):
        mine = per[(ex.stream_id, seq)]
        names = collections.Counter(s.name for s in mine)
        for name in ("executor.dispatch", "executor.fetch", "fetch.wait",
                     "fetch.copy", "pump.source", "pump.stage", "pump.queue",
                     "pump.sinks",
                     *DISPATCH, *(f"block.{b}" for b in BLOCKS)):
            assert names[name] == 1, (seq, name)
        fetch = next(s for s in mine if s.name == "executor.fetch")
        dispatch = next(s for s in mine if s.name == "executor.dispatch")
        assert dispatch.t1 <= fetch.t0
        kids = [s for s in mine if s.parent == "executor.fetch"]
        assert [s.name for s in kids] == ["fetch.wait", "fetch.copy"]
        assert all(_inside(k, fetch) for k in kids)
        quad = N // 8 * 4  # float32 quad of a full block ...
        audio_max = N * 4
        assert quad < kids[1].n < quad + audio_max  # ... and the audio
        sinks = next(s for s in mine if s.name == "pump.sinks")
        assert fetch.t1 <= sinks.t0


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pump_queue_one_per_block(tracing, depth):
    ex = _executor()
    _pump_run(ex, _blocks(6), depth=depth)
    spans = trace.spans()
    queue = [s for s in spans if s.name == "pump.queue"]
    assert sorted(s.seq for s in queue) == list(range(6))
    assert all(0 <= s.n <= depth and s.t0 <= s.t1 for s in queue)
    source = {s.seq: s for s in spans if s.name == "pump.source"
              and s.seq >= 0}
    stage = {s.seq: s for s in spans if s.name == "pump.stage"}
    dispatch = {s.seq: s for s in spans if s.name == "executor.dispatch"}
    for s in queue:  # source call, the copy, the queue, then the dispatch
        assert source[s.seq].t1 <= stage[s.seq].t0
        assert stage[s.seq].t1 == s.t0 and s.t1 <= dispatch[s.seq].t0
    assert all(s.parent is None for s in queue)


def test_raw_dispatch_stages_its_own_block(tracing):
    """``dispatch`` given host arrays copies them itself: its
    ``dispatch.stage`` counts the bytes, and no ``pump.stage`` is made."""
    ex = _executor()
    for b in _blocks(2):
        ex.step(b)
    spans = trace.spans()
    stage = [s for s in spans if s.name == "dispatch.stage"]
    assert [(s.seq, s.n, s.parent) for s in stage] == [
        (0, N * 8, "executor.dispatch"), (1, N * 8, "executor.dispatch")]
    assert not [s for s in spans if s.name == "pump.stage"]


def test_graph_span_counts_no_other_work_under_one_pump(tracing):
    """``dispatch.graph``'s ``n``: the steps of other executors dispatched
    and not yet fetched; one executor under a pump has none beside it."""
    ex = _executor()
    _pump_run(ex, _blocks(6))
    graph = [s for s in trace.spans() if s.name == "dispatch.graph"]
    assert len(graph) == 6 and [s.n for s in graph] == [0] * 6


def test_graph_span_counts_other_executors_pending_steps(tracing):
    """Three executors dispatched in turn twice over before any fetch: each
    step starts beside the others' steps still pending, its own not
    counted; a fetch takes its step out of the count."""
    exs = [_executor() for _ in range(3)]
    ins = _blocks(2)
    steps = [ex.dispatch(ins[j]) for j in range(2) for ex in exs]
    graph = [s for s in trace.spans() if s.name == "dispatch.graph"]
    assert [(s.stream, s.n) for s in graph] == [
        (ex.stream_id, n) for ex, n in zip(exs * 2, [0, 1, 2, 2, 3, 4])]
    exs[1].fetch(steps[1])
    exs[1].fetch(steps[4])
    exs[0].dispatch(ins[0])
    last = [s for s in trace.spans() if s.name == "dispatch.graph"][-1]
    assert last.stream == exs[0].stream_id and last.n == 2
    for ex in exs:
        ex.reset()


def test_profiler_session_arms_the_tracer():
    ex = _executor()
    ins = _blocks(3)
    trace.clear()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert trace.on()
        ex.step(ins[0])
    finally:
        prof.stop()
    assert not trace.on()
    got = trace.spans()
    assert [s.name for s in got if s.parent == "dispatch.graph"] == [
        f"block.{b}" for b in BLOCKS]
    ex.step(ins[1])
    assert trace.spans() == got
    keys = {e.key for e in prof.key_averages()}
    assert {f"block.{b}" for b in BLOCKS} <= keys
    assert {"executor.dispatch", "executor.fetch", *DISPATCH} <= keys
    trace.clear()


def test_profiler_flag_seen_from_every_thread():
    """The pump's threads read torch's process-wide flag: a session
    started on another thread arms them too."""
    seen = []

    def look():
        seen.append(trace.on())

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [True]
    assert torch.autograd.profiler._is_profiler_enabled is False
    look()
    assert seen == [True, False]


def test_dispatch_inside_the_benchmarks_span(tracing):
    """The benchmark's spans and the program's read one clock."""
    from radiobench import spans as rb_spans

    ex = _executor()
    rec = rb_spans.Recorder()
    rb_spans.wrap_executor(ex, 0, rec)
    _pump_run(ex, _blocks(6))
    outer = rec.of("dispatch")
    inner = [s for s in trace.spans() if s.name == "executor.dispatch"]
    assert len(outer) == len(inner) == 6
    for o, i in zip(outer, inner):
        assert o[3] <= i.t0 <= i.t1 <= o[4]
    outer = rec.of("fetch")
    inner = [s for s in trace.spans() if s.name == "executor.fetch"]
    for o, i in zip(outer, inner):
        assert o[3] <= i.t0 <= i.t1 <= o[4]


def test_autofec_block_spans_nest_in_its_block():
    """The auto-FEC Block's four parts, inside ``block.fec`` of each
    traced step, ``fec.decode`` counting the pairs decoded; an untraced
    step records none."""
    from grbaz_tpu_torch.core.graph import Flowgraph
    from grbaz_tpu_torch.models.auto_fec import AutoFECBlock

    n, overlap = 256, 96
    fec = AutoFECBlock(overlap=overlap, name="fec", device="cpu")
    fg = Flowgraph("lrpt")
    fg.input("iq", fec)
    for i, port in enumerate(("pm", "bits", "ber", "state")):
        fg.output(port, (fec, i))
    ex = StreamExecutor(fg, {"iq": InputSpec((n,), "complex64", 72e3)},
                        device="cpu")
    rng = np.random.default_rng(3)
    blocks = [{"iq": (rng.standard_normal(n) + 1j * rng.standard_normal(n))
               .astype(np.complex64)} for _ in range(3)]
    trace.clear()
    ex.step(blocks[0])
    assert trace.spans() == []
    trace.enable()
    try:
        for b in blocks[1:]:
            ex.step(b)
    finally:
        trace.disable()
    per = _by_block(trace.spans())
    trace.clear()
    assert sorted(per) == [(ex.stream_id, 1), (ex.stream_id, 2)]
    for mine in per.values():
        top = next(s for s in mine if s.name == "block.fec")
        kids = [s for s in mine if s.parent == "block.fec"]
        assert [s.name for s in kids] == ["fec.transform", "fec.decode",
                                          "fec.check", "fec.search"]
        assert all(_inside(k, top) for k in kids)
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
        assert kids[1].n == overlap + n
        assert [k.n for k in kids if k.name != "fec.decode"] == [None] * 3


def test_tracer_nesting_range_and_bound(tracing, monkeypatch):
    monkeypatch.setattr(trace, "_buf", collections.deque(maxlen=4))
    top = trace.begin("a", 7, 3)
    kid = trace.begin("b")
    trace.end(kid, 12)
    trace.end(top)
    b, a = trace._buf
    assert a[:4] == ("a", 7, 3, None) and b[:4] == ("b", 7, 3, "a")
    assert b[6] == 12 and a[4] <= b[4] <= b[5] <= a[5]
    assert [s.name for s in trace.spans()] == ["a", "b"]
    assert trace.spans(b[4]) == [trace.Span(*b)]
    assert trace.spans(a[4], b[4]) == [trace.Span(*a)]
    # a root drops the frames an exception left open
    trace.begin("c", 1, 0)
    trace.begin("d")
    trace.end(trace.begin("e", 1, 1))
    assert trace._buf[-1][:4] == ("e", 1, 1, None)
    assert trace._thread.open == []
    # spans with no parent stream take -1; the oldest spans drop
    trace.end(trace.begin("f"))
    trace.add("g", 2, 5, 1.0, 2.0, 9)
    assert [s[0] for s in trace._buf] == ["a", "e", "f", "g"]
    assert trace._buf[2][1:3] == (-1, -1)
    assert trace.spans(0.5, 1.5) == [trace.Span("g", 2, 5, None, 1.0, 2.0, 9)]
    trace.clear()
    assert trace.spans() == []


def _plus_one(n=64):
    """An executor of one stateless Block, ``y = x + 1``, on the CPU."""
    from grbaz_tpu_torch.core.block import FnBlock
    from grbaz_tpu_torch.core.graph import Flowgraph

    fg = Flowgraph("plus")
    blk = FnBlock(lambda x: x + 1, name="plus")
    fg.input("x", blk)
    fg.output("y", blk)
    return StreamExecutor(fg, {"x": InputSpec((n,), "float32")}, device="cpu")


def _beside_count():
    """``dispatch.graph``'s ``n`` of one traced step of a new executor:
    the steps every other executor has in flight."""
    ex = _executor()
    trace.clear()
    trace.enable()
    try:
        ex.step(_blocks(1)[0])
    finally:
        trace.disable()
    n, = [s.n for s in trace.spans() if s.name == "dispatch.graph"]
    trace.clear()
    return n


def test_steps_fetched_out_of_dispatch_order_return_their_own():
    """Each dispatched step's handle brings back that step's outputs,
    fetched in any order; the states chain in dispatch order."""
    ins = _blocks(4, seed=11)
    ref, ex = _executor(), _executor()
    want = [ref.step(b) for b in ins]
    steps = [ex.dispatch(b) for b in ins]
    assert [s.seq for s in steps] == [0, 1, 2, 3]
    got = {j: ex.fetch(steps[j]) for j in (2, 0, 3, 1)}
    for j, w in enumerate(want):
        assert got[j].keys() == w.keys()
        for port, (data, count) in w.items():
            assert got[j][port][1] == count
            np.testing.assert_array_equal(got[j][port][0], data)


def test_unfetched_steps_are_bounded_and_reset_takes_them_out():
    """Steps dispatched and never fetched: an executor keeps at most 64 of
    them in flight however many it dispatches (the oldest drops out, and
    can still be fetched); a reset takes them out of the count, and so
    does dropping the executor."""
    base = _beside_count()
    ex = _plus_one()
    xs = [np.full(64, j, np.float32) for j in range(200)]
    steps = [ex.dispatch({"x": x}) for x in xs]
    assert len(ex._flight) == 64
    assert _beside_count() == base + 64
    (y, count), = ex.fetch(steps[0]).values()  # dropped out, still fetched
    assert count == 64 and (y == 1).all()
    assert _beside_count() == base + 64
    (y, _), = ex.fetch(steps[-1]).values()
    assert (y == 200).all()
    assert _beside_count() == base + 63
    ex.reset()
    assert len(ex._flight) == 0 and _beside_count() == base
    ex.dispatch({"x": xs[0]})
    assert _beside_count() == base + 1
    del ex, steps
    gc.collect()
    assert _beside_count() == base


@pytest.mark.cuda
def test_off_on_the_card_adds_no_event(monkeypatch):
    """The served path's CUDA events: the input slots' (one a slot) and the
    step's end event are made once and recorded again each step, traced or
    not (the end event from the executor's pool)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    made = []
    real = torch.cuda.Event

    def count(*a, **k):
        made.append(1)
        return real(*a, **k)
    ex = _executor("cuda")
    ins = _blocks(4)
    ex.step(ins[0])
    monkeypatch.setattr(torch.cuda, "Event", count)
    ex.step(ins[1])
    assert len(made) == 0
    trace.clear()
    trace.enable()
    try:
        ex.step(ins[2])
    finally:
        trace.disable()
    assert len(made) == 0
    wait = [s for s in trace.spans() if s.name == "fetch.wait"]
    assert len(wait) == 1
    trace.clear()


def _trace_split():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "trace_split.py"
    spec = importlib.util.spec_from_file_location("trace_split", path)
    ts_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts_mod)
    return ts_mod


def test_trace_split_maps_the_trace_clock_by_both_markers():
    """``tools/trace_split.py``'s per-Block split puts each runtime call in
    the span open at its host time, the trace's clock mapped by the
    window's two markers: a launch 30 us before a span's end, read through
    a 40 ppm drift over 2 s (80 us at the end), stays in its span."""
    from radiobench import spans as bench_spans
    ts_mod = _trace_split()
    Span = collections.namedtuple("Span", "name t0 t1")
    h_a, drift = 100.0, 1.0 + 40e-6
    marks = {bench_spans.Profile.START: h_a,
             bench_spans.Profile.END: h_a + 2.0 * drift}
    mine = [Span("block.resampler", h_a + 1.9999, h_a + 1.99998),
            Span("block.deemph", h_a + 1.99998, h_a + 1.99999)]

    def at(host):  # the trace's microseconds of a host time
        return 5e6 + (host - h_a) / drift * 1e6

    events = [dict(name=bench_spans.Profile.START, ph="X", ts=at(h_a)),
              dict(name=bench_spans.Profile.END, ph="X",
                   ts=at(h_a + 2.0 * drift)),
              dict(name="cudaLaunchKernel", ph="X", cat="cuda_runtime",
                   ts=at(h_a + 1.99995), args=dict(correlation=7)),
              dict(name="cudaLaunchKernel", ph="X", cat="cuda_runtime",
                   ts=at(h_a + 1.999985), args=dict(correlation=8)),
              dict(name="k", ph="X", cat="kernel", ts=at(h_a + 1.99996),
                   dur=4.0, args=dict(correlation=8))]
    got = ts_mod.per_leaf(events, marks, mine, 1)
    assert got["block.resampler"]["launches"] == 1
    assert got["block.deemph"]["launches"] == 1
    assert got["block.deemph"]["device_ms"] == pytest.approx(0.004)
    assert "other" not in got


def test_trace_split_counts_a_kernels_launches_at_once():
    """``kernels_at_once``: a kernel's launch time over the union of its
    launches (two overlapping, then one alone: 9 over 7); a kernel below
    a tenth of the busy time and the copies are left out."""
    from radiobench import spans as bench_spans
    tr = bench_spans.Trace(0.0, 10.0, [
        ("k", "kernel", 0.0, 4.0), ("k", "kernel", 2.0, 6.0),
        ("k", "kernel", 8.0, 9.0), ("m", "kernel", 6.0, 6.1),
        ("Memcpy", "gpu_memcpy", 1.0, 9.5)])
    assert _trace_split().at_once(tr) == {"k": pytest.approx(9.0 / 7.0)}
    one = bench_spans.Trace(0.0, 3.0, [("k", "kernel", 0.0, 1.0),
                                       ("k", "kernel", 1.0, 2.0)])
    assert _trace_split().at_once(one) == {"k": pytest.approx(1.0)}
