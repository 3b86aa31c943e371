"""The latency, percentile and interval arithmetic, on synthetic spans
and a synthetic profiler trace."""

import pytest

from radiobench import spans


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert spans.percentile(v, 50) == 50
    assert spans.percentile(v, 95) == 95
    assert spans.percentile(v, 100) == 100
    assert spans.percentile([3.0], 95) == 3.0
    assert spans.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        spans.percentile([], 50)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert spans.merge(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert spans.covered(iv) == pytest.approx(3.0)
    assert spans.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert spans.gaps(iv, 0.5, 3.5) == [(2.0, 3.0)]
    assert spans.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_label_gaps_by_open_span():
    host = [("fetch", 0.0, 2.5), ("dispatch", 2.5, 3.0), ("source", 2.9, 5.0)]
    got = spans.label_gaps([(1.0, 2.0), (2.6, 2.8), (3.5, 4.5), (6.0, 7.5)],
                           host)
    assert got == [["none", 1.5], ["fetch", 1.0], ["source", 1.0],
                   ["dispatch", pytest.approx(0.2)]]
    # two spans open at once join their names
    assert spans.label_gaps([(2.9, 3.0)], host)[0][0] == "dispatch+source"


def test_trace_onto_host_clock():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": spans.Profile.START,
         "ts": 1000.0, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1120.0, "dur": 50.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1500.0,
         "dur": 120.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 1990.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1200.0,
         "dur": 500.0},
        {"ph": "X", "cat": "user_annotation", "name": spans.Profile.END,
         "ts": 2000.0, "dur": 2.0},
    ]
    tr = spans.trace_from_events(ev, host_start=10.0)
    assert tr.start == 10.0
    assert tr.window_s == pytest.approx(1000e-6)
    # k1 twice, overlapping (70 us), the copy, and k2 clipped at the end
    assert tr.busy_s == pytest.approx((70 + 120 + 11) * 1e-6)
    assert len(tr.kernels()) == 2 and len(tr.kernels("k2")) == 0
    assert tr.kernels("k1")[0] == pytest.approx(50e-6)
    assert tr.top_ops()[0][0] == "Memcpy HtoD"
    with pytest.raises(RuntimeError):
        spans.trace_from_events(ev[1:], 0.0)


def test_recorder_window():
    rec = spans.Recorder()
    rec.add("dispatch", 0, 0, 1.0, 1.5)
    rec.add("dispatch", 1, 0, 2.0, 2.1)
    rec.add("fetch", 0, 0, 1.5, 3.0)
    assert [s[1] for s in rec.of("dispatch", 0.5, 2.0)] == [0]
    assert len(rec.of("dispatch")) == 2
