"""The readers of the program's own spans, on a synthetic device trace
and synthetic program spans worked out by hand."""

import sys
import types

import pytest

from radiobench import manifest, program, spans

WORKLOADS = ["rtl_fm.replay", "scanner.replay"]


def _span(name, seq, t0, t1, stream=0):
    from grbaz_tpu_torch.core.trace import Span
    return Span(name, stream, seq, None, t0, t1, None)


# Window [10, 11] s; the card busy over [10.1, 10.3] and [10.5, 10.6], so
# idle over [10, 10.1], [10.3, 10.5] and [10.6, 11].
TRACE = spans.Trace(10.0, 11.0, [
    ("k", "kernel", 10.1, 10.3), ("Memcpy DtoH", "gpu_memcpy", 10.5, 10.6)])
SPANS = [
    _span("pump.queue", 0, 9.95, 10.01),      # starts before the window
    _span("dispatch.stage", 0, 10.0, 10.08),
    _span("dispatch.graph", 0, 10.08, 10.2),
    _span("fetch.wait", 0, 10.3, 10.35),
    _span("fetch.copy", 0, 10.35, 10.45),
    _span("pump.queue", 1, 10.3, 10.4),
    _span("pump.source", -1, 10.3, 10.9),     # a poll that brought nothing
    _span("dispatch.stage", 1, 10.4, 10.45),  # two inputs: summed a block
    _span("dispatch.stage", 1, 10.45, 10.55),
    _span("dispatch.graph", 1, 10.55, 10.7),
    _span("fetch.wait", 1, 10.7, 10.72),
    _span("fetch.copy", 1, 10.72, 10.8),
    _span("dispatch.stage", 2, 11.0, 11.1),   # starts at the window's end
]

# by hand: per block, then the mean over the blocks
WANT = {
    "stage_ms.replay": 1e3 * (0.08 + 0.15) / 2,
    "graph_ms.replay": 1e3 * (0.12 + 0.15) / 2,
    "fetch_wait_ms.replay": 1e3 * (0.05 + 0.02) / 2,
    "fetch_copy_ms.replay": 1e3 * (0.10 + 0.08) / 2,
    "queue_wait_ms.replay": 1e3 * 0.1,
    # idle while inside: [10.08, 10.1] and [10.6, 10.7] of 1 s
    "idle_graph.replay": 100.0 * (0.02 + 0.1),
    # [10, 10.08] and [10.4, 10.5]
    "idle_stage.replay": 100.0 * (0.08 + 0.1),
}


@pytest.fixture
def program_spans(monkeypatch):
    from grbaz_tpu_torch.core import trace

    def fake(t0=float("-inf"), t1=float("inf")):
        return [s for s in SPANS if t0 <= s.t0 < t1]
    monkeypatch.setattr(trace, "spans", fake)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_hand_worked(program_spans, name):
    read = manifest.metric_reader(name)
    ctx = types.SimpleNamespace(trace=TRACE)
    assert read(ctx) == pytest.approx(WANT[name], rel=1e-9)
    assert read(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_the_tracer(monkeypatch, name):
    """A program with no tracer (the parent's) reads None, raising
    nothing."""
    import grbaz_tpu_torch.core as core
    monkeypatch.delattr(core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "grbaz_tpu_torch.core.trace", None)
    read = manifest.metric_reader(name)
    assert read(types.SimpleNamespace(trace=TRACE)) is None


def test_reader_no_spans_in_the_window(program_spans):
    late = spans.Trace(20.0, 21.0, [])
    for name in WANT:
        assert manifest.metric_reader(name)(
            types.SimpleNamespace(trace=late)) is None


def test_declared_for_both_cells():
    by_name = {m["name"]: m for m in manifest.bench()["per_layer"]}
    for name in WANT:
        m = by_name[name]
        assert m["moves"] == "replay_msps" and m["workloads"] == WORKLOADS
    for cell in WORKLOADS:
        assert set(WANT) <= {m["name"] for m in manifest.per_layer(cell)}


def test_overlap():
    assert program.overlap([(0, 1), (2, 3)], [(0.5, 2.5)]) == 1.0
    assert program.overlap([(0, 1)], [(1, 2)]) == 0.0
    assert program.overlap([], [(0, 1)]) == 0.0
