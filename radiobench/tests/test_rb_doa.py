"""The `doa` configuration's benchmark files on the CPU, at a small size
(one 4096-snapshot frame a block, the port's plain arms): a sound run is
correct, and the TF32 control and each fault of the array or its steering
are not; the three per-layer metrics it adds, worked by hand."""

import time
import types

import pytest
import torch

from radiobench import manifest, run, spans
from radiobench.tests.faults import _wrap

CPU = torch.device("cpu")
SMALL = dict(loop="closed", streams=1, block=1 << 15, ring=3,
             warmup_blocks=1, checks=2)
NEW = ("music_ms.replay", "music_syncs.replay", "chan_rows_roofline")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _block(ex, name):
    return next(b for b in ex.graph.blocks if b.name == name)


def unconjugated_steering(ex):
    """MusicDOA handed a(theta) itself: the bearings read 180 degrees
    off."""
    music = _block(ex, "music")
    music.steering = music.steering.conj()


def row_lo_offset(ex):
    """The channel of antenna r rotated by a further 0.3 r rad, as a
    channelizer whose LO phase differed row by row."""
    chan = _block(ex, "chan")
    apply = chan.apply

    def shifted(state, params, x):
        state, (y,) = apply(state, params, x)
        rot = torch.polar(torch.ones(y.data.shape[1]),
                          0.3 * torch.arange(y.data.shape[1],
                                             dtype=torch.float32))
        return state, (y.like(y.data * rot, count=y.count),)
    chan.apply = shifted


def rows_swapped(ex):
    """Antennas 1 and 2 swapped in every block the step sees."""
    def around(step, st, pr, ins):
        s = ins["iq"]
        d = s.data[:, [0, 2, 1, 3, 4]]
        return step(st, pr, {"iq": s.like(d, count=s.count)})
    _wrap(ex, around)


FAULTS = dict(unconjugated_steering=unconjugated_steering,
              row_lo_offset=row_lo_offset, rows_swapped=rows_swapped)


def one_run(**kw):
    return run.run_cell(manifest.cell("doa.replay"), 2 ** 31 + 2027, 1.0,
                        False, CPU, time.perf_counter(), traffic=SMALL, **kw)


def test_sound_run_is_correct():
    res, _ = one_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"replay_msps", "setup_s"}
    assert list(res["checks"]) == ["doa_off", "peak_gap_db",
                                   "spectrum_gap_db", "undelivered"]


def test_control_is_not_correct():
    res, _ = one_run(control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    res, _ = one_run(fault=FAULTS[fault])
    assert not res["correct"], res["checks"]
    if fault == "unconjugated_steering":
        assert res["checks"]["doa_off"]["value"] > 0


def test_new_metrics_declared_for_the_cell_only():
    by_name = {m["name"]: m for m in manifest.bench()["per_layer"]}
    for name in NEW:
        assert by_name[name]["workloads"] == ["doa.replay"]
        assert by_name[name]["moves"] == "replay_msps"
        assert manifest.metric_reader(name)(
            types.SimpleNamespace(trace=None)) is None
    assert set(NEW) <= {m["name"] for m in manifest.per_layer("doa.replay")}
    for cell in ("rtl_fm.replay", "scanner.replay", "lrpt.replay"):
        assert not set(NEW) & {m["name"] for m in manifest.per_layer(cell)}


def test_music_metrics_hand_worked(monkeypatch):
    """``music_ms``: the mean ``block.music`` a block; ``music_syncs``:
    the ``music.sync`` spans of the blocks that have a ``block.music``,
    over those blocks; both None without the program's spans."""
    from grbaz_tpu_torch.core import trace
    span = trace.Span
    got = [span("block.music", 0, 0, None, 10.10, 10.15, None),
           span("music.sync", 0, 0, "music.subspace", 10.12, 10.13, 3),
           span("music.sync", 0, 0, "music.subspace", 10.13, 10.14, 0),
           span("block.music", 0, 1, None, 10.60, 10.62, None),
           span("music.sync", 0, 1, "music.subspace", 10.61, 10.615, 0),
           span("block.music", 0, 2, None, 11.20, 11.30, None)]  # after
    monkeypatch.setattr(trace, "spans", lambda t0, t1: [
        s for s in got if t0 <= s.t0 < t1])
    ctx = types.SimpleNamespace(trace=spans.Trace(10.0, 11.0, []))
    ms = manifest.metric_reader("music_ms.replay")
    syncs = manifest.metric_reader("music_syncs.replay")
    assert ms(ctx) == pytest.approx(1e3 * (0.05 + 0.02) / 2, rel=1e-9)
    assert syncs(ctx) == pytest.approx(3 / 2, rel=1e-12)
    monkeypatch.setattr(trace, "spans", lambda t0, t1: [])
    assert ms(ctx) is None and syncs(ctx) is None


def test_chan_rows_roofline_hand_worked():
    """The row entry's least time at the cell's shape (5 rows of B1's
    bytes, the taps, phase and increment once) over its mean launch; the
    one-stream B1 instance is not counted."""
    from radiobench.work import b1_rows
    cfg = manifest.config("doa")
    n, tpad, rows = 1 << 18, 80, 5
    assert b1_rows.work(n, tpad, 8, rows) == (
        rows * (8 * n + 8 * tpad + 8 * (n // 8)) + 4 * tpad + 16,
        rows * (6 * n + 4 * tpad * (n // 8)))
    bound = b1_rows.bound(cfg, n)
    assert bound == pytest.approx(b1_rows.work(n, tpad, 8, rows)[0] / 3.35e12,
                                  rel=1e-12)
    row = ("void pfir::polyphase_fir_kernel<float2, 8, pfir::RotatedTaps, "
           "pfir::StoreRotated, pfir::Interleaved>(pfir::Problem, "
           "pfir::Layout)")
    one = row.replace("Interleaved", "Contiguous")
    tr = spans.Trace(10.0, 11.0, [(row, "kernel", 10.1, 10.10001),
                                  (row, "kernel", 10.2, 10.20002),
                                  (one, "kernel", 10.3, 10.4)])
    ctx = types.SimpleNamespace(trace=tr, cfg=cfg, traffic=dict(block=n))
    read = manifest.metric_reader("chan_rows_roofline")
    assert read(ctx) == pytest.approx(100 * bound / 1.5e-5, rel=1e-6)
    ctx.trace = spans.Trace(10.0, 11.0, tr.events[2:])
    assert read(ctx) is None
