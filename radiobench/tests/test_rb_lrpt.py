"""The `lrpt` configuration's benchmark files on the CPU, at small sizes
(the port's plain backend): a sound run is correct and the TF32 control
and every fault are not; the reference equals the port block by block
across the ring's wrap, and its periodic answers equal the stream
decoded block by block; and the two per-layer metrics it adds, worked by
hand."""

import time
import types

import numpy as np
import pytest
import torch

from radiobench import manifest, run, spans
from radiobench.tests.faults import FAULTS

CPU = torch.device("cpu")
SMALL = dict(loop="closed", streams=2, block=1 << 10, ring=3,
             warmup_blocks=1, checks=3)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def one_run(**kw):
    return run.run_cell(manifest.cell("lrpt.replay"), 2 ** 31 + 77, 1.0,
                        False, CPU, time.perf_counter(), traffic=SMALL, **kw)


def test_sound_run_is_correct():
    res, _ = one_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 3 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"replay_msps", "setup_s"}


def test_control_is_not_correct():
    res, _ = one_run(control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    res, _ = one_run(fault=FAULTS[fault])
    assert not res["correct"], res["checks"]


def test_reference_matches_the_plain_backend():
    cfg, prog = manifest.config("lrpt"), manifest.program("lrpt")
    ref = manifest.reference("lrpt")
    block = 1 << 10
    ring = prog.ring(cfg, 1, 3, block, 2 ** 31 + 5, CPU)[0]
    ex = prog.executor(cfg, block, CPU)
    for j in range(7):
        outs = ex.step({"iq": ring[j % 3]})
        want = ref.outputs(cfg, ring, j, "f64", CPU)
        nums = ref.numbers({p: outs[p] for p in prog.PORTS}, want)
        for name, v in nums.items():
            assert v <= 1e-6 if name.endswith("pm_gap") else v == 0, \
                (j, nums)


def test_periodic_trajectory_is_the_sequential_replay():
    """Each stream's answers from the table, folded onto its periodic
    ring once locked, equal the stream decoded block by block, past three
    periods of the ring."""
    from radiobench.reference import lrpt
    cfg, prog = manifest.config("lrpt"), manifest.program("lrpt")
    rings = prog.ring(cfg, 2, 3, 1 << 9, 2 ** 31 + 9, CPU)
    for k in range(2):
        tab, row = lrpt.table(cfg, rings[k], "f64", CPU)
        assert row == k
        n = next(j for j in range(64) if tab.image(k, j) != j) + 3 * 3
        assert tab.period[k] is not None
        for j, want in enumerate(lrpt.replay(cfg, rings[k], n, "f64", CPU)):
            got = lrpt.outputs(cfg, rings[k], j, "f64", CPU)
            assert set(got) == set(want)
            for port in want:
                np.testing.assert_array_equal(got[port], want[port],
                                              err_msg=f"{k} {j} {port}")


def test_viterbi_roofline_hand_worked():
    """K3's least time at the cell's shape over one decode's device time:
    the mean launch of each of its three kernels, summed."""
    from radiobench.work import viterbi
    cfg = manifest.config("lrpt")
    tr = spans.Trace(10.0, 11.0, [
        ("void viterbi_warp<2>(float2 const*)", "kernel", 10.1, 10.104),
        ("void viterbi_warp<2>(float2 const*)", "kernel", 10.2, 10.206),
        ("trace_map(unsigned int const*)", "kernel", 10.3, 10.3001),
        ("trace_bits(unsigned int const*)", "kernel", 10.4, 10.4002),
        ("trace_bits(unsigned int const*)", "kernel", 10.5, 10.5004),
        ("Memcpy DtoH", "gpu_memcpy", 10.6, 10.7)])
    ctx = types.SimpleNamespace(trace=tr, cfg=cfg,
                                traffic=dict(block=1 << 16))
    read = manifest.metric_reader("viterbi_roofline")
    t_len, chunks = (1 << 16) + 96, -(-((1 << 16) + 96) // 512)
    bound = viterbi.bound(cfg, 1 << 16)
    assert bound == max(
        (8 * t_len + 2 * (t_len * 64 // 8) + 2 * 4 * 64 * chunks + t_len
         + 4 * 64) / 3.35e12, (4 + 5 * 64) * t_len / 67e12)
    assert read(ctx) == pytest.approx(100 * bound / 0.0054, rel=1e-9)
    ctx.trace = spans.Trace(10.0, 11.0, tr.events[:2])
    assert read(ctx) is None
    assert read(types.SimpleNamespace(trace=None)) is None


def test_fec_ms_hand_worked(monkeypatch):
    """The mean ``block.fec`` host span a block, over the profiled part
    of the window; None with no trace or no tracer."""
    import sys
    from grbaz_tpu_torch.core import trace
    span = trace.Span
    got = [span("block.fec", 0, 0, None, 10.1, 10.15, None),
           span("block.fec", 1, 0, None, 10.6, 10.62, None),
           span("block.fec", 0, 1, None, 11.2, 11.3, None)]  # after
    monkeypatch.setattr(trace, "spans", lambda t0, t1: [
        s for s in got if t0 <= s.t0 < t1])
    read = manifest.metric_reader("fec_ms.replay")
    ctx = types.SimpleNamespace(trace=spans.Trace(10.0, 11.0, []))
    assert read(ctx) == pytest.approx(1e3 * (0.05 + 0.02) / 2, rel=1e-9)
    assert read(types.SimpleNamespace(trace=None)) is None
    import grbaz_tpu_torch.core as core
    monkeypatch.delattr(core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "grbaz_tpu_torch.core.trace", None)
    assert read(ctx) is None


def test_new_metrics_declared_for_the_cell():
    by_name = {m["name"]: m for m in manifest.bench()["per_layer"]}
    for name in ("viterbi_roofline", "fec_ms.replay"):
        assert by_name[name]["workloads"] == ["lrpt.replay"]
        assert by_name[name]["moves"] == "replay_msps"
    assert {"viterbi_roofline", "fec_ms.replay"} <= {
        m["name"] for m in manifest.per_layer("lrpt.replay")}
