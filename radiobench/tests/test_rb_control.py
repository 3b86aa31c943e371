"""The comparison that decides ``correct``, driven through whole runs
on the CPU at small sizes (the port's plain backend): a sound run
passes; the control (the reference in TF32 in the program's place)
fails; so does the program with each fault a cell can have planted
underneath the timed path."""

import time

import pytest
import torch

from radiobench import manifest, run
from radiobench.tests.faults import FAULTS

SMALL = {
    "rtl_fm": dict(loop="closed", streams=1, block=1 << 14, ring=3,
                   warmup_blocks=1, checks=3),
    "scanner": dict(loop="closed", streams=1, block=1 << 13, ring=3,
                    warmup_blocks=1, checks=3),
}
LIVE = dict(loop="open", streams=2, block=1 << 12, rate_sps=2e5, ring=3,
            warmup_blocks=1, checks=2)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def one_run(cell, traffic, **kw):
    res, info = run.run_cell(manifest.cell(cell), 2 ** 31 + 77, 1.0, False,
                             torch.device("cpu"), time.perf_counter(),
                             traffic=traffic, **kw)
    return res, info


@pytest.mark.parametrize("config", ["rtl_fm", "scanner"])
def test_sound_run_is_correct(config):
    res, info = one_run(f"{config}.replay", SMALL[config])
    assert res["correct"], res["checks"]
    assert res["attempted"] > 3 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"replay_msps", "setup_s"}


@pytest.mark.parametrize("config", ["rtl_fm", "scanner"])
def test_open_loop_run_is_correct_and_timed(config):
    """The live mix the sweep drives: every block due is delivered,
    correct, and timed from its due time."""
    cell = dict(name=f"{config}.open", config=config, traffic="live_k2",
                chips=1)
    res, info = run.run_cell(cell, 2 ** 31 + 78, 1.0, False,
                             torch.device("cpu"), time.perf_counter(),
                             traffic=LIVE)
    assert res["correct"], res["checks"]
    assert res["attempted"] == info["attempted"] >= 2 * 40
    assert len(info["latencies"]) == info["attempted"]
    assert all(x > 0 for x in info["latencies"])


@pytest.mark.parametrize("config", ["rtl_fm", "scanner"])
def test_control_is_not_correct(config):
    res, _ = one_run(f"{config}.replay", SMALL[config], control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("config", ["rtl_fm", "scanner"])
def test_fault_is_not_correct(config, fault):
    res, _ = one_run(f"{config}.replay", SMALL[config], fault=FAULTS[fault])
    assert not res["correct"], res["checks"]
