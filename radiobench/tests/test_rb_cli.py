"""The command as the driver runs it: refused without a card or without
the program, and, on the card, one result line."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["-m", "radiobench.run", "--workload", "rtl_fm.replay", "--seed",
        "2147483999", "--seconds", "2", "--trace", "0"]


def cli(cwd, *args):
    return subprocess.run([sys.executable, *ARGS, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "radiobench", tmp_path / "radiobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_one_result_line_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = cli(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"replay_msps", "setup_s"}
    assert list(res)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
