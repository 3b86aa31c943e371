"""The port imports neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "grbaz_tpu_torch")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import grbaz_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'grbaz_tpu' or m.startswith('grbaz_tpu.'))\n"
        "print(' '.join(m for m in sys.modules\n"
        "               if m.startswith('grbaz_tpu_torch')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = set(res.stdout.split())
    assert len(loaded) >= 24  # every module was imported
    assert NEW_MODULES <= loaded, NEW_MODULES - loaded


# the modules of BASELINE configs 1, 3, 4 and 5, of the burst path, of
# the simple and per-sample blocks with their two kernels, and of the
# decoders and FEC with their four, of the P25 and FMCW chains, the
# multi-device patterns, and the ingest entry points and receive apps
NEW_MODULES = {f"grbaz_tpu_torch.{m}" for m in (
    "ops.agc", "ops.spectral", "ops.colour", "ops.segments", "ops.detect",
    "ops.doa", "models.spectral", "parallel.channel_bank", "ops.burst",
    "ops.mux", "ops.hopper", "ops.cuda.peak_fsm", "ops.basic", "ops.misc",
    "ops.cuda.fastrak_fsm", "ops.cuda.vrr_walk", "ops.decode", "ops.fec",
    "models.auto_fec", "models.fec_sync", "utils.acars",
    "ops.cuda.viterbi", "ops.cuda.acars_fsm", "ops.cuda.manchester_fsm",
    "ops.cuda.dpll_walk", "utils.des", "ops.p25_fec", "ops.p25_ldu",
    "ops.p25", "ops.fsk4", "models.p25", "models.p25_voice",
    "viz.traffic", "models.fmcw", "parallel._collectives", "parallel.doa",
    "parallel.tp", "parallel.wbfm_bank", "parallel.pipeline",
    "core.config", "native", "net.udp", "net.devices", "net.borip_server",
    "net.borip_client", "io.file_source", "viz.export", "viz.sinks",
    "apps.rtl_fm", "apps.realtime_fft", "apps.fac", "apps.am_fft",
    "apps.scanner", "apps.papr")}


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_jax(path):
    text = open(path).read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+grbaz_tpu(\.|\s|$)", text,
                         re.M)
    assert "grbaz_tpu." not in text.replace("grbaz_tpu_torch", "")


def test_cuda_device_without_card_raises():
    import torch

    from grbaz_tpu_torch.core.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
