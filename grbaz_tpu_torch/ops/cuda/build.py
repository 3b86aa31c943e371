"""Build and load the port's CUDA kernels at first use.

Each ``grbaz_tpu_torch/csrc/<name>.cu`` exposes a plain C interface. It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``grbaz_tpu_torch/_build/`` (git-ignored) and loaded with ``ctypes``;
pointers come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``. The sources do not include
PyTorch's headers, so a build takes seconds rather than minutes.

A library is named after the hash of its source and of the shared
headers (``csrc/*.cuh``), so an edited source or header is rebuilt and
an unchanged one is reused. :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNEL_SOURCES = ("xlating_fir", "fir_decimate", "xlating_fir_ctaps",
                  "peak_fsm", "channel_bank", "fastrak_fsm", "vrr_walk",
                  "viterbi", "acars_fsm", "manchester_fsm", "dpll_walk",
                  "audio_tail", "auto_fec")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """The library of ``<name>.cu``, named after the hash of the source,
    every header of ``CSRC`` (a source may include any of them) and the
    compiler flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process each, all started together. Returns each compiler's
    output (register and shared-memory use from ``-Xptxas=-v``); raises
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed. On the
    first load each entry point in ``signatures`` gets those argument
    types and an ``int`` (CUDA error code) result."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def chain_step_ns(lib: ctypes.CDLL, probe: str, steps: int) -> float:
    """(Benchmark hook.) ns of one dependent step of a serial kernel on
    the current card: ``lib.<probe>(k, out, stream)`` runs k steps of the
    kernel's step alone; timed with CUDA events over ``steps`` and
    ``2 * steps`` steps, their difference taking out the launch."""
    import torch

    out = torch.empty(256, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(k):
        check(getattr(lib, probe)(k, out.data_ptr(), stream), probe)
    run(1024)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for k in (steps, 2 * steps):
        start.record()
        run(k)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return (times[1] - times[0]) * 1e6 / steps
