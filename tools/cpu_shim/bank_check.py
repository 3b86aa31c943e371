#!/usr/bin/env python3
"""Rehearse the channel bank's kernel on the CPU, where there is no nvcc.

    python3 tools/cpu_shim/bank_check.py [BUILD_DIR] [--csrc DIR]

Rewrites ``grbaz_tpu_torch/csrc/channel_bank.cu`` and ``polyphase_fir.cuh``
(or those in ``--csrc``, e.g. a mutant's copy) for ``cuda_shim.h``, a CPU
emulation of what the kernel uses: one ``std::thread`` a CUDA thread and
blocks in turn, ``__syncthreads`` and the warp and warpgroup syncs as
barriers, shuffles through a slot array, ``cp.async`` as ``memcpy``
(zero-filled), TF32 rounding in software, and ``wgmma.m64n32k8`` (A from
the warpgroup's registers, B read through the descriptor's start, LBO and
SBO) computed on the warpgroup's fragments. Shared memory is filled with
NaN before every block. The rewrite is built with g++ into BUILD_DIR
(default ``_archive/cpu_shim``, git-ignored) and called with ctypes on CPU
tensors against ``channel_bank_plain`` at 1e-5 of the max, over cases
that take one slab and several, several head passes and frame slabs, and
decims below and above a slab. Exits non-zero if a case fails.

The emulation checks indices, layouts and barriers, not timing or the
memory model; a form that passes here still needs its card run.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from grbaz_tpu_torch.ops import fir  # noqa: E402
from grbaz_tpu_torch.ops.cuda import channel_bank as cb  # noqa: E402

FS = 3.2e6


def rewrite(s: str) -> str:
    """CUDA source -> C++ over cuda_shim.h."""
    s = s.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    s = s.replace('asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));',
                  "r = __float_as_uint(shim_tf32(v));")
    s = re.sub(r'asm volatile\(\s*"\{\\n\.reg \.pred p;.*?\);',
               "shim_wgmma(d, a, b);", s, flags=re.S)
    s = re.sub(r'asm volatile\("(wgmma\.|fence\.proxy)[^;]*;[^;]*;', ";", s)
    s = re.sub(r'asm volatile\("wgmma\.wait_group[^;]*;[^;]*;', ";", s)
    s = re.sub(r"(void cp_async\(void\* dst, const void\* src,\s*"
               r"int src_bytes\) \{).*?\n\}",
               r"\1 std::memset(dst, 0, BYTES); "
               r"std::memcpy(dst, src, src_bytes); }", s, flags=re.S)
    s = re.sub(r"(void cp_async_wait_all\(\) \{).*?\n\}", r"\1 }", s,
               flags=re.S)
    s = re.sub(r'asm volatile\(""[^;]*;', ";", s)
    s = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char smem\[\];",
               "unsigned char* smem = shim_smem_ptr;", s)
    return re.sub(r"([\w:<>, ]+?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  lambda m: f"shim_launch({m.group(1).strip()}, "
                  f"{m.group(2)}, {m.group(3)});", s, flags=re.S)


def build(csrc: pathlib.Path, out: pathlib.Path) -> pathlib.Path:
    out.mkdir(parents=True, exist_ok=True)
    (out / "channel_bank.cpp").write_text(
        rewrite((csrc / "channel_bank.cu").read_text()))
    (out / "polyphase_fir.cuh").write_text(
        rewrite((csrc / "polyphase_fir.cuh").read_text()))
    (out / "cuda_shim.h").write_text(
        (pathlib.Path(__file__).parent / "cuda_shim.h").read_text())
    so = out / "libbank_shim.so"
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-o", str(so),
                        str(out / "channel_bank.cpp")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stderr[-6000:])
    return so


def case(lib, slots, n, decim, wrap, seed=0, taps=None, xoff=0):
    gen = np.random.default_rng(seed)
    if taps is None:
        taps = fir.low_pass_taps(1.0, FS, 112.5e3, 75e3)
    h = torch.from_numpy(fir.prepare_taps(taps, decim))
    tpad = h.shape[0]

    def cn(*s):
        return torch.from_numpy((gen.standard_normal(s) + 1j
                                 * gen.standard_normal(s)).astype(np.complex64))
    x = cn(n + xoff)[xoff:]
    tail = cn(slots, tpad - 1)
    if wrap:
        ph = gen.integers(2 ** 32 - 4096, 2 ** 32, slots)
        inc = gen.integers(2 ** 31, 2 ** 32, slots)
    else:
        ph = gen.integers(0, 2 ** 32, slots)
        inc = gen.integers(0, 2 ** 26, slots)
    ph, inc = torch.from_numpy(ph), torch.from_numpy(inc)
    ref_y, ref_t = cb.channel_bank_plain(x, tail, h, decim, ph, inc)
    n_out = n // decim
    nan = complex(float("nan"), float("nan"))
    y = torch.full((slots, n_out), nan, dtype=torch.complex64)
    nt = torch.full_like(tail, nan)
    t0 = time.time()
    err = lib.channel_bank(x.data_ptr(), tail.data_ptr(), n, h.data_ptr(),
                           ph.data_ptr(), inc.data_ptr(), y.data_ptr(),
                           nt.data_ptr(), n_out, tpad, decim, slots, None)
    if err:
        print(f"slots {slots} n {n} D {decim} taps {tpad}: refused ({err})")
        return False
    ey = (float((y - ref_y).abs().max()) / float(ref_y.abs().max())
          if n_out else 0.0)
    et = float((nt - ref_t).abs().max()) / float(ref_t.abs().max())
    print(f"slots {slots} n {n} D {decim} taps {tpad} wrap {wrap} xoff "
          f"{xoff}: y {ey:.2e} tail {et:.2e} ({time.time() - t0:.1f} s)",
          flush=True)
    return ey < 1e-5 and et < 1e-5


def lp(transition):
    return fir.low_pass_taps(1.0, FS, 6.25e3, transition)


CASES = [
    (4, 300, 1, True, 3, np.ones(3, np.float32)),
    (2, 1000, 8, False, 4, np.hanning(8).astype(np.float32)),
    (3, 2000, 2, True, 5, np.hanning(50).astype(np.float32)),
    (3, 1000, 4, False),
    (1, 37, 8, True),
    (3, 8192 + 24, 8, True),
    (20, 8192 + 24, 8, False),
    (16, 4096, 8, True, 1, None, 1),
    (2, 999, 3, True),
    (5, 500, 1, False, 2, np.hanning(20).astype(np.float32)),
    # several slabs: 1544 taps at decim 8 (channel 12.5 kHz, transition
    # 5 kHz at 3.2 Msps), a short block and one past the head
    (4, 4000, 8, True, 6, lp(5e3)),
    (2, 600, 8, False, 7, lp(5e3)),
    # decim above a slab's taps; several head passes at decim 1
    (3, 40000, 256, True, 8, lp(2e3)),
    (2, 6000, 1, False, 9, np.hanning(5000).astype(np.float32)),
]


def main(argv) -> int:
    args = list(argv)
    csrc = ROOT / "grbaz_tpu_torch" / "csrc"
    if "--csrc" in args:
        i = args.index("--csrc")
        csrc = pathlib.Path(args[i + 1])
        del args[i:i + 2]
    out = pathlib.Path(args[0]) if args else ROOT / "_archive" / "cpu_shim"
    lib = ctypes.CDLL(str(build(csrc, out)))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.channel_bank.argtypes = [p, p, i64, p, p, p, p, p, i32, i32, i32,
                                 i32, p]
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    ok = all([case(lib, *c) for c in CASES])
    print("ALL OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
