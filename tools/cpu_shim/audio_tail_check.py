#!/usr/bin/env python3
"""Rehearse the audio tail's kernels (``csrc/audio_tail.cu``) on the CPU,
where there is no nvcc.

    python3 tools/cpu_shim/audio_tail_check.py [BUILD_DIR] [--csrc DIR]

Rewrites the source for ``cuda_shim.h`` (see ``bank_check.py``), builds it
with g++ into BUILD_DIR (default ``_archive/cpu_shim``, git-ignored) and
holds both entry points to their plain twins over chained blocks, the
outputs pre-filled with NaN so that a slot no thread writes shows. The
resampler: float32 and complex64 at the ratios 25/24, 8.33, 1.7 and 0.8,
full, partial and zero-count blocks, a ppb-scale retune and one down to
``min_ratio``, and start positions at the edges of ``mu_int`` and
``mu_frac``; counts, positions and tails equal, outputs within 1e-6 of the
largest. The deemphasis: block lengths from 1 to 2^17, full, partial,
zero-count and over-full counts, counts at the edges of the kernel's
tiles; x_prev equal, y_prev and the outputs within 1e-6 of the stream's
largest sample, both states held on a zero-count block. Exits non-zero
if a case fails.

The emulation checks indices and the block's exchanges, not timing or the
memory model.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(pathlib.Path(__file__).parent))

from fsm_check import build  # noqa: E402
from grbaz_tpu_torch.ops.cuda import audio_tail as at  # noqa: E402
from grbaz_tpu_torch.ops.demod import FMDeemphasis  # noqa: E402
from grbaz_tpu_torch.ops.resampler import (HIST,  # noqa: E402
                                           FractionalResampler,
                                           resample_step_plain)

REL = 1e-6


def shim_resample(lib, x, tail, count, mu_int, mu_frac, inc_int, inc_frac,
                  cap, taps):
    """The resampler's entry point on CPU tensors, as the wrapper calls
    it; the outputs NaN (int -7) until written."""
    y = torch.full((cap,), float("nan"), dtype=x.dtype)
    n_out = torch.tensor(-7, dtype=torch.int32)
    mu_i = torch.tensor(-7, dtype=torch.int32)
    mu_f = torch.tensor(-7, dtype=torch.int64)
    nt = torch.full((HIST,), float("nan"), dtype=x.dtype)
    err = lib.fractional_resample(
        x.data_ptr(), tail.data_ptr(), int(x.is_complex()), x.shape[0],
        count.data_ptr(), mu_int.data_ptr(), mu_frac.data_ptr(),
        inc_int.data_ptr(), inc_frac.data_ptr(), taps.data_ptr(), cap,
        y.data_ptr(), n_out.data_ptr(), mu_i.data_ptr(), mu_f.data_ptr(),
        nt.data_ptr(), None)
    assert err == 0, err
    return y, n_out, mu_i, mu_f, nt


def shim_deemph(lib, x, count, y_prev, x_prev, b0, b1, a):
    y = torch.full_like(x, float("nan"))
    y_p, x_p = torch.tensor(float("nan")), torch.tensor(float("nan"))
    err = lib.fm_deemphasis(x.data_ptr(), x.shape[0], count.data_ptr(),
                            y_prev.data_ptr(), x_prev.data_ptr(),
                            float(np.float32(b0)), float(np.float32(b1)),
                            float(np.float32(a)), y.data_ptr(),
                            y_p.data_ptr(), x_p.data_ptr(), None)
    assert err == 0, err
    return y, y_p, x_p


def _gap(got, ref):
    scale = float(ref.abs().max())
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max()) / scale if scale else \
        float((got - ref).abs().max())


def resample_case(lib, dtype, n, ratio, counts, retunes=None,
                  start=None, seed=0):
    """Chained blocks through the shim and the plain step; ``retunes``
    maps a block index to a new ratio, ``start`` gives (mu_int,
    mu_frac)."""
    gen = np.random.default_rng(seed)
    blk = FractionalResampler(n, ratio, dtype=dtype, device="cpu")
    st = blk.init_state()
    if start is not None:
        st["mu_int"] = torch.tensor(start[0], dtype=torch.int32)
        st["mu_frac"] = torch.tensor(start[1], dtype=torch.int64)
    pr = blk.init_params()
    sk, sp = dict(st), dict(st)
    ok, seen = True, []
    for b, c in enumerate(counts):
        if retunes and b in retunes:
            p = FractionalResampler.ratio_params(retunes[b])
            pr = dict(inc_int=torch.tensor(int(p["inc_int"]),
                                           dtype=torch.int32),
                      inc_frac=torch.tensor(int(p["inc_frac"]),
                                            dtype=torch.int64))
        xs = gen.standard_normal((n, 2)).astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(
            xs[:, 0] if dtype == torch.float32 else xs[:, 0] + 1j * xs[:, 1])
        ).to(dtype)
        cnt = torch.tensor(c, dtype=torch.int32)
        got = shim_resample(lib, x, sk["tail"], cnt, sk["mu_int"],
                            sk["mu_frac"], pr["inc_int"], pr["inc_frac"],
                            blk.capacity, blk.taps_table)
        ref = resample_step_plain(x, sp["tail"], cnt, sp["mu_int"],
                                  sp["mu_frac"], pr["inc_int"],
                                  pr["inc_frac"], blk.capacity,
                                  blk.taps_table)
        same = all(int(g) == int(r) for g, r in zip(got[1:4], ref[1:4]))
        same &= torch.equal(got[4], ref[4])
        gap = _gap(got[0], ref[0])
        same &= gap <= REL
        if not same:
            print(f"  block {b}: count/mu_int/mu_frac "
                  f"{[int(v) for v in got[1:4]]} vs "
                  f"{[int(v) for v in ref[1:4]]}, y gap {gap:.2e}, tail "
                  f"{torch.equal(got[4], ref[4])}")
        ok &= same
        seen.append(int(ref[1]))
        sk = dict(tail=got[4], mu_int=got[2], mu_frac=got[3])
        sp = dict(tail=ref[4], mu_int=ref[2], mu_frac=ref[3])
    print(f"resample {dtype} n {n} ratio {ratio:.6g}"
          f"{' start ' + str(start) if start else ''}: "
          f"{'ok' if ok else 'DIFFERS'}, counts {seen}", flush=True)
    return ok


def deemph_case(lib, n, counts, seed=0):
    gen = np.random.default_rng(seed)
    blk = FMDeemphasis(48e3, device="cpu")
    st = blk.init_state()
    sk, sp = dict(st), dict(st)
    ok, worst, scale = True, 0.0, 0.0
    for b, c in enumerate(counts):
        x = torch.from_numpy(gen.standard_normal(n).astype(np.float32))
        cnt = torch.tensor(c, dtype=torch.int32)
        got = shim_deemph(lib, x, cnt, sk["y_prev"], sk["x_prev"],
                          blk.b[0], blk.b[1], blk.a)
        ref = at.deemphasis_plain(x, cnt, sp["y_prev"], sp["x_prev"],
                                  blk.b[0], blk.b[1], blk.a)
        # within 1e-6 of the stream's largest sample so far
        scale = max(scale, float(ref[0].abs().max()))
        err = float((got[0] - ref[0]).abs().max()) if bool(
            torch.isfinite(got[0]).all()) else float("inf")
        gap = err / scale
        worst = max(worst, gap)
        same = gap <= REL and torch.equal(got[2], ref[2])
        same &= abs(float(got[1]) - float(ref[1])) <= REL * scale
        if c <= 0:  # a block of count 0 holds both states bit for bit
            same &= float(got[1]) == float(sk["y_prev"])
            same &= bool((got[0] == sk["y_prev"]).all())
        if not same:
            print(f"  block {b} (count {c}): y gap {gap:.2e}, states "
                  f"{float(got[1])}, {float(got[2])} vs {float(ref[1])}, "
                  f"{float(ref[2])}")
        ok &= same
        sk = dict(y_prev=got[1], x_prev=got[2])
        sp = dict(y_prev=ref[1], x_prev=ref[2])
    print(f"deemph n {n} counts {counts}: {'ok' if ok else 'DIFFERS'}, "
          f"worst gap {worst:.2e}", flush=True)
    return ok


def main(argv) -> int:
    args = list(argv)
    csrc = ROOT / "grbaz_tpu_torch" / "csrc"
    if "--csrc" in args:
        i = args.index("--csrc")
        csrc = pathlib.Path(args[i + 1])
        del args[i:i + 2]
    out = pathlib.Path(args[0]) if args else ROOT / "_archive" / "cpu_shim"
    lib = ctypes.CDLL(str(build(csrc, out, "audio_tail")))
    for fn, argtypes in at._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    ok = True
    n = 4096
    for dtype in (torch.float32, torch.complex64):
        for ratio in (25 / 24, 8.333333333333334, 1.7, 0.8):
            ok &= resample_case(lib, dtype, n, ratio,
                                [n, n, n - 333, 0, n, n, n, n],
                                retunes={4: ratio * (1 + 3e-7),
                                         6: ratio * 0.9})
    for start in ((-2, 0), (0, 2 ** 32 - 1), (HIST, 2 ** 32 - 1),
                  (n - 1, 123456), (n, 0), (n + 5, 2 ** 31)):
        ok &= resample_case(lib, torch.float32, n, 25 / 24, [n, n - 1, n],
                            start=start)
    ok &= resample_case(lib, torch.float32, 16384, 25 / 24,
                        [16384, 16384, 16000, 0, 16384])
    for m, counts in ((1, [1, 0, 1]), (5, [5, 3, 0, 9]),
                      (1000, [1000, 1, 0, 999, 1000]),
                      (17477, [17477, 17064, 0, 17064]),
                      (17477, [8192, 8193, 16384, 16385, 8191]),
                      (1 << 17, [1 << 17, 100000, 0, 1 << 17])):
        ok &= deemph_case(lib, m, counts)
    print("ALL OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
