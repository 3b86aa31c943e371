#!/usr/bin/env python3
"""Rehearse the decoders' kernels (Viterbi, ACARS, Manchester, DPLL) on
the CPU, where there is no nvcc.

    python3 tools/cpu_shim/decode_check.py [BUILD_DIR] [--csrc DIR] [--mutants]

Rewrites ``grbaz_tpu_torch/csrc/viterbi.cu``, ``acars_fsm.cu``,
``manchester_fsm.cu`` and ``dpll_walk.cu`` (or those in ``--csrc``) for
``cuda_shim.h`` (see ``bank_check.py``), builds each with g++ into
BUILD_DIR (default ``_archive/cpu_shim``, git-ignored) and calls it
through its wrapper's own argument preparation (``_launch``) on CPU
tensors, holding it bit for bit to the plain version: the Viterbi
decoder's bits and final path metrics at K = 2 to 12 (the warp form to
K = 9, the block form beyond) at one step and at lengths below, at and
across the traceback's chunk edges for several chunk sizes, and on
erasures (equal candidates, where the first predecessor must win); the
FSMs' outputs and whole state over chained calls with partial counts and
overflowing emissions (the DPLL also on ``chip_smoke.dpll_edge_rows``,
with and without the fused gain product). With ``--mutants``, each edit
of ``MUTANTS`` (ties taken with >=, a traceback chunk's map one step
short, the FMA's product swapped, ...) is built from its own copy of the
sources and must fail. Exits non-zero if a case fails or a mutant
passes.

The emulation checks indices, layouts and the warp's exchanges, not
timing or the memory model.
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

import chip_smoke  # noqa: E402
from fsm_check import build  # noqa: E402
from grbaz_tpu_torch.ops import decode, fec  # noqa: E402
from grbaz_tpu_torch.ops.cuda import acars_fsm as af  # noqa: E402
from grbaz_tpu_torch.ops.cuda import dpll_walk as dw  # noqa: E402
from grbaz_tpu_torch.ops.cuda import manchester_fsm as mf  # noqa: E402
from grbaz_tpu_torch.ops.cuda import viterbi as vt  # noqa: E402


def load(csrc, out, name, module):
    lib = ctypes.CDLL(str(build(csrc, out, name)))
    for fn, argtypes in module._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def same(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def chained(label, launch, plain, xs, st):
    """Each input of ``xs`` through the shim's kernel and the plain
    version in turn, each from its own last state."""
    sk = sp = st
    ok = True
    for c, x in enumerate(xs):
        gk, gp = launch(x, sk), plain(x, sp)
        sk, sp = gk[-1], gp[-1]
        same_out = all(same(a, b) for a, b in zip(gk[:-1], gp[:-1]))
        same_st = all(same(sk[k], sp[k]) for k in sp)
        if not (same_out and same_st):
            print(f"  call {c}: outputs {same_out}, state "
                  + ", ".join(k for k in sp if not same(sk[k], sp[k])))
        ok &= same_out and same_st
    print(f"{label}: {'ok' if ok else 'DIFFERS'}", flush=True)
    return ok


# chip_smoke's codes but K = 15 (the block form's 512 threads a step are
# std::threads here)
VITERBI_CODES = {k: p for k, p in chip_smoke.VITERBI_CODES.items() if k <= 12}


def viterbi_cases(lib, ks=tuple(VITERBI_CODES)):
    """Bits and final path metrics bit for bit at each K of ``ks``: one
    step, a few steps, clean, noisy and erased pairs (ties), T below,
    at and across the traceback's chunk edges for several chunk sizes."""
    ok = True
    rng = np.random.default_rng(5)
    for k in ks:
        polys = VITERBI_CODES[k]
        exp = torch.from_numpy(fec.expected_outputs(k, polys))
        small = k >= 10    # the block form: 512 threads a step here
        for t_len, noise, chunk in ((1, 0.0, 32), (37, 0.7, 32),
                                    (300, 0.0, 64), (640, 0.7, 64),
                                    (1500 if not small else 700, "ties", 96),
                                    (2100 if not small else 600, 0.7,
                                     vt.TRACE_CHUNK)):
            bits = rng.integers(0, 2, t_len).astype(np.uint8)
            soft = fec.conv_encode(bits, k, polys).astype(np.float32) * 2 - 1
            if noise == "ties":   # erasures and +-1: equal candidates
                soft = soft * rng.integers(0, 2, soft.shape)
            else:
                soft = soft + noise * rng.standard_normal(soft.shape)
            soft = torch.from_numpy(soft.astype(np.float32))
            gk = vt._launch(lib, soft, exp, None, chunk)
            gp = fec.viterbi_plain(soft, exp)
            good = same(gk[0], gp[0]) and same(gk[1], gp[1])
            print(f"viterbi K={k} T={t_len} noise {noise} chunk {chunk}: "
                  f"{'ok' if good else 'DIFFERS'}", flush=True)
            ok &= good
    return ok


def fsm_cases(csrc, out, ks=tuple(VITERBI_CODES), parts=("viterbi", "acars",
                                                          "manchester",
                                                          "dpll")):
    """Every rehearsal case of the named kernels built from ``csrc``;
    whether all held."""
    ok = True
    if "viterbi" in parts:
        ok &= viterbi_cases(load(csrc, out, "viterbi", vt), ks)
    rng = np.random.default_rng(7)
    rows, n = 5, 3000

    def split(a, calls=3):
        return [torch.from_numpy(np.ascontiguousarray(
            a[:, c * n:(c + 1) * n])) for c in range(calls)]

    if "acars" in parts:
        lib = load(csrc, out, "acars_fsm", af)
        m, _ = chip_smoke.acars_rows(rng, rows, 3 * n, gap=(5, 40))
        st = chip_smoke.rows_state(decode.ACARSDecoder(device="cpu"), rows,
                                   "cpu")
        ok &= chained("acars, more than 4 packets a call",
                      lambda x, s: af._launch(lib, x, s, 2, None),
                      lambda x, s: decode.acars_plain(x, s, 2), split(m), st)

    if "manchester" in parts:
        lib = load(csrc, out, "manchester_fsm", mf)
        chips, _ = chip_smoke.manchester_rows(rng, rows, 3 * n)
        st = chip_smoke.rows_state(decode.ManchesterDecode(device="cpu"),
                                   rows, "cpu")
        counts = torch.tensor([n, n - 7, n - 1000, 1, n], dtype=torch.int32)
        for original in (False, True):
            ok &= chained(
                f"manchester, partial counts, original {original}",
                lambda x, s: mf._launch(lib, x, counts, s, original, 12, 5,
                                        None),
                lambda x, s: decode.manchester_plain(x, counts, s, original,
                                                     12, 5), split(chips), st)

    if "dpll" in parts:
        lib = load(csrc, out, "dpll_walk", dw)
        for m in (n, n - 1):    # rows of 4-byte words; rows of bytes
            pulses = np.concatenate([
                chip_smoke.pulse_rows(rng, rows, 3 * m, period=(3.0, 120.0)),
                chip_smoke.dpll_edge_rows(rng, m, calls=3)])
            st = chip_smoke.rows_state(decode.DPLLBitSync(16.0, device="cpu"),
                                       len(pulses), "cpu")
            st["period"] = torch.tensor([3.1, 40.0, 97.0, 60.0, 119.0, 16.0,
                                         47.5, 3.0, 100.0, 15.5, 40.0])
            xs = [torch.from_numpy(np.ascontiguousarray(
                pulses[:, c * m:(c + 1) * m])) for c in range(3)]
            for gain, rel, ign in ((0.05, 0.05, 0.5), (0.3, 0.4, 0.3),
                                   (0.1, 0.05, 0.5)):
                ok &= chained(
                    f"dpll, n {m}, gain {gain}, limit {rel}, fuse "
                    f"{decode.dpll_fuses_gain(gain, rel)}: edge rows, "
                    "overflowing events",
                    lambda x, s: dw._launch(lib, x, s, gain, rel, ign, None),
                    lambda x, s: decode.dpll_plain(x, s, gain, rel, ign),
                    xs, st)
    return ok


# (source, text, replacement, the cases that must catch it)
MUTANTS = {
    "viterbi ties (>=)": ("viterbi.cu", "c[q] = c1 > c0;",
                          "c[q] = c1 >= c0;", dict(ks=(7,),
                                                   parts=("viterbi",))),
    "viterbi chunk map one step short": (
        "viterbi.cu", "for (int j = len - 1; j >= 0; --j) s = pred(",
        "for (int j = len - 1; j >= 1; --j) s = pred(",
        dict(ks=(7,), parts=("viterbi",))),
    "viterbi block form ties (>=)": (
        "viterbi.cu", "const bool cl = l1 > l0, ch = h1 > h0;",
        "const bool cl = l1 >= l0, ch = h1 > h0;",
        dict(ks=(10,), parts=("viterbi",))),
    "dpll FMA's product swapped": (
        "dpll_walk.cu",
        "? __fmaf_rn(c.g, clamped, __fmul_rn(c.omg, s.period))",
        "? __fmaf_rn(c.omg, s.period, __fmul_rn(c.g, clamped))",
        dict(parts=("dpll",))),
    "dpll estimate from the pulse before": (
        "dpll_walk.cu", "before ? pper[before - 1] : start;",
        "before > 1 ? pper[before - 2] : start;", dict(parts=("dpll",))),
}


def mutants(csrc, out) -> bool:
    """Each mutant of ``MUTANTS`` in its own copy of ``csrc``: every one
    must fail its cases. Whether all did."""
    import shutil
    ok = True
    for i, (label, (src, old, new, kw)) in enumerate(MUTANTS.items()):
        d = out / f"mutant{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d / "csrc")
        f = d / "csrc" / src
        text = f.read_text()
        assert text.count(old) == 1, (label, old)
        f.write_text(text.replace(old, new))
        print(f"--- mutant: {label}", flush=True)
        caught = not fsm_cases(d / "csrc", d, **kw)
        print(f"mutant {label}: {'caught' if caught else 'NOT CAUGHT'}",
              flush=True)
        ok &= caught
    return ok


def main(argv) -> int:
    args = list(argv)
    csrc = ROOT / "grbaz_tpu_torch" / "csrc"
    if "--csrc" in args:
        i = args.index("--csrc")
        csrc = pathlib.Path(args[i + 1])
        del args[i:i + 2]
    with_mutants = "--mutants" in args
    if with_mutants:
        args.remove("--mutants")
    out = pathlib.Path(args[0]) if args else ROOT / "_archive" / "cpu_shim"
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    ok = fsm_cases(csrc, out)
    if with_mutants:
        ok &= mutants(csrc, out)
    print("ALL OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
