#!/usr/bin/env python3
"""Rehearse the decoders' kernels (Viterbi, ACARS, Manchester, DPLL) on
the CPU, where there is no nvcc.

    python3 tools/cpu_shim/decode_check.py [BUILD_DIR] [--csrc DIR]

Rewrites ``grbaz_tpu_torch/csrc/viterbi.cu``, ``acars_fsm.cu``,
``manchester_fsm.cu`` and ``dpll_walk.cu`` (or those in ``--csrc``) for
``cuda_shim.h`` (see ``bank_check.py``), builds each with g++ into
BUILD_DIR (default ``_archive/cpu_shim``, git-ignored) and calls it
through its wrapper's own argument preparation (``_launch``) on CPU
tensors, holding it bit for bit to the plain version: the Viterbi
decoder's bits and final path metrics at K = 3 to 9 across its staging
chunks and on erasures (equal candidates, where the first predecessor
must win), the FSMs' outputs and whole state over chained calls with
partial counts and overflowing emissions. Exits non-zero if a case
fails.

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


def viterbi_cases(lib):
    ok = True
    rng = np.random.default_rng(5)
    for k, polys in ((3, (7, 5)), (4, (0o17, 0o13)), (5, (0o23, 0o35)),
                     (6, (0o53, 0o75)), (7, (0o171, 0o133)),
                     (8, (0o247, 0o371)), (9, (0o561, 0o753))):
        exp = torch.from_numpy(fec.expected_outputs(k, polys))
        for t_len, noise in ((300, 0.0), (2100, 0.7), (1500, "ties")):
            bits = rng.integers(0, 2, t_len).astype(np.uint8)
            soft = fec.conv_encode(bits, k, polys).astype(np.float32) * 2 - 1
            if noise == "ties":   # erasures and +-1: equal candidates
                soft = soft * rng.integers(0, 2, soft.shape)
            else:
                soft = soft + noise * rng.standard_normal(soft.shape)
            soft = torch.from_numpy(soft.astype(np.float32))
            gk = vt._launch(lib, soft, exp, None)
            gp = fec.viterbi_plain(soft, exp)
            good = same(gk[0], gp[0]) and same(gk[1], gp[1])
            print(f"viterbi K={k} T={t_len} noise {noise}: "
                  f"{'ok' if good else 'DIFFERS'}", flush=True)
            ok &= good
    return ok


def main(argv) -> int:
    args = list(argv)
    csrc = ROOT / "grbaz_tpu_torch" / "csrc"
    if "--csrc" in args:
        i = args.index("--csrc")
        csrc = pathlib.Path(args[i + 1])
        del args[i:i + 2]
    out = pathlib.Path(args[0]) if args else ROOT / "_archive" / "cpu_shim"
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    ok = viterbi_cases(load(csrc, out, "viterbi", vt))
    rng = np.random.default_rng(7)
    rows, n = 5, 3000

    def split(a):
        return [torch.from_numpy(np.ascontiguousarray(
            a[:, c * n:(c + 1) * n])) for c in range(3)]

    lib = load(csrc, out, "acars_fsm", af)
    m, _ = chip_smoke.acars_rows(rng, rows, 3 * n, gap=(5, 40))
    st = chip_smoke.rows_state(decode.ACARSDecoder(device="cpu"), rows, "cpu")
    ok &= chained("acars, more than 4 packets a call",
                  lambda x, s: af._launch(lib, x, s, 2, None),
                  lambda x, s: decode.acars_plain(x, s, 2), split(m), st)

    lib = load(csrc, out, "manchester_fsm", mf)
    chips, _ = chip_smoke.manchester_rows(rng, rows, 3 * n)
    st = chip_smoke.rows_state(decode.ManchesterDecode(device="cpu"), rows,
                               "cpu")
    counts = torch.tensor([n, n - 7, n - 1000, 1, n], dtype=torch.int32)
    for original in (False, True):
        ok &= chained(
            f"manchester, partial counts, original {original}",
            lambda x, s: mf._launch(lib, x, counts, s, original, 12, 5, None),
            lambda x, s: decode.manchester_plain(x, counts, s, original, 12,
                                                 5), split(chips), st)

    lib = load(csrc, out, "dpll_walk", dw)
    pulses = chip_smoke.pulse_rows(rng, rows, 3 * n, period=(3.0, 120.0))
    st = chip_smoke.rows_state(decode.DPLLBitSync(16.0, device="cpu"), rows,
                               "cpu")
    st["period"] = torch.tensor([3.1, 40.0, 97.0, 60.0, 119.0])
    for gain, rel in ((0.05, 0.05), (0.3, 0.4)):
        ok &= chained(f"dpll, gain {gain}, limit {rel}, overflowing events",
                      lambda x, s: dw._launch(lib, x, s, gain, rel, 0.5,
                                              None),
                      lambda x, s: decode.dpll_plain(x, s, gain, rel, 0.5),
                      split(pulses), st)
    print("ALL OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
