#!/usr/bin/env python3
"""Rehearse the FasTrak FSM and ratio-stream resampler kernels on the CPU,
where there is no nvcc.

    python3 tools/cpu_shim/fsm_check.py [BUILD_DIR] [--csrc DIR]

Rewrites ``grbaz_tpu_torch/csrc/fastrak_fsm.cu`` and ``vrr_walk.cu`` (or
those in ``--csrc``) for ``cuda_shim.h`` (see ``bank_check.py``), builds
them with g++ into BUILD_DIR (default ``_archive/cpu_shim``, git-ignored)
and holds them to their plain versions over chained calls. The FSM:
events, counts and the whole state bit for bit, at several chunk and
warm-up pairs, on sparse and dense frames, past 32 frames a call, and on
a sync stream held above the threshold (every chunk walked again). The
walk: counts, positions, overrun flags and tails equal and outputs within
1e-5 of the max, float32 and complex64, across tiles of the kernel and
with too small a capacity. Exits non-zero if a case fails.

The emulation checks indices, the order of the passes and the warp's
exchanges, not timing or the memory model.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(pathlib.Path(__file__).parent))

import chip_smoke  # noqa: E402
from bank_check import rewrite  # noqa: E402
from grbaz_tpu_torch.ops import misc  # noqa: E402
from grbaz_tpu_torch.ops.cuda import fastrak_fsm as ff  # noqa: E402
from grbaz_tpu_torch.ops.cuda import vrr_walk as vw  # noqa: E402
from grbaz_tpu_torch.ops.resampler import (HIST,  # noqa: E402
                                           VariableRatioResampler,
                                           vrr_walk_plain)


def build(csrc: pathlib.Path, out: pathlib.Path, name: str) -> pathlib.Path:
    out.mkdir(parents=True, exist_ok=True)
    src = rewrite((csrc / f"{name}.cu").read_text())
    for arr in ("bits", "buf"):
        src = src.replace(f"extern __shared__ unsigned {arr}[];",
                          f"unsigned* {arr} = (unsigned*)shim_smem_ptr;")
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = shim_smem_ptr;")
    (out / f"{name}.cpp").write_text(src)
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(rewrite(header.read_text()))
    (out / "cuda_shim.h").write_text(
        (pathlib.Path(__file__).parent / "cuda_shim.h").read_text())
    so = out / f"lib{name}_shim.so"
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-o", str(so), str(out / f"{name}.cpp")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stderr[-6000:])
    return so


def launch(lib, metric, sync, state, thr, os_, chunk, warm):
    """The kernel through the shim on CPU tensors, as the wrapper calls
    it on the card."""
    rows, n = metric.shape
    sin = torch.stack([state[k].reshape(rows).to(torch.int64)
                       .to(torch.int32) for k in misc.FT_FIELDS]).contiguous()
    events = torch.full((rows, misc.MAX_EVENTS, 3), float("nan"))
    n_ev = torch.full((rows,), -7, dtype=torch.int32)
    sout = torch.full_like(sin, -7)
    k = -(-n // chunk)
    rec = torch.full((rows * k, ff.REC), -7, dtype=torch.int32)
    frames = torch.full((rows * k, ff.frame_cap(chunk), 3), -7,
                        dtype=torch.int32)
    late = torch.full((rows * k * ff.frame_cap(chunk), 3), float("nan"))
    totals = torch.full((rows,), -7, dtype=torch.int32)
    repairs = torch.full((rows,), -7, dtype=torch.int32)
    thr = thr.reshape(-1).expand(rows).contiguous()
    err = lib.fastrak_fsm(metric.data_ptr(), sync.data_ptr(), n, rows,
                          thr.data_ptr(), sin.data_ptr(), events.data_ptr(),
                          n_ev.data_ptr(), sout.data_ptr(), os_, chunk, warm,
                          rec.data_ptr(), frames.data_ptr(), late.data_ptr(),
                          totals.data_ptr(), repairs.data_ptr(), None)
    assert err == 0, err
    new = {}
    for name, v in zip(misc.FT_FIELDS, sout):
        new[name] = (v.to(torch.int64) & 0xFFFFFFFF) if name in misc.FT_U32 \
            else v
    new["compute_crc"] = new["compute_crc"] != 0
    return events, n_ev, new, repairs


def case(lib, label, metric, sync, os_, chunk, warm, calls=2):
    rows, total = metric.shape
    n = total // calls
    st = {k: v.reshape(1).expand(rows).contiguous() for k, v in
          misc.FastrakDecoder(device="cpu").init_state().items()}
    thr = torch.tensor([1.0])
    sk, sp, ok, reps = st, st, True, []
    for c in range(calls):
        m = torch.from_numpy(np.ascontiguousarray(metric[:, c * n:(c + 1) * n]))
        y = torch.from_numpy(np.ascontiguousarray(sync[:, c * n:(c + 1) * n]))
        ek, ck, sk, rk = launch(lib, m, y, sk, thr, os_, chunk, warm)
        ep, cp, sp = misc.fastrak_fsm_plain(m, y, sp, thr, os_)
        same = (torch.equal(ek.view(torch.int32), ep.view(torch.int32))
                and torch.equal(ck, cp)
                and all(torch.equal(sk[k], sp[k]) for k in sp))
        ok &= same
        reps.append(int(rk.sum()))
        if not same:
            print(f"  call {c}: counts {ck.tolist()} vs {cp.tolist()}; "
                  + ", ".join(k for k in sp if not torch.equal(sk[k], sp[k])))
    print(f"{label} [{rows}, {n}] x{calls} chunk {chunk} warm {warm}: "
          f"{'ok' if ok else 'DIFFERS'}, events {cp.tolist()[:4]}, "
          f"repaired {reps} of {rows * -(-n // chunk)} a call", flush=True)
    return ok


def vrr_case(lib, label, dtype, n, blocks, ratio, per_input=2.0, seed=0):
    """Chained blocks of the walk through the shim and the plain version;
    the last block partial."""
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((blocks * n, 2)).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(
        x[:, 0] if dtype == torch.float32 else x[:, 0] + 1j * x[:, 1])
        ).to(dtype)
    k = np.arange(blocks * n)
    rr = torch.from_numpy((ratio * (1 + 0.05 * np.sin(k * 0.003)))
                          .astype(np.float32))
    blk = VariableRatioResampler(n, per_input, dtype=dtype, device="cpu")
    st_k = st_p = blk.init_state()
    ok, counts = True, []
    for b in range(blocks):
        xs, rs = x[b * n:(b + 1) * n], rr[b * n:(b + 1) * n]
        count = torch.tensor(n if b < blocks - 1 else n - 37,
                             dtype=torch.int32)
        args = (xs, st_k["tail"], rs, st_k["rr_tail"], st_k["q_int"],
                st_k["mu_frac"], count, blk.capacity, blk.taps_table)
        y = torch.full((blk.capacity,), float("nan"), dtype=dtype)
        out = torch.full((4,), -7, dtype=torch.int32)
        nt, nrt = torch.empty(HIST, dtype=dtype), torch.empty(HIST)
        err = lib.vrr_walk(xs.data_ptr(), args[1].data_ptr(),
                           int(xs.is_complex()), rs.data_ptr(),
                           args[3].data_ptr(), n, args[4].data_ptr(),
                           args[5].data_ptr(), count.data_ptr(),
                           blk.capacity, blk.taps_table.data_ptr(),
                           y.data_ptr(), out.data_ptr(), nt.data_ptr(),
                           nrt.data_ptr(), None)
        assert err == 0, err
        ref = vrr_walk_plain(xs, st_p["tail"], rs, st_p["rr_tail"],
                             st_p["q_int"], st_p["mu_frac"], count,
                             blk.capacity, blk.taps_table)
        got = (int(out[0]), int(out[1]), int(out[2]) & 0xFFFFFFFF,
               bool(out[3]))
        want = (int(ref[1]), int(ref[2]), int(ref[3]), bool(ref[4]))
        err_y = float((y - ref[0]).abs().max() / ref[0].abs().max())
        same = (got == want and err_y <= 1e-5 and torch.equal(nt, ref[5])
                and torch.equal(nrt, ref[6]))
        if not same:
            print(f"  block {b}: {got} vs {want}, y {err_y:.2e}")
        ok &= same
        counts.append(got[0])
        st_k = dict(tail=nt, rr_tail=nrt, q_int=out[1].clone(),
                    mu_frac=out[2].to(torch.int64) & 0xFFFFFFFF)
        st_p = dict(tail=ref[5], rr_tail=ref[6], q_int=ref[2],
                    mu_frac=ref[3])
    print(f"vrr {label} {dtype} n {n} x{blocks}: "
          f"{'ok' if ok else 'DIFFERS'}, counts {counts}, overran "
          f"{got[3]}", flush=True)
    return ok


def main(argv) -> int:
    args = list(argv)
    csrc = ROOT / "grbaz_tpu_torch" / "csrc"
    if "--csrc" in args:
        i = args.index("--csrc")
        csrc = pathlib.Path(args[i + 1])
        del args[i:i + 2]
    out = pathlib.Path(args[0]) if args else ROOT / "_archive" / "cpu_shim"
    lib = ctypes.CDLL(str(build(csrc, out, "fastrak_fsm")))
    lib.fastrak_fsm.argtypes = ff._SIGNATURES["fastrak_fsm"]
    vlib = ctypes.CDLL(str(build(csrc, out, "vrr_walk")))
    vlib.vrr_walk.argtypes = vw._SIGNATURES["vrr_walk"]
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rng = np.random.default_rng(3)
    ok = True
    sparse = chip_smoke.fastrak_rows(rng, 3, 2 * 6000, 4)
    dense = chip_smoke.fastrak_rows(rng, 2, 2 * 5000, 2, gap=(0, 3))
    held = (chip_smoke.fastrak_rows(rng, 2, 2 * 3000, 2)[0],
            np.full((2, 6000), 5.0, np.float32))
    for chunk, warm in ((32, 0), (64, 64), (256, 640), (1024, 1280)):
        ok &= case(lib, "sparse os 4", *sparse, 4, chunk, warm)
        ok &= case(lib, "dense os 2", *dense, 2, chunk, warm)
    ok &= case(lib, "sync held high", *held, 2, 64, 64)
    # more than 32 passing frames a call: the summed last row
    many = chip_smoke.fastrak_rows(rng, 1, 2 * 20000, 1, gap=(0, 4))
    ok &= case(lib, "many frames os 1", *many, 1, 128, 200)
    for dtype in (torch.float32, torch.complex64):
        ok &= vrr_case(vlib, "several tiles", dtype, 12000, 3, 1.3)
        ok &= vrr_case(vlib, "ratio below 1", dtype, 3000, 2, 0.7)
    ok &= vrr_case(vlib, "overrun", torch.float32, 3000, 2, 0.4,
                   per_input=1.5)
    # steps longer than a tile: the tile to walk is built out of turn
    ok &= vrr_case(vlib, "steps past a tile", torch.float32, 40000, 2, 5000.0)
    print("ALL OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
