#!/usr/bin/env python3
"""Ablations of the FasTrak kernel's two passes, on one card.

    python3 tools/fastrak_variants.py       # from a checkout's root

Builds edited copies of ``grbaz_tpu_torch/csrc/fastrak_fsm.cu`` with nvcc
into ``_archive/fastrak_variants/`` (git-ignored; each edit must match
once), launches each through the wrapper's own ``_launch`` on four
scenes (block 0 of ``chip_smoke.fastrak_scene`` through the path's graph,
the decoder bank's [64, 2^14], frames back to back and the sync held
high at [1, 2^20]) and prints whether it equals the plain version and
the device time of each pass (torch.profiler, 20 calls). The variants:

* ``threads1 256`` / ``threads1 1024``: pass 1's block size;
* ``unroll 4`` / ``unroll 16``: the 128-sample groups a warp has in
  flight while pass 1 stages its tile;
* ``no frame work``: pass 1 writes each hit's record without working out
  its frame (wrong results; the staging's own time);
* ``clock64``: the tree with the chain kernel's cycles counted (the
  chase, thread 32's loads of the next window, thread 0 at the barrier,
  from the first window to the end) and printed for row 0.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as c  # noqa: E402
from grbaz_tpu_torch.ops.cuda import build  # noqa: E402
from grbaz_tpu_torch.ops.cuda import fastrak_fsm as ff  # noqa: E402

SOURCE = ROOT / "grbaz_tpu_torch/csrc/fastrak_fsm.cu"
OUT = ROOT / "_archive/fastrak_variants"
CHASE = """    if (tid == 0)
      chase(c, window_at(buf, b), base, span, total, g.os, ev);
    else if (tid >= 32 && nspan > 0)
      load_window<kPerLoader>(sc, tp, g, row, total, window_at(buf, b ^ 1),
                              nbase, nspan, tid - 32, kThreads2 - 32);
    __syncthreads();"""
COUNTED = """    if (tid == 0) {
      const long long ta = clock64();
      chase(c, window_at(buf, b), base, span, total, g.os, ev);
      t_chase += clock64() - ta;
    } else if (tid >= 32 && nspan > 0) {
      const long long ta = clock64();
      load_window<kPerLoader>(sc, tp, g, row, total, window_at(buf, b ^ 1),
                              nbase, nspan, tid - 32, kThreads2 - 32);
      t_load += clock64() - ta;
    }
    const long long tb = clock64();
    __syncthreads();
    t_bar += clock64() - tb;"""
# name -> edits of SOURCE: (text, replacement)
VARIANTS = {
    "tree": [],
    "threads1 256": [("constexpr int kThreads1 = 512;",
                      "constexpr int kThreads1 = 256;")],
    "threads1 1024": [("constexpr int kThreads1 = 512;",
                       "constexpr int kThreads1 = 1024;")],
    "unroll 4": [("constexpr int kUnroll = 8; ",
                  "constexpr int kUnroll = 4; ")],
    "unroll 16": [("constexpr int kUnroll = 8; ",
                   "constexpr int kUnroll = 16; ")],
    "no frame work": [("    const uint2 r = frame_at(sg, p, offs[j]);",
                       "    const uint2 r = make_uint2(0u, offs[j] << 18);")],
    "clock64": [
        ("#include <stdint.h>", "#include <stdint.h>\n#include <cstdio>"),
        ("  int base = c.cur, b = 0;",
         "  long long t_chase = 0, t_load = 0, t_bar = 0, t0 = clock64();\n"
         "  int base = c.cur, b = 0;"),
        (CHASE, COUNTED),
        ("  if (tid == 0) {\n    const Fs& s = c.s;",
         "  if (row == 0 && (tid == 0 || tid == 32))\n"
         "    printf(\"clock64 thread %d: chase %lld, next window's load "
         "%lld, at the barrier %lld, to the end %lld cycles; %d frames\\n\","
         " tid, t_chase, t_load, t_bar, clock64() - t0, c.frames);\n"
         "  if (tid == 0) {\n    const Fs& s = c.s;")],
}


def build_all() -> dict:
    """Each variant's library, built by nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = SOURCE.read_text()
        for a, b in edits:
            if src.count(a) != 1:
                raise SystemExit(f"{name}: an edit matches {src.count(a)} "
                                 "times")
            src = src.replace(a, b)
        tag = re.sub(r"\W+", "_", name)
        # beside the source, so that its headers are found
        cu = SOURCE.with_name(f"_variant_{tag}.cu")
        cu.write_text(src)
        so = OUT / f"lib{tag}.so"
        proc = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, so, cu)
    libs = {}
    for name, (p, so, cu) in procs.items():
        log = p.communicate()[0]
        os.remove(cu)
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.fastrak_fsm.argtypes = ff._SIGNATURES["fastrak_fsm"]
        lib.fastrak_fsm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def scenes(dev):
    iq, _ = c.fastrak_scene(dev)
    outs, _, _ = c.run_inputs(c.fastrak_graph(dev), [dict(iq=iq[:c.BLOCK])],
                              c.FT_FS)
    yield ("path block 0 [1, 2^20]", outs[0]["metric"][0][None],
           outs[0]["sync"][0][None], c.FT_SYNC_THR)
    for seed, rows, n, gap, label, held in (
            (8, 64, 1 << 14, (1, 200), "decoder bank [64, 2^14]", False),
            (10, 1, c.BLOCK, (1, 200), "back to back [1, 2^20]", False),
            (9, 1, c.BLOCK, (1, 200), "sync held high [1, 2^20]", True)):
        m, y = c.fastrak_rows(np.random.default_rng(seed), rows, n, c.FT_OS,
                              gap)
        if held:
            y[:] = 5.0
        yield (label, torch.from_numpy(m).to(dev), torch.from_numpy(y).to(dev),
               1.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("fastrak_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    c.report()
    libs = build_all()
    stream = torch.cuda.current_stream().cuda_stream
    for label, m, y, thr in scenes(dev):
        rows = m.shape[0]
        st = {k: v.reshape(1).expand(rows).contiguous()
              for k, v in c.FastrakDecoder(device=dev).init_state().items()}
        t = torch.full((1,), thr, device=dev)
        ref = ff.fastrak_fsm_plain(m, y, st, t, c.FT_OS)
        for name, lib in libs.items():
            def run():
                return ff._launch(lib, m, y, st, t, c.FT_OS, ff.TILE, stream)
            got = run()
            torch.cuda.synchronize()
            same = (c.same_bits(got[0], ref[0])
                    and torch.equal(got[1].cpu(), ref[1].cpu())
                    and all(torch.equal(got[2][k].cpu(), ref[2][k].cpu())
                            for k in ref[2]))
            if name == "clock64":
                print(f"{label} clock64: same {same}", flush=True)
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    run()
                torch.cuda.synchronize()
            us = {p: sum(e.self_device_time_total for e in prof.key_averages()
                         if p in e.key) / 20
                  for p in ("candidates_kernel", "chain_kernel")}
            print(f"{label} {name}: same {same}; device us a call: pass 1 "
                  f"{us['candidates_kernel']:.2f}, pass 2 "
                  f"{us['chain_kernel']:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
