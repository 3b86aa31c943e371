#!/usr/bin/env python3
"""The mutation check of the channel bank's kernel, on one card.

    python3 tools/bank_variants.py       # from a checkout's root

Copies ``grbaz_tpu_torch/`` (without its build) and ``chip_smoke.py``
into ``_archive/bank_variants/<variant>/`` (git-ignored), edits the copy's
``csrc/channel_bank.cu`` (each edit must match once), then runs the tree
and every copy through ``tools/port_ab_timing.py --bank``: each builds the
kernel, runs ``chip_smoke.bank_case``'s check and times the kernel per
launch. The variants, each of which must fail the check:

* ``no_hi_lo``: the ``hi*lo`` term of the 3xTF32 product dropped;
* ``derotated_head``: the head outputs summed over the tail derotated by
  the slot's LO (right only until a slot is retuned);
* ``1xtf32``: the product on TF32 operands alone (``hi*hi``), which also
  gives the 1xTF32 form's time.

Exits non-zero unless the tree holds and every variant fails.
"""

from __future__ import annotations

import os
import shutil
import sys

import port_ab_timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "grbaz_tpu_torch/csrc/channel_bank.cu"
A_LO = "    wgmma_tf32(dd[0], al, wg_desc(b));\n"
B_LO = "    wgmma_tf32(dd[1], ah, wg_desc(b + 256));\n"
# name -> edits of SOURCE: (text, replacement)
VARIANTS = {
    "no_hi_lo": [(B_LO, "")],
    "derotated_head": [(
        "fr[v] = i < 0 ? tail[base + v]",
        "fr[v] = i < 0 ? cmul(tail[base + v], "
        "lo_at(0u - (p0 + (uint32_t)i * inc)))")],
    "1xtf32": [(A_LO, ""), (B_LO, "")],
}


def variant(name: str) -> str:
    d = os.path.join(ROOT, "_archive", "bank_variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "grbaz_tpu_torch"),
                    os.path.join(d, "grbaz_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
    path = os.path.join(d, SOURCE)
    with open(path) as fh:
        src = fh.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in {SOURCE} once")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src)
    return d


def main() -> int:
    dirs = [ROOT] + [variant(n) for n in VARIANTS]
    ok = True
    for name, (rc, out) in zip(["tree"] + list(VARIANTS),
                               port_ab_timing.run(dirs, "--bank-one")):
        held = rc == 0 and "held True" in out
        right = rc == 0 and held == (name == "tree")
        print(f"{name}: held {held}, {'as it must' if right else 'WRONG'}",
              flush=True)
        ok &= right
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
