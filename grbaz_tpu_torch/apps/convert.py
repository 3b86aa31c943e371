"""convert — offline sample-format converters.

Equivalent of the reference's C utilities ``raw2num.c`` /
``raw2num_f.c`` / ``raw2num_fc.c`` / ``sign2unsigned.c``
(the reference's lib/, SURVEY.md §2.1 "C utilities"): convert capture
files between wire/sample formats and dump them as numbers.

Formats: u8 (offset-binary IQ bytes), i8, i16 (interleaved shorts),
f32, c64; plus ``text`` (one value per line, the raw2num role) and
``sign2unsigned`` (s8 -> offset u8 in place).

The port's copy of ``grbaz_tpu/apps/convert.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

_READERS = {
    "u8": lambda b: (np.frombuffer(b, np.uint8).astype(np.float32)
                     - 127.5) / 127.5,
    "i8": lambda b: np.frombuffer(b, np.int8).astype(np.float32) / 127.0,
    "i16": lambda b: np.frombuffer(b, np.int16).astype(np.float32) / 32767.0,
    "f32": lambda b: np.frombuffer(b, np.float32).copy(),
    "c64": lambda b: np.frombuffer(b, np.complex64).copy(),
}


def _to_interleaved(x: np.ndarray) -> np.ndarray:
    if np.iscomplexobj(x):
        out = np.empty(2 * len(x), np.float32)
        out[0::2] = x.real
        out[1::2] = x.imag
        return out
    return x.astype(np.float32)


_WRITERS = {
    "u8": lambda x: np.clip(np.round(_to_interleaved(x) * 127.5 + 127.5),
                            0, 255).astype(np.uint8).tobytes(),
    "i8": lambda x: np.clip(np.round(_to_interleaved(x) * 127.0),
                            -128, 127).astype(np.int8).tobytes(),
    "i16": lambda x: np.clip(np.round(_to_interleaved(x) * 32767.0),
                             -32768, 32767).astype(np.int16).tobytes(),
    "f32": lambda x: _to_interleaved(x).tobytes(),
    "c64": lambda x: (x if np.iscomplexobj(x)
                      else (x[0::2] + 1j * x[1::2])).astype(np.complex64)
    .tobytes(),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="sample format converter")
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default="-")
    ap.add_argument("--from", dest="src", required=True,
                    choices=sorted(_READERS))
    ap.add_argument("--to", dest="dst", required=True,
                    choices=sorted(_WRITERS) + ["text", "sign2unsigned"])
    ap.add_argument("--limit", type=int, default=0,
                    help="max items to convert (0 = all)")
    args = ap.parse_args(argv)

    blob = open(args.input, "rb").read()
    if args.dst == "sign2unsigned":
        out = (np.frombuffer(blob, np.int8).astype(np.int16) + 128) \
            .astype(np.uint8).tobytes()
        _write(args.output, out)
        return 0
    x = _READERS[args.src](blob)
    if args.limit:
        x = x[: args.limit]
    if args.dst == "text":
        lines = "\n".join(
            f"{v.real:.6g}\t{v.imag:.6g}" if np.iscomplexobj(x)
            else f"{v:.6g}" for v in x) + "\n"
        _write(args.output, lines.encode())
        return 0
    _write(args.output, _WRITERS[args.dst](x))
    return 0


def _write(path, data: bytes):
    if path == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


if __name__ == "__main__":
    sys.exit(main())
