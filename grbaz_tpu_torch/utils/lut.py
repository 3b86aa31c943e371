"""Sample-format lookup tables + C-source codegen.

Parity with the reference's LUT generator scripts
(python/gen_char_to_float_lut.py, python/gen_char_to_short.py), which
emit C initializer tables mapping an unsigned sample byte to
float / short via ``(b - 128) / 128`` — the RTL2832 8-bit-offset-IQ
convention (also used by the native converter hot path,
grbaz_tpu_torch/native/rtlsdr_core.cc). Here the tables are produced as
NumPy arrays for host-side conversion and, when asked, as the same C
initializer text for embedding into native sources.

The port's copy of ``grbaz_tpu/utils/lut.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import numpy as np


def char_to_float_lut() -> np.ndarray:
    """[256] float32: b -> (b - 128) / 128."""
    return ((np.arange(256, dtype=np.float32) - 128.0) / 128.0)


def char_to_short_lut(scale: int = 256) -> np.ndarray:
    """[256] int16: b -> (b - 128) * scale (full-scale offset-binary)."""
    v = (np.arange(256, dtype=np.int32) - 128) * int(scale)
    return np.clip(v, -32768, 32767).astype(np.int16)


def lut_c_source(lut: np.ndarray, float_suffix: bool = True) -> str:
    """Render a C array initializer like the reference generators do."""
    if np.issubdtype(lut.dtype, np.floating):
        fmt = "%ff" if float_suffix else "%f"
        body = ", ".join(fmt % x for x in lut)
    else:
        body = ", ".join(str(int(x)) for x in lut)
    return "{ %s };" % body


def convert_u8_iq(raw: np.ndarray) -> np.ndarray:
    """Offset-binary interleaved u8 IQ -> complex64 via the LUT."""
    lut = char_to_float_lut()
    f = lut[np.asarray(raw, np.uint8).reshape(-1)]
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
