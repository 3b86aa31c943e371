"""Native (C++) host-runtime components, loaded with ctypes (port of
``grbaz_tpu/native/__init__.py``): the BorIP UDP engine, the TCP frame
engine and the RTL2832 driver with its tuner programs.

The compute path is PyTorch and the CUDA kernels of ``csrc/``; the host
runtime around it (the network sample plane) is C++, mirroring the
reference's split (lib/*.cc for sockets and drivers). A library is built
on first use with the system ``g++`` into the package's git-ignored
``_build/`` directory, beside the CUDA kernels, and named after the hash
of its source and flags: an edited source is rebuilt, an unchanged one
reused. The compiler writes a temporary name that is then renamed into
place, so two processes that build at once never load a half-written
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")

_LOCK = threading.Lock()
_LIBS = {}


def _sources(sources) -> tuple:
    return (sources,) if isinstance(sources, str) else tuple(sources)


def library_path(name: str, sources) -> Path:
    """The library's path under ``_build/``: named after the hash of every
    file on ``sources`` (the headers and included programs too) and the
    flags."""
    h = hashlib.sha1()
    for src in _sources(sources):
        h.update(src.encode() + b"\0" + (SRC_DIR / src).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _build(name: str, sources) -> Path:
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    # .h/.inc entries are hashed dependencies, not compile units
    units = [str(SRC_DIR / s) for s in _sources(sources)
             if not s.endswith((".h", ".inc"))]
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), *units],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load a native library; cached per process.
    ``sources`` is a file name or a list of them, each hashed."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_build(name, sources)))
        return _LIBS[name]


def load_boripnet() -> ctypes.CDLL:
    lib = load("boripnet", "boripnet.cc")
    c = ctypes
    lib.borip_rx_create.restype = c.c_void_p
    lib.borip_rx_create.argtypes = [c.c_uint16, c.c_uint32, c.c_uint32,
                                    c.c_int, c.c_uint32]
    lib.borip_rx_port.restype = c.c_uint16
    lib.borip_rx_port.argtypes = [c.c_void_p]
    lib.borip_rx_read.restype = c.c_int64
    lib.borip_rx_read.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                  c.POINTER(c.c_uint8)]
    lib.borip_rx_stats.argtypes = [c.c_void_p, c.POINTER(c.c_uint64),
                                   c.POINTER(c.c_uint64),
                                   c.POINTER(c.c_uint64)]
    lib.borip_rx_destroy.argtypes = [c.c_void_p]
    lib.borip_tx_create.restype = c.c_void_p
    lib.borip_tx_create.argtypes = [c.c_char_p, c.c_uint16, c.c_uint32,
                                    c.c_int]
    lib.borip_tx_connect.restype = c.c_int
    lib.borip_tx_connect.argtypes = [c.c_void_p, c.c_char_p, c.c_uint16]
    lib.borip_tx_send.restype = c.c_int64
    lib.borip_tx_send.argtypes = [c.c_void_p, c.c_char_p, c.c_int64,
                                  c.c_uint8]
    lib.borip_tx_end.restype = c.c_int
    lib.borip_tx_end.argtypes = [c.c_void_p]
    lib.borip_tx_destroy.argtypes = [c.c_void_p]
    lib.borip_rx_ata_info.argtypes = [c.c_void_p, c.POINTER(c.c_double),
                                      c.POINTER(c.c_double),
                                      c.POINTER(c.c_uint64),
                                      c.POINTER(c.c_uint32)]
    lib.borip_tx_ata_meta.argtypes = [c.c_void_p, c.c_double, c.c_double,
                                      c.c_uint32, c.c_uint32, c.c_uint32,
                                      c.c_uint32]
    return lib


RTLSDR_SOURCES = ("rtlsdr_core.cc", "tuner_programs.inc", "tuner_tables.h")


def load_rtlsdr_core() -> ctypes.CDLL:
    lib = load("rtlsdr_core", RTLSDR_SOURCES)
    c = ctypes
    lib.rtl_open_sim.restype = c.c_void_p
    lib.rtl_open_sim.argtypes = [c.c_double, c.c_double, c.c_double,
                                 c.c_uint64, c.c_int]
    lib.rtl_open_file.restype = c.c_void_p
    lib.rtl_open_file.argtypes = [c.c_char_p, c.c_int]
    lib.rtl_open_usb.restype = c.c_void_p
    lib.rtl_open_usb.argtypes = [c.c_uint16, c.c_uint16, c.c_int]
    lib.rtl_usb_available.restype = c.c_int
    lib.rtl_usb_last_error.restype = c.c_char_p
    lib.rtl_tuner_name.restype = c.c_char_p
    lib.rtl_tuner_name.argtypes = [c.c_void_p]
    for fn, res, args in [
            ("rtl_set_sample_rate", c.c_int, [c.c_void_p, c.c_double]),
            ("rtl_get_sample_rate", c.c_double, [c.c_void_p]),
            ("rtl_set_frequency", c.c_int, [c.c_void_p, c.c_double]),
            ("rtl_get_frequency", c.c_double, [c.c_void_p]),
            ("rtl_set_gain", c.c_int, [c.c_void_p, c.c_double]),
            ("rtl_get_gain", c.c_double, [c.c_void_p]),
            ("rtl_set_gain_mode", c.c_int, [c.c_void_p, c.c_int]),
            ("rtl_start", c.c_int, [c.c_void_p, c.c_uint32]),
            ("rtl_read", c.c_int,
             [c.c_void_p, c.POINTER(c.c_uint8), c.c_int, c.c_int])]:
        f = getattr(lib, fn)
        f.restype = res
        f.argtypes = args
    lib.rtl_set_ppm.argtypes = [c.c_void_p, c.c_double]
    lib.rtl_stop.argtypes = [c.c_void_p]
    lib.rtl_close.argtypes = [c.c_void_p]
    lib.rtl_gain_range.argtypes = [c.c_void_p, c.POINTER(c.c_double),
                                   c.POINTER(c.c_double),
                                   c.POINTER(c.c_double)]
    lib.rtl_stats.argtypes = [c.c_void_p, c.POINTER(c.c_uint64),
                              c.POINTER(c.c_uint64), c.POINTER(c.c_uint64),
                              c.POINTER(c.c_double)]
    lib.rtl_i2c_log_count.restype = c.c_int
    lib.rtl_i2c_log_count.argtypes = [c.c_void_p]
    lib.rtl_i2c_log_get.restype = c.c_int
    lib.rtl_i2c_log_get.argtypes = [c.c_void_p, c.c_int,
                                    c.POINTER(c.c_uint8),
                                    c.POINTER(c.c_uint8)]
    lib.rtl_i2c_log_clear.argtypes = [c.c_void_p]
    lib.rtl_actual_lo.restype = c.c_double
    lib.rtl_actual_lo.argtypes = [c.c_void_p]
    # demod register-fidelity surface: device table, product identity,
    # GPIO, and the control-transfer wire log
    lib.rtl_open_sim_dev.restype = c.c_void_p
    lib.rtl_open_sim_dev.argtypes = [c.c_uint16, c.c_uint16, c.c_double,
                                     c.c_double, c.c_double, c.c_uint64,
                                     c.c_int]
    lib.rtl_product_name.restype = c.c_char_p
    lib.rtl_product_name.argtypes = [c.c_void_p]
    lib.rtl_device_table_count.restype = c.c_int
    lib.rtl_device_table_get.restype = c.c_int
    lib.rtl_device_table_get.argtypes = [c.c_int, c.POINTER(c.c_char_p),
                                         c.POINTER(c.c_uint16),
                                         c.POINTER(c.c_uint16),
                                         c.POINTER(c.c_char_p)]
    lib.rtl_set_gpio_output.restype = c.c_int
    lib.rtl_set_gpio_output.argtypes = [c.c_void_p, c.c_uint8]
    lib.rtl_set_gpio_bit.restype = c.c_int
    lib.rtl_set_gpio_bit.argtypes = [c.c_void_p, c.c_uint8, c.c_int]
    lib.rtl_wire_log_count.restype = c.c_int
    lib.rtl_wire_log_count.argtypes = [c.c_void_p]
    lib.rtl_wire_log_get.restype = c.c_int
    lib.rtl_wire_log_get.argtypes = [c.c_void_p, c.c_int,
                                     c.POINTER(c.c_uint8),
                                     c.POINTER(c.c_uint16),
                                     c.POINTER(c.c_uint16),
                                     c.POINTER(c.c_uint8),
                                     c.POINTER(c.c_uint8),
                                     c.POINTER(c.c_uint8)]
    lib.rtl_wire_log_clear.argtypes = [c.c_void_p]
    return lib


def load_tcpframe() -> ctypes.CDLL:
    lib = load("tcpframe", "tcpframe.cc")
    c = ctypes
    lib.tcpf_src_create.restype = c.c_void_p
    lib.tcpf_src_create.argtypes = [c.c_uint16, c.c_uint64]
    lib.tcpf_src_port.restype = c.c_uint16
    lib.tcpf_src_port.argtypes = [c.c_void_p]
    lib.tcpf_src_read.restype = c.c_int64
    lib.tcpf_src_read.argtypes = [c.c_void_p, c.POINTER(c.c_uint8),
                                  c.c_int64, c.POINTER(c.c_uint64)]
    lib.tcpf_src_next_tag.restype = c.c_int64
    lib.tcpf_src_next_tag.argtypes = [c.c_void_p, c.POINTER(c.c_uint8),
                                      c.c_int64, c.c_uint64,
                                      c.POINTER(c.c_uint64)]
    lib.tcpf_src_stats.argtypes = [c.c_void_p, c.POINTER(c.c_uint64),
                                   c.POINTER(c.c_uint64),
                                   c.POINTER(c.c_uint64),
                                   c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.tcpf_src_destroy.argtypes = [c.c_void_p]
    lib.tcpf_sink_create.restype = c.c_void_p
    lib.tcpf_sink_create.argtypes = [c.c_char_p, c.c_uint16, c.c_int]
    lib.tcpf_sink_send.restype = c.c_int
    lib.tcpf_sink_send.argtypes = [c.c_void_p, c.c_uint8, c.c_uint8,
                                   c.POINTER(c.c_uint8), c.c_uint64]
    lib.tcpf_sink_connected.restype = c.c_int
    lib.tcpf_sink_connected.argtypes = [c.c_void_p]
    lib.tcpf_sink_stats.argtypes = [c.c_void_p, c.POINTER(c.c_uint64),
                                    c.POINTER(c.c_uint64),
                                    c.POINTER(c.c_uint64)]
    lib.tcpf_sink_destroy.argtypes = [c.c_void_p]
    return lib
