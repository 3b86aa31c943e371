"""Native (C++) host-runtime components, loaded with ctypes (port of
``grbaz_tpu/native/__init__.py``; only the BorIP engine so far).

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


def library_path(name: str, source: str) -> Path:
    h = hashlib.sha1((SRC_DIR / source).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _build(name: str, source: str) -> Path:
    out = library_path(name, source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                          str(SRC_DIR / source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {source}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, source: str) -> ctypes.CDLL:
    """Build (if needed) and load a native library; cached per process."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_build(name, source)))
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
