"""ctypes bindings for the native (C++/OpenMP) data loader.

The shared library is built lazily with the system g++ on first use and
cached next to the source; every entry point has a numpy fallback in the
callers (gvamp/io/plink.py, gvamp/data.py), so environments without
a toolchain still work — they just load slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cpp")
_LIB = os.path.join(_HERE, "libgvamp_loader.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           _SRC, "-o", _LIB + ".tmp"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(_LIB + ".tmp", _LIB)
        return _LIB
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """The loaded library, building it if necessary; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _LIB if os.path.exists(_LIB) else _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i64, u8p, u32p, cch = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p)
        lib.gvamp_bed_to_words.argtypes = [u8p, i64, i64, i64, u32p, i64, i64]
        lib.gvamp_bed_to_words.restype = ctypes.c_int
        lib.gvamp_read_bed_words.argtypes = [cch, i64, i64, i64, u32p, i64, i64]
        lib.gvamp_read_bed_words.restype = ctypes.c_int
        _lib = lib
        return _lib


def bed_to_words(bed_bytes: np.ndarray, N: int, n_words: int,
                 Mpad: int) -> np.ndarray | None:
    """uint8[M, mbytes] -> uint32[n_words, Mpad] planar word-major, or None
    if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bed = np.ascontiguousarray(bed_bytes, dtype=np.uint8)
    M, mbytes = bed.shape
    out = np.empty((n_words, Mpad), dtype=np.uint32)
    rc = lib.gvamp_bed_to_words(
        bed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), M, mbytes, N,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_words, Mpad)
    return out if rc == 0 else None


def read_bed_words(path: str, N: int, M: int, S: int, n_words: int,
                   Mpad: int) -> np.ndarray | None:
    """.bed slab [S, S+M) -> uint32[n_words, Mpad], or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((n_words, Mpad), dtype=np.uint32)
    rc = lib.gvamp_read_bed_words(
        path.encode(), N, M, S,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_words, Mpad)
    return out if rc == 0 else None
