"""Native (C++) host-side kernels, loaded via ctypes.

The port's own copy of ``fhetpu/native`` (``fastntt.cpp`` and this loader):
the client's batched NTT, encrypt and CRT-decode loops.  Compiled at first
use into ``fhetpu_torch/build/libfastntt.so`` with the system compiler,
through a temporary file renamed into place, so concurrent processes never
load a half-written library.  Without a compiler every caller takes its
NumPy path (``lib() is None``), and the first call says so on stderr.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastntt.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_SO = os.path.join(_BUILD_DIR, "libfastntt.so")


def _compile() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return True
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for cxx in ("g++", "c++", "clang++"):
        try:
            r = subprocess.run(
                [cxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                 _SRC, "-o", tmp, "-pthread"],
                capture_output=True, timeout=120,
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, _SO)
            return True
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def lib():
    """The loaded ctypes library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            if not _compile():
                print("fhetpu_torch.native: no C++ compiler built fastntt.cpp; "
                      "using NumPy fallback", file=sys.stderr)
                return None
            L = ctypes.CDLL(_SO)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            L.fastntt_forward.argtypes = [
                u32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                u32p, u32p, u32p, ctypes.c_int,
            ]
            L.fastntt_inverse.argtypes = [
                u32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                u32p, u32p, u32p, u32p, u32p, ctypes.c_int,
            ]
            L.fastntt_pointwise_mulmod.argtypes = [
                u32p, u32p, u32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, u32p, ctypes.c_int,
            ]
            i32p = ctypes.POINTER(ctypes.c_int32)
            i8p = ctypes.POINTER(ctypes.c_int8)
            L.fastntt_encrypt_finish.argtypes = [
                u32p, i32p, i32p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, u32p, u32p, ctypes.c_int,
            ]
            L.fastntt_lift_forward_i8.argtypes = [
                i8p, u32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                u32p, u32p, u32p, ctypes.c_int,
            ]
            L.fastntt_scalar_muladd.argtypes = [
                u32p, u32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                u32p, u32p, u32p, ctypes.c_int,
            ]
            f64p = ctypes.POINTER(ctypes.c_double)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            L.fastntt_crt_decode.argtypes = [
                u32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint64, f64p, i64p, u8p, ctypes.c_int,
            ]
            _LIB = L
        except OSError as e:
            print(f"fhetpu_torch.native: load failed ({e}); using NumPy fallback",
                  file=sys.stderr)
            _LIB = None
        return _LIB


def default_threads() -> int:
    return min(os.cpu_count() or 1, 16)
