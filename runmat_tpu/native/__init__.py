"""Native components: ctypes bindings + lazy build.

Reference parity: the reference's performance-critical native components
(runmat-turbine JIT, hot kernels). The shared library builds from
native/*.cpp on first use (g++, cached under the checkout's .cache/native)
and every caller degrades gracefully to the Python path
when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_LIB = None
_TRIED = False


def _src_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


def turbine() -> object:
    """The libturbine handle, building it if necessary; None if unavailable.

    The build cache is keyed by a hash of the source (never by mtime), so a
    stale or tampered artifact can't be picked up silently, and no compiled
    binary lives in the repo."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_src_dir(), "turbine.cpp")
    if not os.path.exists(src):
        return None
    import hashlib
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    from .. import cache_path
    cache_dir = os.environ.get("RUNMAT_TPU_NATIVE_CACHE",
                               cache_path("native"))
    lib_path = os.path.join(cache_dir, f"libturbine-{digest}.so")
    if not os.path.exists(lib_path):
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = lib_path + f".tmp{os.getpid()}"
            subprocess.run(["g++", "-O2", "-shared", "-fPIC",
                            "-std=c++17", "-o", tmp, src],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(lib_path)
        lib.turbine_run.restype = ctypes.c_int32
        lib.turbine_run.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ]
        _LIB = lib
    except OSError:
        return None
    return _LIB
