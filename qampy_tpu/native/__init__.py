"""Native host-side kernels (C, loaded via ctypes).

Build with ``make native`` (from prbs.c); all users
of these kernels fall back to vectorised numpy implementations when the
shared library is absent.
"""
from __future__ import annotations

import ctypes
import os

_LIB = None


def get_lib():
    """Load the compiled native library, or None if unavailable."""
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(__file__)
    path = os.path.join(here, "libqampy_native.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.prbs_ext.argtypes = [ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
                                 ctypes.c_int32, ctypes.c_int32,
                                 ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.prbs_int.argtypes = [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32,
                                 ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        _LIB = lib
        return lib
    except OSError:
        return None
