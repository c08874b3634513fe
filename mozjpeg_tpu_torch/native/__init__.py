"""ctypes bindings for the port's native host library (built at first use).

Binds only what the encode path calls: mj_prep_ycc, mj_gen_optimal_table
and mj_scan_search (see build.py for the sources).
"""
from __future__ import annotations

import ctypes
import os
import threading

from . import build

_p = ctypes.POINTER
u8p = _p(ctypes.c_uint8)
i32p = _p(ctypes.c_int32)
i64p = _p(ctypes.c_int64)


class SearchComp(ctypes.Structure):
    _fields_ = [
        ("coef", ctypes.c_void_p),
        ("bw", ctypes.c_int32), ("bh", ctypes.c_int32),
        ("bw_pad", ctypes.c_int32), ("bh_pad", ctypes.c_int32),
        ("stride", ctypes.c_int32),
        ("h", ctypes.c_int32), ("v", ctypes.c_int32),
    ]


_LIB = None
_LOCK = threading.Lock()


def lib():
    """The loaded library, compiled from the shared sources if stale."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build.build_native()
            _LIB = _bind(ctypes.CDLL(
                os.path.join(build.BUILD_DIR, build.LIB_NAME)))
    return _LIB


def _bind(so):
    so.mj_prep_ycc.restype = ctypes.c_long
    so.mj_prep_ycc.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, u8p, u8p, ctypes.c_int]
    so.mj_gen_optimal_table.restype = ctypes.c_long
    so.mj_gen_optimal_table.argtypes = [i64p, u8p, u8p]
    so.mj_scan_search.restype = ctypes.c_long
    so.mj_scan_search.argtypes = [
        _p(SearchComp), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p, u8p, ctypes.c_long, i32p, ctypes.c_int]
    return so
