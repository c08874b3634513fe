"""Optimal Huffman table generation through the native engine.

Port of mozjpeg_tpu/entropy/encode.py::gen_optimal_table: the Annex-K.2
code-length assignment with libjpeg's tie-breaking, run by the shared
C++ source (mozjpeg_tpu/native/entropy.cpp mj_gen_optimal_table) built
into the port's own library.
"""
from __future__ import annotations

import numpy as np

from .. import native
from .huffman import HuffTable


def gen_optimal_table(freq: np.ndarray) -> HuffTable:
    """freq (257,) symbol counts (256 = pseudo-symbol) -> HuffTable."""
    f = np.ascontiguousarray(freq, dtype=np.int64)
    bits = np.zeros(17, dtype=np.uint8)
    vals = np.zeros(256, dtype=np.uint8)
    n = native.lib().mj_gen_optimal_table(
        f.ctypes.data_as(native.i64p), bits.ctypes.data_as(native.u8p),
        vals.ctypes.data_as(native.u8p))
    if n < 0:
        raise ValueError("Huffman code length overflow")
    return HuffTable(bits, vals[:n])
