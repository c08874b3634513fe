"""Huffman table containers and canonical code assignment (host side).

Port of mozjpeg_tpu/entropy/huffman.py (HuffTable, derive_codes,
derive_decode_table): the canonical code assignment of
jpeg_make_c_derived_tbl (mozjpeg jchuff.c:231-318) and the decoder's
mincode/maxcode/valptr tables.
"""
from __future__ import annotations

import numpy as np


class HuffTable:
    """bits[17] (index 1..16 used) + vals[] symbol list, like JHUFF_TBL."""

    __slots__ = ("bits", "vals")

    def __init__(self, bits, vals):
        self.bits = np.asarray(bits, dtype=np.uint8)
        self.vals = np.asarray(vals, dtype=np.uint8)

    def __eq__(self, other):
        return (isinstance(other, HuffTable)
                and np.array_equal(self.bits, other.bits)
                and np.array_equal(self.vals, other.vals))


def derive_codes(tbl: HuffTable):
    """-> (ehufco uint32[256], ehufsi uint8[256]); canonical JPEG codes."""
    ehufco = np.zeros(256, dtype=np.uint32)
    ehufsi = np.zeros(256, dtype=np.uint8)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(int(tbl.bits[length])):
            sym = int(tbl.vals[k])
            if ehufsi[sym]:
                raise ValueError("duplicate Huffman symbol %d" % sym)
            ehufco[sym] = code
            ehufsi[sym] = length
            code += 1
            k += 1
        code <<= 1
    return ehufco, ehufsi


def derive_decode_table(tbl: HuffTable):
    """-> (mincode int32[17], maxcode int64[18], valptr int32[17], vals)
    for the native decoders (JPEG spec F.2.2.3); maxcode[l] is the
    largest code of length l, -1 if none, and maxcode[17] a sentinel."""
    mincode = np.zeros(17, dtype=np.int32)
    maxcode = np.full(18, -1, dtype=np.int64)
    valptr = np.zeros(17, dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        nb = int(tbl.bits[length])
        valptr[length] = k
        mincode[length] = code
        if nb:
            code += nb
            k += nb
            maxcode[length] = code - 1
        code <<= 1
    maxcode[17] = 0xFFFFF
    return mincode, maxcode, valptr, tbl.vals
