"""JPEG marker segment writer (the part the encode path uses).

Port of mozjpeg_tpu/codec/marker.py MarkerWriter: SOI, JFIF APP0, one
multi-table DQT (mozjpeg's non-FASTEST profile, jcmarker.c:190-246), SOF
and EOI, with field layouts as mozjpeg jcmarker.c writes them.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from ..consts import JPEG_ZIGZAG

SOI, EOI, DQT = 0xD8, 0xD9, 0xDB
SOF2 = 0xC2
APP0 = 0xE0


class MarkerWriter:
    def __init__(self):
        self.buf = bytearray()

    def bytes(self) -> bytes:
        return bytes(self.buf)

    def raw(self, data: bytes):
        self.buf += data

    def marker(self, code: int):
        self.buf += bytes([0xFF, code])

    def segment(self, code: int, payload: bytes):
        self.marker(code)
        self.buf += struct.pack(">H", len(payload) + 2)
        self.buf += payload

    def soi(self):
        self.marker(SOI)

    def eoi(self):
        self.marker(EOI)

    def jfif_app0(self, major=1, minor=1, unit=0, xd=1, yd=1):
        self.segment(APP0, b"JFIF\x00" + bytes([major, minor, unit])
                     + struct.pack(">HH", xd, yd) + b"\x00\x00")

    def dqt_multi(self, tables: List[Tuple[int, np.ndarray]]):
        """All tables (natural order in, zigzag out) in one DQT marker."""
        payload = b""
        for index, qtbl_natural in tables:
            q = np.asarray(qtbl_natural).reshape(64)[JPEG_ZIGZAG]
            prec = 1 if int(q.max()) > 255 else 0
            payload += bytes([(prec << 4) | index])
            if prec:
                payload += b"".join(struct.pack(">H", int(v)) for v in q)
            else:
                payload += bytes(int(v) for v in q)
        self.segment(DQT, payload)

    def sof(self, code: int, precision: int, height: int, width: int,
            comps: List[Tuple[int, int, int, int]]):
        """comps: (component_id, h, v, quant_tbl_no)."""
        payload = struct.pack(">BHHB", precision, height, width, len(comps))
        for cid, h, v, q in comps:
            payload += bytes([cid, (h << 4) | v, q])
        self.segment(code, payload)
