"""Scan-level entropy encoding and optimal Huffman tables, through the
native engine.

Port of mozjpeg_tpu/entropy/encode.py (ScanGeometry, encode_scan,
gen_optimal_table): Python picks the scan's geometry and tables, and the
port's C++ sources (native/entropy.cpp mj_encode_seq,
mj_encode_{dc,ac}_{first,refine} and mj_gen_optimal_table, the Annex-K.2
code-length assignment with libjpeg's tie-breaking) built into the
port's own library gather the symbol counts or emit the scan.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from .huffman import HuffTable, derive_codes


class ScanGeometry:
    """One scan's geometry: an interleaved (multi-component) scan walks
    the MCU-padded planes, a single-component scan the component's real
    block grid."""

    def __init__(self, scan, geom, planes: List[np.ndarray]):
        mcus_x, mcus_y, comps = geom
        self.scan = scan
        self.planes = planes
        if len(scan.comps) == 1:
            ci = scan.comps[0]
            self.mcus_x, self.mcus_y = comps[ci].bw, comps[ci].bh
            self.entries = [(ci, 1, 1)]
        else:
            self.mcus_x, self.mcus_y = mcus_x, mcus_y
            self.entries = [(ci, comps[ci].h, comps[ci].v)
                            for ci in scan.comps]
        self.comps = comps

    def comp_planes(self, dc_tbls: Dict[int, int], ac_tbls: Dict[int, int]):
        arr = (native.CompPlane * len(self.entries))()
        keepalive = []
        single = len(self.entries) == 1
        for i, (ci, h, v) in enumerate(self.entries):
            p = np.ascontiguousarray(self.planes[ci], dtype=np.int16)
            keepalive.append(p)
            g = self.comps[ci]
            arr[i].coef = p.ctypes.data
            arr[i].bw = g.bw if single else g.bw_pad
            arr[i].bh = g.bh if single else g.bh_pad
            arr[i].stride = p.shape[1]
            arr[i].h = h
            arr[i].v = v
            arr[i].dc_tbl = dc_tbls.get(ci, 0)
            arr[i].ac_tbl = ac_tbls.get(ci, 0)
        return arr, keepalive


def _flatten_tables(tables: Dict[int, HuffTable]):
    """Up to 4 tables -> flat ehufco[4*256] u32 and ehufsi[4*256] u8."""
    co = np.zeros(4 * 256, dtype=np.uint32)
    si = np.zeros(4 * 256, dtype=np.uint8)
    for idx, tbl in tables.items():
        c, s = derive_codes(tbl)
        co[idx * 256:(idx + 1) * 256] = c
        si[idx * 256:(idx + 1) * 256] = s
    return co, si


def encode_scan(sg: ScanGeometry, dc_tbls: Dict[int, int],
                ac_tbls: Dict[int, int], dc_tables: Dict[int, HuffTable],
                ac_tables: Dict[int, HuffTable], restart_interval: int = 0,
                gather: bool = False
                ) -> Tuple[Optional[bytes], np.ndarray, np.ndarray]:
    """Emit one scan, or with `gather` count its symbols -> (data or None,
    dc_counts (4, 257) int64, ac_counts (4, 257) int64)."""
    scan = sg.scan
    so = native.lib()
    arr, keep = sg.comp_planes(dc_tbls, ac_tbls)
    dc_co, dc_si = _flatten_tables({} if gather else dc_tables)
    ac_co, ac_si = _flatten_tables({} if gather else ac_tables)
    dc_counts = np.zeros((4, 257), dtype=np.int64)
    ac_counts = np.zeros((4, 257), dtype=np.int64)
    if gather:
        out = np.empty(1, dtype=np.uint8)
    else:
        # worst case ~16 bits per coefficient plus stuffing
        nblocks = sum(sg.mcus_x * sg.mcus_y * h * v for _, h, v in sg.entries)
        out = np.empty(max(nblocks * 192 + 4096, 1 << 16), dtype=np.uint8)
    g = 1 if gather else 0

    def p(a, typ):
        return a.ctypes.data_as(typ)

    if scan.Ss == 0 and scan.Se == 63:
        n = so.mj_encode_seq(
            arr, len(sg.entries), sg.mcus_x, sg.mcus_y, restart_interval,
            p(dc_co, native.u32p), p(dc_si, native.u8p),
            p(ac_co, native.u32p), p(ac_si, native.u8p),
            p(out, native.u8p), out.size, p(dc_counts, native.i64p),
            p(ac_counts, native.i64p), g)
    elif scan.Ss == 0 and scan.Ah == 0:                  # DC first
        n = so.mj_encode_dc_first(
            arr, len(sg.entries), sg.mcus_x, sg.mcus_y, restart_interval,
            scan.Al, p(dc_co, native.u32p), p(dc_si, native.u8p),
            p(out, native.u8p), out.size, p(dc_counts, native.i64p), g)
    elif scan.Ss == 0:                                   # DC refine
        if gather:
            return None, dc_counts, ac_counts           # no symbols
        n = so.mj_encode_dc_refine(
            arr, len(sg.entries), sg.mcus_x, sg.mcus_y, restart_interval,
            scan.Al, p(out, native.u8p), out.size)
    else:                                                # AC, one comp
        fn = (so.mj_encode_ac_first if scan.Ah == 0
              else so.mj_encode_ac_refine)
        n = fn(arr, scan.Ss, scan.Se, scan.Al, restart_interval,
               p(ac_co, native.u32p), p(ac_si, native.u8p),
               p(out, native.u8p), out.size, p(ac_counts, native.i64p), g,
               None)
    del keep
    if n < 0:
        raise RuntimeError("entropy output buffer overflow")
    if gather:
        return None, dc_counts, ac_counts
    return bytes(out[:n]), dc_counts, ac_counts


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
