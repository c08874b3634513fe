"""Arithmetic-coded scans: the encode half.

Port of the encode half of mozjpeg_tpu/codec/arith.py: Python glue over
the native QM coder (mozjpeg_tpu/native/arith.cpp, built into the port's
library). The conditioning is mozjpeg's default, L = 0 and U = 1 for DC
and Kx = 5 for AC (jcparam.c:414-419), written in every scan's DAC
marker. Decoding arithmetic streams is ROADMAP.md queue 1 item 6.9.
"""
from __future__ import annotations

import numpy as np

from .. import native

DC_L = np.zeros(4, np.uint8)
DC_U = np.ones(4, np.uint8)
AC_K = np.full(4, 5, np.uint8)


def _u8(a):
    return a.ctypes.data_as(native.u8p)


def _planes_arr(entries, planes, comps, dc_tbls, ac_tbls, interleaved):
    """The scan's components as native CompPlane structs (MCU geometry
    for an interleaved scan, the component's own blocks otherwise), and
    the contiguous planes they point into."""
    arr = (native.CompPlane * len(entries))()
    keep = []
    for i, ci in enumerate(entries):
        p = np.ascontiguousarray(planes[ci], dtype=np.int16)
        keep.append(p)
        g = comps[ci]
        arr[i].coef = p.ctypes.data
        if interleaved:
            arr[i].bw, arr[i].bh = p.shape[1], p.shape[0]
            arr[i].h, arr[i].v = g.h, g.v
        else:
            arr[i].bw, arr[i].bh = g.bw, g.bh
            arr[i].h, arr[i].v = 1, 1
        arr[i].stride = p.shape[1]
        arr[i].dc_tbl = dc_tbls.get(ci, 0)
        arr[i].ac_tbl = ac_tbls.get(ci, 0)
    return arr, keep


def dac_entries(scan, dc_tbls, ac_tbls):
    """The scan's DAC entries [(cls, idx, value)], each table once
    (jcmarker.c:404-446 emit_dac writes them before every scan)."""
    entries = []
    for ci in scan.comps:
        if scan.Ss == 0 and scan.Ah == 0:
            t = dc_tbls[ci]
            e = (0, t, (int(DC_U[t]) << 4) | int(DC_L[t]))
            if e not in entries:
                entries.append(e)
        if scan.Se:
            t = ac_tbls[ci]
            e = (1, t, int(AC_K[t]))
            if e not in entries:
                entries.append(e)
    return entries


def encode_scan_arith(scan, geom, planes, dc_tbls, ac_tbls,
                      restart: int) -> bytes:
    """One scan's arithmetic-coded entropy data; planes per component
    (bh_pad, bw_pad, 64) int16 zigzag blocks."""
    mcus_x, mcus_y, comps = geom
    lib = native.lib()
    interleaved = len(scan.comps) > 1
    arr, keep = _planes_arr(scan.comps, planes, comps, dc_tbls, ac_tbls,
                            interleaved)
    if interleaved:
        smx, smy = mcus_x, mcus_y
    else:
        g = comps[scan.comps[0]]
        smx, smy = g.bw, g.bh
    nblocks = sum(smx * smy * arr[i].h * arr[i].v
                  for i in range(len(scan.comps)))
    out = np.empty(max(nblocks * 192 + 65536, 1 << 16), np.uint8)
    if scan.Ss == 0 and scan.Se == 63:
        n = lib.mj_arith_encode_seq(arr, len(scan.comps), smx, smy, restart,
                                    _u8(DC_L), _u8(DC_U), _u8(AC_K),
                                    _u8(out), out.size)
    elif scan.Ss == 0 and scan.Ah == 0:
        n = lib.mj_arith_encode_dc_first(arr, len(scan.comps), smx, smy,
                                         restart, scan.Al, _u8(DC_L),
                                         _u8(DC_U), _u8(out), out.size)
    elif scan.Ss == 0:
        n = lib.mj_arith_encode_dc_refine(arr, len(scan.comps), smx, smy,
                                          restart, scan.Al, _u8(out),
                                          out.size)
    elif scan.Ah == 0:
        n = lib.mj_arith_encode_ac_first(arr, scan.Ss, scan.Se, scan.Al,
                                         restart, _u8(AC_K), _u8(out),
                                         out.size)
    else:
        n = lib.mj_arith_encode_ac_refine(arr, scan.Ss, scan.Se, scan.Al,
                                          restart, _u8(out), out.size)
    del keep
    if n < 0:
        raise RuntimeError("arithmetic encode: output buffer overflow")
    return bytes(out[:n])
