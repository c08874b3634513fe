"""Arithmetic-coded scans, encode and decode.

Port of mozjpeg_tpu/codec/arith.py: Python glue over the native QM coder
(native/arith.cpp, built into the port's library). The
encoder's conditioning is mozjpeg's default, L = 0 and U = 1 for DC and
Kx = 5 for AC (jcparam.c:414-419), written in every scan's DAC marker;
the decoder takes each scan's conditioning from the DAC segments seen
before it (the same defaults where none was sent, jdarith.c).
"""
from __future__ import annotations

from typing import List

import numpy as np

from .. import native
from . import marker
from .pipeline import geometry

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


def _scan_cond(cond):
    """A scan's conditioning arrays (L, U, Kx per table) from its DAC
    snapshot {(cls, idx): value}, with the defaults where nothing was
    sent; out-of-range values raise ValueError as jdarith.c's
    JERR_DAC_VALUE does."""
    dl, du, ak = DC_L.copy(), DC_U.copy(), AC_K.copy()
    for (tc, th), v in cond.items():
        if tc == 0:
            dl[th], du[th] = v & 15, v >> 4
            if du[th] < dl[th] or du[th] > 15:
                raise ValueError("bogus DAC DC conditioning 0x%02X" % v)
        else:
            ak[th] = v
            if not 1 <= v <= 63:
                raise ValueError("bogus DAC AC conditioning %d" % v)
    return dl, du, ak


def decode_coefficients_arith(jp: marker.ParsedJpeg,
                              data: bytes) -> List[np.ndarray]:
    """Entropy-decode an arithmetic-coded stream's scans -> per component
    (bh_pad, bw_pad, 64) int16 zigzag planes (MCU-padded dims). Sets
    jp.coef_bits / jp.coef_bits_prev (the progression status that block
    smoothing reads, jdarith.c:663-680) and jp.last_good_imcu_row, which
    is always the last iMCU row: the arithmetic decoder reads past the
    end of the data as zeros (jdarith.c:136-141), so every scan it starts
    completes."""
    marker.validate_decodable(jp)
    lib = native.lib()
    mcus_x, mcus_y, comps = geometry(
        jp.width, jp.height, [(c.h, c.v) for c in jp.components])
    planes = [np.zeros((g.bh_pad, g.bw_pad, 64), np.int16) for g in comps]
    buf = np.frombuffer(data, np.uint8)
    ncomps = len(jp.components)
    cb_cur = np.full((ncomps, 64), -1, dtype=np.int32)
    cb_prev = np.full((ncomps, 64), -1, dtype=np.int32)
    for si, scan in enumerate(jp.scans):
        if jp.progressive:
            for ci in scan.comp_indices:
                lo, hi = min(scan.Ss, 1), max(scan.Se, 9)
                cb_prev[ci, lo:hi + 1] = (cb_cur[ci, lo:hi + 1]
                                          if si > 0 else 0)
                cb_cur[ci, scan.Ss:scan.Se + 1] = scan.Al
        seg = np.ascontiguousarray(buf[scan.data_start:scan.data_end])
        ln = scan.data_end - scan.data_start
        restart = jp.scan_restart[si]
        ns = len(scan.comp_indices)
        interleaved = ns > 1
        # the planes are contiguous int16, so the structs point into them
        arr, _ = _planes_arr(scan.comp_indices, planes, comps, scan.dc_tbls,
                             scan.ac_tbls, interleaved)
        smx, smy = (mcus_x, mcus_y) if interleaved else (arr[0].bw,
                                                         arr[0].bh)
        dl, du, ak = _scan_cond(jp.scan_arith_cond[si])
        if not jp.progressive:
            r = lib.mj_arith_decode_seq(_u8(seg), ln, arr, ns, smx, smy,
                                        restart, _u8(dl), _u8(du), _u8(ak))
        elif scan.Ss == 0 and scan.Ah == 0:
            r = lib.mj_arith_decode_dc_first(_u8(seg), ln, arr, ns, smx,
                                             smy, restart, scan.Al, _u8(dl),
                                             _u8(du))
        elif scan.Ss == 0:
            r = lib.mj_arith_decode_dc_refine(_u8(seg), ln, arr, ns, smx,
                                              smy, restart, scan.Al)
        elif scan.Ah == 0:
            r = lib.mj_arith_decode_ac_first(_u8(seg), ln, arr, scan.Ss,
                                             scan.Se, scan.Al, restart,
                                             _u8(ak))
        else:
            r = lib.mj_arith_decode_ac_refine(_u8(seg), ln, arr, scan.Ss,
                                              scan.Se, scan.Al, restart)
        if r < 0:
            raise ValueError("corrupt arithmetic scan %d" % si)
    jp.coef_bits = cb_cur if jp.progressive else None
    jp.coef_bits_prev = cb_prev if jp.progressive else None
    jp.last_good_imcu_row = mcus_y - 1
    return planes
