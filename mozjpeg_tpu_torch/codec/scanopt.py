"""jpegrescan-style scan optimization through the native scan search.

Port of mozjpeg_tpu/codec/scanopt.py::encode_optimize_scans_native: the
whole candidate sweep, greedy selection and stitching run in C++
(mozjpeg_tpu/native/scansearch.cpp mj_scan_search, GIL released), each
candidate scan with its own restart interval; Python writes the frame
header around the stitched scans (mozjpeg jcmaster.c:773-962
select_scans, jcparam.c:734-852). The search runs for grayscale and
YCbCr frames only (jcparam.c:753-756).
"""
from __future__ import annotations

import numpy as np

from .. import native
from . import marker, scans
from .config import CS_INFO, qt_slots, scan_restart_interval


def encode_optimize_scans_native(width: int, height: int, geom, planes,
                                 qtables, cfg, ncomps: int,
                                 precision: int = 8, nthreads: int = 1,
                                 extra_markers=None) -> bytes:
    """planes: per component (bh_pad, bw_pad, 64) int16 zigzag blocks;
    extra_markers: [(marker code, payload)] written after the JFIF
    header (the ICC chunks)."""
    mcus_x, mcus_y, comps = geom
    script = scans.search_progression(ncomps, cfg.dc_scan_opt_mode)
    restarts = np.asarray([scan_restart_interval(cfg, s, geom)
                           for s in script], np.int32)

    arr = (native.SearchComp * ncomps)()
    keep = []
    for ci in range(ncomps):
        p = np.ascontiguousarray(planes[ci], dtype=np.int16)
        keep.append(p)
        g = comps[ci]
        arr[ci].coef = p.ctypes.data
        arr[ci].bw = g.bw
        arr[ci].bh = g.bh
        arr[ci].bw_pad = g.bw_pad
        arr[ci].bh_pad = g.bh_pad
        arr[ci].stride = p.shape[1]
        arr[ci].h = g.h
        arr[ci].v = g.v

    total_blocks = sum(g.bw_pad * g.bh_pad for g in comps[:ncomps])
    cap = total_blocks * 384 + (1 << 20)
    out = np.empty(cap, np.uint8)
    meta = np.zeros(1 + 8 * 40, np.int32)
    n = native.lib().mj_scan_search(
        arr, ncomps, mcus_x, mcus_y, cfg.dc_scan_opt_mode,
        restarts.ctypes.data_as(native.i32p), out.ctypes.data_as(native.u8p),
        cap, meta.ctypes.data_as(native.i32p), int(nthreads))
    del keep
    if n < 0:
        raise RuntimeError("native scan search: output buffer overflow")

    cs = "grayscale" if ncomps == 1 else "ycbcr"
    slots = qt_slots(cfg, cs, ncomps)
    comp_ids = CS_INFO[cs][2]
    sof_samp = [(comps[ci].h, comps[ci].v) for ci in range(ncomps)]
    if ncomps == 1 and cfg.gray_sample:
        sof_samp[0] = tuple(cfg.gray_sample)
    w = marker.MarkerWriter()
    w.soi()
    if cfg.write_jfif:
        w.jfif_app0(unit=cfg.density[0], xd=cfg.density[1],
                    yd=cfg.density[2])
    for code, payload in (extra_markers or ()):
        w.segment(code, payload)
    w.dqt_multi([(i, qtables[i]) for i in dict.fromkeys(slots)])
    w.sof(marker.SOF2, precision, height, width,
          [(comp_ids[ci], sof_samp[ci][0], sof_samp[ci][1], slots[ci])
           for ci in range(ncomps)])
    w.raw(out[:n].tobytes())
    w.eoi()
    return w.bytes()
