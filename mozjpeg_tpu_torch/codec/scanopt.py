"""jpegrescan-style scan optimization through the native scan search.

Port of mozjpeg_tpu/codec/scanopt.py::encode_optimize_scans_native: the
whole candidate sweep, greedy selection and stitching run in C++
(mozjpeg_tpu/native/scansearch.cpp mj_scan_search, GIL released); Python
writes the frame header around the stitched scans (mozjpeg
jcmaster.c:773-962 select_scans, jcparam.c:734-852).
"""
from __future__ import annotations

import numpy as np

from .. import native
from . import marker, scans


def encode_optimize_scans_native(width: int, height: int, geom, planes,
                                 qtables, cfg, ncomps: int,
                                 precision: int = 8, nthreads: int = 1
                                 ) -> bytes:
    """planes: per component (bh_pad, bw_pad, 64) int16 zigzag blocks."""
    mcus_x, mcus_y, comps = geom
    script = scans.search_progression(ncomps, cfg.dc_scan_opt_mode)
    # restart intervals are outside the port's slice (the encoder refuses
    # them), so every candidate scan runs without one
    restarts = np.zeros(len(script), np.int32)

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

    w = marker.MarkerWriter()
    w.soi()
    if cfg.write_jfif:
        w.jfif_app0(unit=cfg.density[0], xd=cfg.density[1],
                    yd=cfg.density[2])
    w.dqt_multi([(i, qtables[i]) for i in range(min(ncomps, 2))])
    comp_ids = [1, 2, 3][:ncomps]
    w.sof(marker.SOF2, precision, height, width,
          [(comp_ids[ci], comps[ci].h, comps[ci].v, 0 if ci == 0 else 1)
           for ci in range(ncomps)])
    w.raw(out[:n].tobytes())
    w.eoi()
    return w.bytes()
