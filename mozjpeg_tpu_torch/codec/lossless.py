"""Lossless JPEG (process 14, SOF3): encode and decode on the host.

Port of mozjpeg_tpu/codec/lossless.py (encode_lossless, decode_lossless),
over the port's C++ coder (native/lossless.cpp, built into
the port's own library): predictors 1-7, a point transform, restart
intervals, 8 to 16-bit samples, gray or RGB (three 1x1 components that
stay RGB, jcparam.c jpeg_enable_lossless and the lossless branch of
jpeg_default_colorspace). Every sample is predicted from its neighbours
and coded by a Huffman table, which is serial work with no device stage
in either package: lossless runs on the host, and its entry points take
no device.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from ..entropy import encode as entenc
from ..entropy.huffman import derive_codes, derive_decode_table
from . import marker


def encode_lossless(image: np.ndarray, predictor: int = 1,
                    point_transform: int = 0, precision: int = 8,
                    restart_interval: int = 0,
                    restart_in_rows: int = 0) -> bytes:
    """Encode an (H, W) or (H, W, 3) uint8/uint16 image losslessly (SOF3
    with an optimal Huffman table), byte-identical to
    mozjpeg_tpu.encode_lossless. precision is 2..16 bits; restart_in_rows
    converts to MCUs at width MCUs a row (a lossless MCU is one sample
    position, jcmaster.c:561,597-600), capped at 65535. Runs on the host
    (no device argument: lossless coding has no device stage)."""
    if not 1 <= predictor <= 7:
        raise ValueError("lossless predictor must be 1..7, got %d"
                         % predictor)
    if not 0 <= point_transform < precision:
        raise ValueError("point transform must be in [0, precision), "
                         "got %d" % point_transform)
    comps = ([image] if image.ndim == 2
             else [image[:, :, i] for i in range(image.shape[2])])
    ncomp = len(comps)
    h, w = comps[0].shape
    pt = point_transform
    ri = int(restart_interval)
    if restart_in_rows:
        ri = min(int(restart_in_rows) * w, 65535)
    planes = [np.ascontiguousarray(c.astype(np.uint16) >> pt) for c in comps]
    ptrs = (ctypes.c_void_p * ncomp)(*[p.ctypes.data for p in planes])
    # every component takes DC table 0 (jpeg_set_colorspace assigns it
    # for RGB and gray alike)
    tbl_idx = np.zeros(ncomp, np.int32)
    lib = native.lib()

    counts = np.zeros(4 * 257, np.int64)
    lib.mj_lossless_encode(ptrs, ncomp, w, h, predictor, precision, pt,
                           tbl_idx.ctypes.data_as(native.i32p), None, None,
                           None, 0, counts.ctypes.data_as(native.i64p), 1,
                           ri)
    table = entenc.gen_optimal_table(counts[:257])
    co = np.zeros(4 * 256, np.uint32)
    si = np.zeros(4 * 256, np.uint8)
    co[:256], si[:256] = derive_codes(table)

    out = np.empty(w * h * ncomp * 4 + (1 << 16), np.uint8)
    n = lib.mj_lossless_encode(ptrs, ncomp, w, h, predictor, precision, pt,
                               tbl_idx.ctypes.data_as(native.i32p),
                               co.ctypes.data_as(native.u32p),
                               si.ctypes.data_as(native.u8p),
                               out.ctypes.data_as(native.u8p), out.size,
                               None, 0, ri)
    if n < 0:
        raise RuntimeError("lossless encode overflow")

    wtr = marker.MarkerWriter()
    wtr.soi()
    if ncomp == 3:
        # RGB: Adobe APP14 with transform 0, component ids 'R', 'G', 'B'
        wtr.adobe_app14(0)
        comp_ids = [0x52, 0x47, 0x42]
    else:
        comp_ids = list(range(1, ncomp + 1))
    wtr.sof(marker.SOF3, precision, h, w,
            [(comp_ids[i], 1, 1, 0) for i in range(ncomp)])
    wtr.dht(0, 0, table)
    if ri:
        wtr.dri(ri)
    wtr.sos([(comp_ids[i], 0, 0) for i in range(ncomp)], predictor, 0, 0,
            pt)
    wtr.raw(bytes(out[:n]))
    wtr.eoi()
    return wtr.bytes()


def decode_lossless(jp: marker.ParsedJpeg, data: bytes) -> np.ndarray:
    """A parsed SOF3 stream -> (H, W) or (H, W, C) samples, uint8 at 8
    bits and below, uint16 above (mozjpeg_tpu decode_lossless). Streams
    of several scans decode too, each scan a disjoint set of components
    with its own predictor, point transform, tables and restart interval
    (jdlhuff.c, jdinput.c). Arithmetic-coded (SOF11) and subsampled
    lossless streams raise ValueError, as there. On the host."""
    marker.validate_decodable(jp)
    if jp.arithmetic:
        raise ValueError("arithmetic-coded lossless (SOF11) is not "
                         "supported")
    if any(c.h != 1 or c.v != 1 for c in jp.components):
        raise ValueError("subsampled lossless components are not "
                         "supported")
    ncomp = len(jp.components)
    covered = sorted(ci for sc in jp.scans for ci in sc.comp_indices)
    if covered != list(range(ncomp)):
        raise ValueError("lossless scans must cover each component "
                         "exactly once")
    h, w = jp.height, jp.width
    planes = [np.zeros((h, w), np.uint16) for _ in range(ncomp)]
    pts = [0] * ncomp
    buf = np.frombuffer(data, np.uint8)
    lib = native.lib()
    for si, scan in enumerate(jp.scans):
        ri = int(jp.scan_restart[si] or 0)
        # a restart interval must be a whole number of MCU rows
        # (jddiffct.c:104-109); an MCU is one sample position
        if ri and ri % w != 0:
            raise ValueError("lossless restart interval must be a "
                             "multiple of the samples per row")
        scomps = list(scan.comp_indices)
        for ci in scomps:
            pts[ci] = scan.Al
        ptrs = (ctypes.c_void_p * len(scomps))(
            *[planes[ci].ctypes.data for ci in scomps])
        tbl_idx = np.array([scan.dc_tbls[ci] for ci in scomps], np.int32)
        mincode = np.zeros((4, 17), np.int32)
        maxcode = np.full((4, 18), -1, np.int64)
        valptr = np.zeros((4, 17), np.int32)
        vals = np.zeros((4, 256), np.uint8)
        for (cls, i), t in jp.scan_htables[si].items():
            if cls == 0:
                mn, mx, vp, vl = derive_decode_table(t)
                mincode[i], maxcode[i], valptr[i] = mn, mx, vp
                vals[i, :len(vl)] = vl
        seg = np.ascontiguousarray(buf[scan.data_start:scan.data_end])
        r = lib.mj_lossless_decode(
            seg.ctypes.data_as(native.u8p), seg.size, ptrs, len(scomps), w,
            h, scan.Ss, jp.precision, scan.Al,
            tbl_idx.ctypes.data_as(native.i32p),
            mincode.ctypes.data_as(native.i32p),
            maxcode.ctypes.data_as(native.i64p),
            valptr.ctypes.data_as(native.i32p),
            vals.ctypes.data_as(native.u8p), ri)
        if r < 0:
            raise ValueError("corrupt lossless scan")
    dt = np.uint16 if jp.precision > 8 else np.uint8
    maxv = (1 << jp.precision) - 1
    out = [np.clip(p.astype(np.uint32) << pts[ci], 0, maxv).astype(dt)
           for ci, p in enumerate(planes)]
    return out[0] if ncomp == 1 else np.stack(out, axis=-1)
