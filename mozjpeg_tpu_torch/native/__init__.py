"""ctypes bindings for the port's native host library (built at first use).

Binds what the encode path calls (mj_prep_ycc, mj_gen_optimal_table,
mj_scan_search, and the scan encoders mj_encode_seq and
mj_encode_{dc,ac}_{first,refine} of entropy.cpp, which gather symbol
counts or emit one scan), what the decode path calls (the six Huffman
decoders mj_decode_seq, mj_decode_seq_par, mj_decode_{dc,ac}_{first,refine}
and the warning counter mj_set_warnings / mj_get_warnings, all in
entropy.cpp), the host engine's steps (hostenc.cpp: mj_host_p1,
mj_hist_ac_first, mj_host_trellis_ac, mj_host_trellis_dc,
mj_host_arith_ac_row, mj_host_arith_dc_row) and the arithmetic coder
(arith.cpp: the scan encoders mj_arith_encode_{seq,dc_first,dc_refine,
ac_first,ac_refine}, and the trellis's training context mj_arith_ctx_new,
mj_arith_ctx_free, mj_arith_ctx_restart, mj_arith_get_rates,
mj_arith_train_rows, and the scan decoders mj_arith_decode_{seq,dc_first,
dc_refine,ac_first,ac_refine}), the colour quantizers (quant.cpp:
mj_quantize_colors, mj_quantize_onepass, mj_quantize_to_map) and the
image codecs (imageio.cpp: mj_gif_lzw_encode, mj_gif_lzw_decode,
mj_tga_rle_decode); see build.py for the sources.
"""
from __future__ import annotations

import ctypes
import os
import threading

from . import build

_p = ctypes.POINTER
u8p = _p(ctypes.c_uint8)
u32p = _p(ctypes.c_uint32)
i16p = _p(ctypes.c_int16)
i32p = _p(ctypes.c_int32)
i64p = _p(ctypes.c_int64)
f32p = _p(ctypes.c_float)


class CompPlane(ctypes.Structure):
    """One component's coefficient plane for the native decoders
    (entropy.cpp CompPlaneMut) and the arithmetic scan encoders (arith.cpp
    CompPlaneA, the same layout)."""
    _fields_ = [
        ("coef", ctypes.c_void_p),
        ("bw", ctypes.c_int32), ("bh", ctypes.c_int32),
        ("stride", ctypes.c_int32),
        ("h", ctypes.c_int32), ("v", ctypes.c_int32),
        ("dc_tbl", ctypes.c_int32), ("ac_tbl", ctypes.c_int32),
    ]


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

    cpp = _p(CompPlane)
    lng, cint = ctypes.c_long, ctypes.c_int
    so.mj_encode_seq.argtypes = [
        cpp, cint, cint, cint, cint, u32p, u8p, u32p, u8p, u8p, lng, i64p,
        i64p, cint]
    so.mj_encode_dc_first.argtypes = [
        cpp, cint, cint, cint, cint, cint, u32p, u8p, u8p, lng, i64p, cint]
    so.mj_encode_dc_refine.argtypes = [
        cpp, cint, cint, cint, cint, cint, u8p, lng]
    for fn in (so.mj_encode_ac_first, so.mj_encode_ac_refine):
        fn.argtypes = [cpp, cint, cint, cint, cint, u32p, u8p, u8p, lng,
                       i64p, cint]
    for fn in (so.mj_encode_seq, so.mj_encode_dc_first,
               so.mj_encode_dc_refine, so.mj_encode_ac_first,
               so.mj_encode_ac_refine):
        fn.restype = lng

    tabs = [i32p, i64p, i32p, u8p]      # mincode, maxcode, valptr, vals
    so.mj_decode_seq.restype = ctypes.c_long
    so.mj_decode_seq.argtypes = [
        u8p, ctypes.c_long, cpp, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *tabs, *tabs, i32p, i64p]
    so.mj_decode_seq_par.restype = ctypes.c_long
    so.mj_decode_seq_par.argtypes = [
        u8p, ctypes.c_long, cpp, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *tabs, *tabs, i32p, ctypes.c_int, i64p]
    so.mj_decode_dc_first.restype = ctypes.c_long
    so.mj_decode_dc_first.argtypes = [
        u8p, ctypes.c_long, cpp, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *tabs, i32p, i64p]
    so.mj_decode_dc_refine.restype = ctypes.c_long
    so.mj_decode_dc_refine.argtypes = [
        u8p, ctypes.c_long, cpp, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i64p]
    for fn in (so.mj_decode_ac_first, so.mj_decode_ac_refine):
        fn.restype = ctypes.c_long
        fn.argtypes = [
            u8p, ctypes.c_long, cpp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *tabs, i32p, i64p]
    so.mj_set_warnings.restype = None
    so.mj_set_warnings.argtypes = [ctypes.c_long]
    so.mj_get_warnings.restype = ctypes.c_long
    so.mj_get_warnings.argtypes = []

    # the host engine (hostenc.cpp)
    so.mj_host_p1.restype = lng
    so.mj_host_p1.argtypes = [u8p, cint, cint, cint, i32p, cint, cint, i16p,
                              i32p, f32p, cint]
    so.mj_hist_ac_first.restype = lng
    so.mj_hist_ac_first.argtypes = [i16p, lng, cint, cint, lng, i32p]
    so.mj_host_trellis_ac.restype = lng
    so.mj_host_trellis_ac.argtypes = [i32p, i16p, lng, cint, i32p, f32p,
                                      i32p, cint, cint, cint, cint, cint,
                                      cint]
    so.mj_host_trellis_dc.restype = lng
    so.mj_host_trellis_dc.argtypes = [i32p, i16p, cint, cint, cint, cint,
                                      i32p, f32p, cint, cint,
                                      ctypes.c_float, cint]
    so.mj_host_arith_ac_row.restype = lng
    so.mj_host_arith_ac_row.argtypes = [i32p, i16p, lng, i32p, f32p, f32p,
                                        cint, cint, cint, cint]
    so.mj_host_arith_dc_row.restype = lng
    so.mj_host_arith_dc_row.argtypes = [i32p, i16p, lng, cint, f32p, cint,
                                        f32p, cint, i32p]

    # the arithmetic coder (arith.cpp): scan encoders and the trellis's
    # training context
    so.mj_arith_encode_seq.argtypes = [cpp, cint, cint, cint, cint, u8p, u8p,
                                       u8p, u8p, lng]
    so.mj_arith_encode_dc_first.argtypes = [cpp, cint, cint, cint, cint,
                                            cint, u8p, u8p, u8p, lng]
    so.mj_arith_encode_dc_refine.argtypes = [cpp, cint, cint, cint, cint,
                                             cint, u8p, lng]
    so.mj_arith_encode_ac_first.argtypes = [cpp, cint, cint, cint, cint, u8p,
                                            u8p, lng]
    so.mj_arith_encode_ac_refine.argtypes = [cpp, cint, cint, cint, cint,
                                             u8p, lng]
    for fn in (so.mj_arith_encode_seq, so.mj_arith_encode_dc_first,
               so.mj_arith_encode_dc_refine, so.mj_arith_encode_ac_first,
               so.mj_arith_encode_ac_refine):
        fn.restype = lng
    so.mj_arith_decode_seq.argtypes = [u8p, lng, cpp, cint, cint, cint, cint,
                                       u8p, u8p, u8p]
    so.mj_arith_decode_dc_first.argtypes = [u8p, lng, cpp, cint, cint, cint,
                                            cint, cint, u8p, u8p]
    so.mj_arith_decode_dc_refine.argtypes = [u8p, lng, cpp, cint, cint, cint,
                                             cint, cint]
    so.mj_arith_decode_ac_first.argtypes = [u8p, lng, cpp, cint, cint, cint,
                                            cint, u8p]
    so.mj_arith_decode_ac_refine.argtypes = [u8p, lng, cpp, cint, cint, cint,
                                             cint]
    for fn in (so.mj_arith_decode_seq, so.mj_arith_decode_dc_first,
               so.mj_arith_decode_dc_refine, so.mj_arith_decode_ac_first,
               so.mj_arith_decode_ac_refine):
        fn.restype = lng
    vp = ctypes.c_void_p
    so.mj_arith_ctx_new.restype = vp
    so.mj_arith_ctx_new.argtypes = []
    so.mj_arith_ctx_free.restype = None
    so.mj_arith_ctx_free.argtypes = [vp]
    so.mj_arith_ctx_restart.restype = None
    so.mj_arith_ctx_restart.argtypes = [vp, cint, cint, cint]
    so.mj_arith_get_rates.restype = None
    so.mj_arith_get_rates.argtypes = [vp, f32p, f32p]
    so.mj_arith_train_rows.restype = None
    so.mj_arith_train_rows.argtypes = [vp, i16p, cint, cint, cint, cint]

    # the colour quantizers (quant.cpp) and image codecs (imageio.cpp)
    so.mj_quantize_colors.restype = cint
    so.mj_quantize_colors.argtypes = [u8p, cint, cint, cint, cint, u8p, u8p]
    so.mj_quantize_onepass.restype = cint
    so.mj_quantize_onepass.argtypes = [u8p, cint, cint, cint, cint, cint,
                                       u8p, u8p]
    so.mj_quantize_to_map.restype = cint
    so.mj_quantize_to_map.argtypes = [u8p, cint, cint, u8p, cint, cint, u8p]
    so.mj_gif_lzw_decode.restype = lng
    so.mj_gif_lzw_decode.argtypes = [u8p, lng, cint, u8p, lng]
    so.mj_gif_lzw_encode.restype = lng
    so.mj_gif_lzw_encode.argtypes = [u8p, lng, cint, cint, u8p, lng]
    so.mj_tga_rle_decode.restype = lng
    so.mj_tga_rle_decode.argtypes = [u8p, lng, cint, u8p, lng]
    return so
