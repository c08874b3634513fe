"""ctypes bindings for the port's native host library (built at first use).

Binds what the encode path calls (mj_prep_ycc, mj_gen_optimal_table,
mj_scan_search with its optional SEARCH_STATS counters and the worker
threads it codes candidates on (SearchWorkers), and the scan
encoders mj_encode_seq and
mj_encode_{dc,ac}_{first,refine} of entropy.cpp, which gather symbol
counts or emit one scan (the AC coders' plain twins
mj_encode_ac_{first,refine}_plain too, for the tests), and
mj_ac_refine_schedule, the AC-refinement EOB-run and correction-bit flush schedule of the device packers), what the decode path calls (the six Huffman
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
mj_tga_rle_decode, mj_png_unfilter), the lossless coder (lossless.cpp:
mj_lossless_encode, mj_lossless_decode), the host decode render
(mj_host_render in hostenc.cpp, mj_post_ycc in post.cpp) and the host
halves of the transfer codecs (mj_sparse_count and mj_sparse_pack in
post.cpp, mj_sparse_expand_flat and mj_transport_decode in entropy.cpp,
mj_plane_pack and mj_plane_expand in planepack.cpp). The sources are
the port's own copy, taken from mozjpeg_tpu/native at commit 0d0dbf6,
beside this module; see build.py.
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


# mj_scan_search's counters: the candidates whose size the selection read,
# ns in the gather passes, the optimal tables, the emission passes (each
# summed over every candidate coded) and the stitch, the candidates coded
# ahead of the selection and those of them it never read, then the blocks
# the AC candidates' gather and emission passes walked and those of them
# whose band was all zero after the point transform
SEARCH_STATS = ("candidates", "gather_ns", "tables_ns", "emit_ns",
                "stitch_ns", "ahead", "ahead_unused", "blocks",
                "zero_blocks")


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
_SHARED = None
_SHARED_LOCK = threading.Lock()


def lib():
    """The loaded library, compiled from the port's own copy of the
    sources (beside this module) if stale."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build.build_native()
            _LIB = _bind(ctypes.CDLL(
                os.path.join(build.BUILD_DIR, build.LIB_NAME)))
    return _LIB


class SearchWorkers:
    """n native threads that code the candidates of every mj_scan_search
    given them (scansearch.cpp Workers), each search offering the
    candidate its selection needs next. close() stops and joins them;
    close a set only with no search in flight."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError("a set of search workers needs a thread")
        self.n = n
        self.handle = lib().mj_search_workers_new(n)

    def close(self):
        if self.handle:
            lib().mj_search_workers_free(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def search_workers() -> SearchWorkers:
    """The process's one set of search workers, os.cpu_count() threads,
    started at first use (again in a forked child, which has none of its
    parent's threads) and shared by every search in flight."""
    global _SHARED
    with _SHARED_LOCK:
        if _SHARED is None or _SHARED[0] != os.getpid():
            _SHARED = (os.getpid(), SearchWorkers(os.cpu_count() or 1))
        return _SHARED[1]


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
        ctypes.c_int, i32p, u8p, ctypes.c_long, i32p, ctypes.c_void_p,
        i64p]
    so.mj_search_workers_new.restype = ctypes.c_void_p
    so.mj_search_workers_new.argtypes = [ctypes.c_int]
    so.mj_search_workers_free.restype = None
    so.mj_search_workers_free.argtypes = [ctypes.c_void_p]

    cpp = _p(CompPlane)
    lng, cint = ctypes.c_long, ctypes.c_int
    so.mj_encode_seq.argtypes = [
        cpp, cint, cint, cint, cint, u32p, u8p, u32p, u8p, u8p, lng, i64p,
        i64p, cint]
    so.mj_encode_dc_first.argtypes = [
        cpp, cint, cint, cint, cint, cint, u32p, u8p, u8p, lng, i64p, cint]
    so.mj_encode_dc_refine.argtypes = [
        cpp, cint, cint, cint, cint, cint, u8p, lng]
    # the AC coders' last argument: null, or the int64 [blocks walked,
    # blocks with an empty band] they add to; their _plain twins (tests
    # only) take none
    for fn in (so.mj_encode_ac_first, so.mj_encode_ac_refine):
        fn.argtypes = [cpp, cint, cint, cint, cint, u32p, u8p, u8p, lng,
                       i64p, cint, i64p]
    for fn in (so.mj_encode_ac_first_plain, so.mj_encode_ac_refine_plain):
        fn.argtypes = [cpp, cint, cint, cint, cint, u32p, u8p, u8p, lng,
                       i64p, cint]
    for fn in (so.mj_encode_seq, so.mj_encode_dc_first,
               so.mj_encode_dc_refine, so.mj_encode_ac_first,
               so.mj_encode_ac_refine, so.mj_encode_ac_first_plain,
               so.mj_encode_ac_refine_plain):
        fn.restype = lng
    so.mj_ac_refine_schedule.restype = lng
    so.mj_ac_refine_schedule.argtypes = [i32p, i32p, i32p, lng, lng] \
        + [i32p] * 9

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
    so.mj_png_unfilter.restype = cint
    so.mj_png_unfilter.argtypes = [u8p, u8p, lng, lng, cint]

    # the lossless coder (lossless.cpp)
    vpp = _p(ctypes.c_void_p)
    so.mj_lossless_encode.restype = lng
    so.mj_lossless_encode.argtypes = [
        vpp, cint, cint, cint, cint, cint, cint, i32p, u32p, u8p, u8p, lng,
        i64p, cint, ctypes.c_uint]
    so.mj_lossless_decode.restype = lng
    so.mj_lossless_decode.argtypes = [
        u8p, lng, vpp, cint, cint, cint, cint, cint, cint, i32p, *tabs,
        ctypes.c_uint]

    # the host decode render (hostenc.cpp, post.cpp)
    so.mj_host_render.restype = lng
    so.mj_host_render.argtypes = [i16p, i32p, cint, cint, cint, cint, u8p,
                                  cint]
    so.mj_post_ycc.restype = None
    so.mj_post_ycc.argtypes = [u8p, lng, lng, u8p, u8p, lng, lng, cint, cint,
                               cint, lng, lng, u8p]

    # the transfer codecs' host halves (post.cpp, entropy.cpp,
    # planepack.cpp)
    so.mj_sparse_count.restype = lng
    so.mj_sparse_count.argtypes = [i16p, lng, cint, i32p]
    so.mj_sparse_pack.restype = lng
    so.mj_sparse_pack.argtypes = [i16p, lng, cint, cint, u32p, i16p]
    so.mj_sparse_expand_flat.restype = lng
    so.mj_sparse_expand_flat.argtypes = [u32p, u8p, i16p, lng, lng, lng,
                                         i16p]
    so.mj_transport_decode.restype = lng
    so.mj_transport_decode.argtypes = [u32p, lng, i32p, cint, lng, *tabs,
                                       *tabs, i16p]
    so.mj_plane_pack.restype = lng
    so.mj_plane_pack.argtypes = [u8p, lng, u8p, u32p, cint]
    so.mj_plane_expand.restype = lng
    so.mj_plane_expand.argtypes = [u8p, u32p, lng, lng, u8p]
    return so
