"""Host (CPU) encode engine: the whole mozjpeg pass pipeline of one image
on the host's cores.

Port of mozjpeg_tpu/codec/host_engine.py: native prep, islow FDCT,
deringing and the trellis (native/hostenc.cpp, threaded over
block rows, built into the port's library), the arithmetic trellis with
its adaptive coder context (native/arith.cpp), then the port's host
entropy stage (encoder.entropy_image). Byte-identical to the device
paths, which the JAX package pins it to.

The port takes this engine only when the caller asks for the CPU
(device="cpu"), where it routes as the JAX package does: encode() sends
single images here when the configuration is in supported()'s matrix and
keeps the colorspace's quant slots, and encode_many sends the
configurations its batched path does not carry. MJ_HOST_ENGINE=0 turns
the engine off (the JAX package's switch). On the GPU every
configuration runs the card's route (encoder.py).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import consts, native
from . import encoder, report, trellis
from .config import CS_INFO, qt_slots, trellis_ris
from .pipeline import geometry
from .pipeline_t import add_dummy_blocks_host


def enabled() -> bool:
    return os.environ.get("MJ_HOST_ENGINE", "1") != "0"


def supported(cfg, cs: str) -> bool:
    """The host engine's configuration matrix."""
    return (cfg.precision == 8
            and cfg.dct_method.value == "islow"
            and cfg.smoothing_factor == 0
            and cs in ("ycbcr", "grayscale")
            and tuple(cfg.subsampling) in ((2, 2), (2, 1), (1, 1)))


def _nthreads() -> int:
    return max(1, os.cpu_count() or 4)


def _prep_planes(image, cs, samp, geom):
    """Padded uint8 sample planes per component (native prep, or the
    edge-replicated 2-D plane)."""
    lib = native.lib()
    comps = geom[2]
    h, w = image.shape[:2]
    rgb = np.ascontiguousarray(image)
    if cs == "grayscale" and image.ndim == 2:
        g = comps[0]
        y = np.empty((g.bh_pad * 8, g.bw_pad * 8), np.uint8)
        y[:h, :w] = image
        y[:h, w:] = y[:h, w - 1:w]
        y[h:] = y[h - 1:h]
        return [y]
    # Y only for gray from RGB (hs = vs = 1, chroma discarded)
    hs, vs = (1, 1) if cs == "grayscale" else samp[0]
    gy, gc = comps[0], comps[-1]
    y = np.empty((gy.bh_pad * 8, gy.bw_pad * 8), np.uint8)
    cshape = y.shape if cs == "grayscale" else (gc.bh_pad * 8,
                                                gc.bw_pad * 8)
    cb, cr = np.empty(cshape, np.uint8), np.empty(cshape, np.uint8)
    lib.mj_prep_ycc(rgb.ctypes.data_as(native.u8p), w, h, hs, vs,
                    y.shape[1], y.shape[0], cshape[1], cshape[0],
                    y.ctypes.data_as(native.u8p),
                    cb.ctypes.data_as(native.u8p),
                    cr.ctypes.data_as(native.u8p), _nthreads())
    return [y] if cs == "grayscale" else [y, cb, cr]


def _run_p1(planes, geom, qtables, slots, dering_on):
    """Per component (q (n, 64) int16, raw (n, 64) int32, norms (n,) f32,
    zigzag quant table (64,) int32)."""
    lib = native.lib()
    out = []
    for ci, g in enumerate(geom[2]):
        pl = planes[ci]
        n = g.bh * g.bw
        qz = np.ascontiguousarray(np.asarray(qtables[slots[ci]])
                                  .reshape(64)[consts.JPEG_ZIGZAG]
                                  .astype(np.int32))
        q = np.empty((n, 64), np.int16)
        raw = np.empty((n, 64), np.int32)
        norms = np.empty((n,), np.float32)
        lib.mj_host_p1(pl.ctypes.data_as(native.u8p), pl.shape[1], g.bw,
                       g.bh, qz.ctypes.data_as(native.i32p), int(dering_on),
                       8, q.ctypes.data_as(native.i16p),
                       raw.ctypes.data_as(native.i32p),
                       norms.ctypes.data_as(native.f32p), _nthreads())
        out.append((q, raw, norms, qz))
    return out


def _lambdas(cfg, p1):
    return [trellis.lambda_from_norm_t(
        torch.from_numpy(norms), cfg.lambda_log_scale1,
        cfg.lambda_log_scale2).numpy() for _, _, norms, _ in p1]


def _band_hist(q, ss, se, ri) -> np.ndarray:
    h = np.empty(256, np.int32)
    native.lib().mj_hist_ac_first(
        np.ascontiguousarray(q).ctypes.data_as(native.i16p), q.shape[0], ss,
        se, int(ri or 0), h.ctypes.data_as(native.i32p))
    return h


def _trellis(cfg, cs, comps, p1):
    """The Huffman trellis passes on host arrays (the per-image route's
    order: every band of every loop regathers its statistics from the
    current coefficients) -> per component (n, 64) int16."""
    lib = native.lib()
    nt = _nthreads()
    tcomps = encoder._trellis_comps(cfg, cs, comps)
    ris = trellis_ris(cfg, comps)
    tbl_slots = CS_INFO[cs][1]
    opt = cfg.optimize_coding and not cfg.arithmetic
    lams = _lambdas(cfg, p1)
    fs = cfg.trellis_freq_split
    bands = ([(1, fs), (fs + 1, 63)] if cfg.use_scans_in_trellis
             else [(1, 63)])
    cur = [np.array(q, copy=True) for q, _, _, _ in p1]
    for _ in range(max(1, cfg.trellis_num_loops)):
        for bi, (ss, se) in enumerate(bands):
            for ci, (_, raw, _, qz) in enumerate(p1):
                g = tcomps[ci]
                hist = (_band_hist(cur[ci], ss, se, ris[ci] if ris else 0)
                        if opt else None)
                ac_si, dc_si = trellis.trellis_tables_from_hist(
                    hist, tbl_slots[ci], opt)
                lib.mj_host_trellis_ac(
                    raw.ctypes.data_as(native.i32p),
                    cur[ci].ctypes.data_as(native.i16p), raw.shape[0], g.bw,
                    qz.ctypes.data_as(native.i32p),
                    lams[ci].ctypes.data_as(native.f32p),
                    ac_si.ctypes.data_as(native.i32p), ss, se,
                    int(cfg.trellis_eob_opt), 10, 1023, nt)
                if cfg.trellis_quant_dc and bi == 0:
                    lib.mj_host_trellis_dc(
                        raw.ctypes.data_as(native.i32p),
                        cur[ci].ctypes.data_as(native.i16p), g.bw, g.bh,
                        g.v, int(qz[0]), dc_si.ctypes.data_as(native.i32p),
                        lams[ci].ctypes.data_as(native.f32p),
                        trellis.get_num_dc_candidates(int(qz[0])), 1023,
                        float(cfg.trellis_delta_dc_weight), nt)
    return cur


def _trellis_arith(cfg, cs, comps, p1):
    """The arithmetic trellis on the host: per visited component a fresh
    coder context; per iMCU row its rates, then per block row the AC and
    DC row trellis and the coder's training on the row's choices, with
    the restart resets (encoder.ArithTrainer) -> per component (n, 64)
    int16."""
    lib = native.lib()
    nt = _nthreads()
    tcomps = encoder._trellis_comps(cfg, cs, comps)
    fs = cfg.trellis_freq_split
    band_defs = ([(1, fs), (fs + 1, 63)] if cfg.use_scans_in_trellis
                 else [(1, 63)])
    cur = [np.array(q, copy=True) for q, _, _, _ in p1]
    lams = _lambdas(cfg, p1)
    rint = trellis_ris(cfg, comps)
    fin = np.zeros(1, np.int32)
    for comp, band in trellis.arith_trellis_comps(
            len(p1), max(1, cfg.trellis_num_loops),
            cfg.use_scans_in_trellis):
        g = tcomps[comp]
        ss, se = band_defs[band]
        _, raw, _, qz = p1[comp]
        q0 = int(qz[0])
        ltbl0 = np.float32(1.0 / (q0 * q0))
        nc = trellis.get_num_dc_candidates(q0)
        qc = cur[comp]
        with encoder.ArithTrainer(cfg, rint[comp] if rint else 0) as coder:
            for ri in range(-(-g.bh // g.v)):
                rate_dc, rate_ac = coder.rates()
                last_dc = 0
                for br in range(ri * g.v, min((ri + 1) * g.v, g.bh)):
                    a, b = br * g.bw, (br + 1) * g.bw
                    raw_row, q_row = raw[a:b], qc[a:b]
                    lam_row = np.ascontiguousarray(lams[comp][a:b])
                    lib.mj_host_arith_ac_row(
                        raw_row.ctypes.data_as(native.i32p),
                        q_row.ctypes.data_as(native.i16p), g.bw,
                        qz.ctypes.data_as(native.i32p),
                        lam_row.ctypes.data_as(native.f32p),
                        rate_ac.ctypes.data_as(native.f32p), ss, se, 5, nt)
                    if cfg.trellis_quant_dc and band == 0:
                        lam_dc = np.ascontiguousarray(
                            (lam_row * ltbl0).astype(np.float32))
                        lib.mj_host_arith_dc_row(
                            raw_row.ctypes.data_as(native.i32p),
                            q_row.ctypes.data_as(native.i16p), g.bw, q0,
                            rate_dc.ctypes.data_as(native.f32p), nc,
                            lam_dc.ctypes.data_as(native.f32p), last_dc,
                            fin.ctypes.data_as(native.i32p))
                        last_dc = int(fin[0])
                    coder.train(q_row)
    return cur


def encode_host(image, ctx: "encoder.GroupCtx") -> bytes:
    """One image's whole encode on the host -> its JPEG bytes."""
    cfg, cs, ncomps = ctx.cfg, ctx.cs, ctx.ncomps
    h, w = image.shape[:2]
    geom = geometry(w, h, ctx.samp)
    comps = geom[2]
    slots = qt_slots(cfg, cs, ncomps)
    report.add_passes(2 if cfg.trellis_quant else 1)
    planes = _prep_planes(image, cs, ctx.samp, geom)
    p1 = _run_p1(planes, geom, ctx.qtables, slots, cfg.overshoot_deringing)
    report.pass_done("main")
    if cfg.trellis_quant and cfg.arithmetic:
        finals = _trellis_arith(cfg, cs, comps, p1)
        report.pass_done("trellis")
    elif cfg.trellis_quant:
        finals = _trellis(cfg, cs, comps, p1)
        report.pass_done("trellis")
    else:
        finals = [q for q, _, _, _ in p1]
    if cfg.trellis_quant and cfg.trellis_q_opt:
        ns, nc = encoder.q_opt_sums(
            [torch.from_numpy(raw.T) for _, raw, _, _ in p1],
            [torch.from_numpy(f.T) for f in finals], 1)
        ctx = ctx._replace(qtables=encoder.q_opt_tables(
            ns[0], nc[0], ctx.qtables, slots))
    out_planes = [add_dummy_blocks_host(f.reshape(g.bh, g.bw, 64), g)
                  for f, g in zip(finals, comps)]
    return encoder.entropy_image(w, h, geom, out_planes, ctx)
