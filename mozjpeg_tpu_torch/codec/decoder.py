"""Decode: marker parse -> native entropy decode on the host -> dequant +
IDCT, upsampling and colour conversion on a device.

Port of mozjpeg_tpu/codec/decoder.py, pixel-identical to the JAX
package's decode entry points (whose outputs are pinned to djpeg). The
host half is the shared C++ entropy decoders (entropy.cpp for Huffman,
arith.cpp for arithmetic coding through codec/arith.py, in the port's own
library); the pixel half is PyTorch on the device the caller names:

  decode       parse, entropy decode, then `render` (the device branch of
               the JAX package's render: block smoothing on the host,
               then every component's IDCT (islow, ifast or float), the
               upsampling and the colour conversion on the device: YCbCr
               -> RGB, YCCK -> CMYK, and the null conversion of RGB and
               CMYK streams);
  decode_many  the JAX package's route for a locally attached device
               (merged_local): every stream is parsed, entropy-decoded on
               a thread pool, and the YCbCr or gray images of one
               geometry are rendered together, GROUP at a time
               (render_ycc_batch: upload the int16 zigzag planes and
               per-image quant tables, render, download uint8 RGB). Other
               colour spaces, images with active block smoothing and Cb/Cr
               planes that differ in geometry or quant table go through
               `render` one at a time. output="yuv" returns the
               per-component sample planes (decode_raw_planes_parsed);
  decode_grayscale, decode_cropped, BufferedImage
               djpeg -grayscale, jpeg_crop_scanline and the buffered-image
               passes, on the same parts;
  decode_scaled  djpeg -scale M/8, M = 1..16: the scaled IDCTs of
               ops/idct_scaled.py, then jdsample.c's upsampler choice, on
               the device;
  decode_rgb565, decode_many(output="rgb565")
               the dithered RGB565 pack of jdcol565.c, on the device;
  decode_raw_planes
               jpeg_read_raw_data (jpegyuv);
  quantize_colors, read_color_map, quantize_to_map
               djpeg -colors and -map: the shared C++ quantizers
               (quant.cpp) on the host.

The slice is 8-bit Huffman or arithmetic-coded, sequential and
progressive streams of one to four (or more) components, gray, YCbCr,
RGB, CMYK and YCCK, any sampling, with restart intervals, truncated and
corrupt streams, fancy or replicating upsampling and block smoothing.
Lossless, 12- and 16-bit streams raise NotImplementedError naming the
ROADMAP.md item that brings them; nothing falls back to the CPU or to
another route.
"""
from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..entropy.huffman import derive_decode_table
from ..native import CompPlane, i32p, i64p, lib, u8p
from ..ops import color, dct, idct_scaled, layout, sample
from . import arith, marker, smooth
from .encoder import _device
from .stages import stage

GROUP = 8     # images per batched render (the JAX package's MJ_DECODE_GROUP
              # default), so that card memory stays bounded for any list


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        "mozjpeg_tpu_torch: %s is not ported yet (ROADMAP.md queue 1 item "
        "%s)" % (what, item))


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def _flatten_decode_tables(tables):
    """{idx: HuffTable} -> contiguous mincode/maxcode/valptr/vals arrays
    for the native decoders."""
    mincode = np.zeros((4, 17), dtype=np.int32)
    maxcode = np.full((4, 18), -1, dtype=np.int64)
    valptr = np.zeros((4, 17), dtype=np.int32)
    vals = np.zeros((4, 256), dtype=np.uint8)
    for idx, tbl in tables.items():
        mn, mx, vp, vl = derive_decode_table(tbl)
        mincode[idx] = mn
        maxcode[idx] = mx
        valptr[idx] = vp
        vals[idx, :len(vl)] = vl
    return mincode, maxcode, valptr, vals


def _comp_qtable(jp: marker.ParsedJpeg, ci: int) -> np.ndarray:
    """The quant table of component ci as latched at its FIRST scan
    (jdinput.c latch_quant_tables): a DQT redefined between scans applies
    only to components not yet scanned."""
    c = jp.components[ci]
    for si, scan in enumerate(jp.scans):
        if ci in scan.comp_indices:
            t = jp.scan_qtables[si].get(c.quant_tbl)
            if t is not None:
                return t
            break
    return jp.scan_qtables[0].get(
        c.quant_tbl, jp.qtables.get(c.quant_tbl))


def decode_coefficients(jp: marker.ParsedJpeg, data: bytes, planes=None):
    """Entropy-decode all Huffman-coded scans -> list of (bh_pad, bw_pad,
    64) int16 zigzag planes (MCU-padded dims). planes: continue into these
    arrays (BufferedImage's incremental passes) instead of fresh zeros.

    Side effects on jp (read by block smoothing): jp.coef_bits /
    jp.coef_bits_prev, the progression status (jdphuff.c:126-144);
    jp.last_good_imcu_row, the last input iMCU row decoded with enough
    data (jdcoefct.c:233-234); jp.warnings, the corrupt-data warning
    count of this call."""
    marker.validate_decodable(jp)
    nat = lib()
    max_h, max_v = jp.max_h, jp.max_v
    mcus_x = -(-jp.width // (8 * max_h))
    mcus_y = -(-jp.height // (8 * max_v))
    if planes is None:
        planes = [np.zeros((mcus_y * c.v, mcus_x * c.h, 64),
                           dtype=np.int16) for c in jp.components]
    buf = np.frombuffer(data, dtype=np.uint8)

    ncomps = len(jp.components)
    cb_cur = np.full((ncomps, 64), -1, dtype=np.int32)
    cb_prev = np.full((ncomps, 64), -1, dtype=np.int32)
    last_good = mcus_y - 1
    # one warning counter per call: the library's global one is shared by
    # concurrent decodes (decode_many) and cannot be read per image
    warn_buf = np.zeros(1, dtype=np.int64)

    def decode_one(si, scan, lg_out):
        htables = jp.scan_htables[si]
        restart = jp.scan_restart[si]
        dmn, dmx, dvp, dvl = _flatten_decode_tables(
            {i: t for (cls, i), t in htables.items() if cls == 0})
        amn, amx, avp, avl = _flatten_decode_tables(
            {i: t for (cls, i), t in htables.items() if cls == 1})
        dc_tabs = (_ptr(dmn, i32p), _ptr(dmx, i64p), _ptr(dvp, i32p),
                   _ptr(dvl, u8p))
        ac_tabs = (_ptr(amn, i32p), _ptr(amx, i64p), _ptr(avp, i32p),
                   _ptr(avl, u8p))
        seg = np.ascontiguousarray(buf[scan.data_start:scan.data_end])
        seg_len = scan.data_end - scan.data_start

        interleaved = len(scan.comp_indices) > 1
        arr = (CompPlane * len(scan.comp_indices))()
        for i, ci in enumerate(scan.comp_indices):
            c = jp.components[ci]
            p = planes[ci]
            arr[i].coef = p.ctypes.data
            if interleaved:
                arr[i].bw, arr[i].bh = p.shape[1], p.shape[0]
                arr[i].h, arr[i].v = c.h, c.v
            else:
                cw = -(-jp.width * c.h // max_h)
                ch = -(-jp.height * c.v // max_v)
                arr[i].bw, arr[i].bh = -(-cw // 8), -(-ch // 8)
                arr[i].h, arr[i].v = 1, 1
            arr[i].stride = p.shape[1]
            arr[i].dc_tbl = scan.dc_tbls[ci]
            arr[i].ac_tbl = scan.ac_tbls[ci]
        if interleaved:
            smx, smy = mcus_x, mcus_y
        else:
            smx, smy = arr[0].bw, arr[0].bh
        ns = len(scan.comp_indices)
        seg_p, lg_p, warn_p = _ptr(seg, u8p), _ptr(lg_out, i32p), \
            _ptr(warn_buf, i64p)

        if not jp.progressive:
            r = -2
            nseg = (smx * smy + restart - 1) // restart if restart else 1
            if restart and nseg >= 4:
                # restart segments decode concurrently; any corruption or
                # structural surprise falls back to the serial
                # warn-and-resync path (the parallel attempt records no
                # warnings itself)
                nthreads = min(8, os.cpu_count() or 1, nseg)
                r = nat.mj_decode_seq_par(
                    seg_p, seg_len, arr, ns, smx, smy, restart,
                    *dc_tabs, *ac_tabs, lg_p, nthreads, warn_p)
                if r in (-2, -3):
                    # the serial decoder's truncation semantics assume
                    # pre-zeroed planes
                    for ci in scan.comp_indices:
                        planes[ci][:] = 0
            if r in (-2, -3):
                r = nat.mj_decode_seq(seg_p, seg_len, arr, ns, smx, smy,
                                      restart, *dc_tabs, *ac_tabs, lg_p,
                                      warn_p)
        elif scan.Ss == 0:
            if scan.Ah == 0:
                r = nat.mj_decode_dc_first(seg_p, seg_len, arr, ns, smx,
                                           smy, restart, scan.Al,
                                           *dc_tabs, lg_p, warn_p)
            else:
                r = nat.mj_decode_dc_refine(seg_p, seg_len, arr, ns, smx,
                                            smy, restart, scan.Al, lg_p,
                                            warn_p)
        else:
            fn = (nat.mj_decode_ac_first if scan.Ah == 0
                  else nat.mj_decode_ac_refine)
            r = fn(seg_p, seg_len, arr, scan.Ss, scan.Se, scan.Al, restart,
                   *ac_tabs, lg_p, warn_p)
        if r < 0:
            raise ValueError("corrupt scan %d" % si)
        # scan-local MCU row -> image iMCU row (jdcoefct consume_data)
        if interleaved:
            return int(lg_out[0])
        v = jp.components[scan.comp_indices[0]].v
        return min(int(lg_out[0]) // v, mcus_y - 1)

    # progression status bookkeeping is header-only (jdphuff.c:126-144)
    if jp.progressive:
        for si, scan in enumerate(jp.scans):
            for ci in scan.comp_indices:
                lo, hi = min(scan.Ss, 1), max(scan.Se, 9)
                cb_prev[ci, lo:hi + 1] = (cb_cur[ci, lo:hi + 1]
                                          if si > 0 else 0)
                cb_cur[ci, scan.Ss:scan.Se + 1] = scan.Al

    nscans = len(jp.scans)
    if jp.progressive and nscans > 2:
        # scans over disjoint (component, band) regions decode
        # concurrently; a scan waits for every earlier scan that overlaps
        # it. Entropy state is per scan, so the result does not depend on
        # the order (jdphuff.c keeps no cross-scan entropy state).
        def rng_of(scan):
            return (0, 0) if scan.Ss == 0 else (scan.Ss, scan.Se)

        deps = []
        for si, scan in enumerate(jp.scans):
            lo, hi = rng_of(scan)
            deps.append([sj for sj in range(si - 1, -1, -1)
                         if set(scan.comp_indices)
                         & set(jp.scans[sj].comp_indices)
                         and lo <= rng_of(jp.scans[sj])[1]
                         and rng_of(jp.scans[sj])[0] <= hi])
        futs = [None] * nscans

        def run(si):
            for sj in deps[si]:
                futs[sj].result()
            return decode_one(si, jp.scans[si], np.zeros(1, dtype=np.int32))

        with ThreadPoolExecutor(max_workers=min(8, nscans)) as ex:
            for si in range(nscans):
                futs[si] = ex.submit(run, si)
            lgs = [f.result() for f in futs]
        last_good = lgs[-1]
        if int(warn_buf[0]):
            # corrupt stream: the AC overrun clamp can write outside a
            # scan's band, which races between concurrent scans; redo
            # serially for djpeg's warn-and-resync result
            for pl in planes:
                pl[:] = 0
            warn_buf[0] = 0
            for si, scan in enumerate(jp.scans):
                last_good = decode_one(si, scan, np.zeros(1, dtype=np.int32))
    else:
        for si, scan in enumerate(jp.scans):
            last_good = decode_one(si, scan, np.zeros(1, dtype=np.int32))

    jp.coef_bits = cb_cur if jp.progressive else None
    jp.coef_bits_prev = cb_prev if jp.progressive else None
    jp.last_good_imcu_row = last_good
    jp.warnings = int(warn_buf[0])
    nat.mj_set_warnings(int(warn_buf[0]))   # for last_warnings()
    return planes


def last_warnings() -> int:
    """Corrupt-data warning count of the most recent Huffman decode
    (jerror num_warnings); jp.warnings is the per-stream count."""
    return int(lib().mj_get_warnings())


def _jpeg_colorspace(jp: marker.ParsedJpeg) -> str:
    """The JPEG colourspace (jdmaster.c default_decompress_parms): JFIF
    implies YCbCr; Adobe transform 0 -> RGB/CMYK, 1 -> YCbCr, 2 -> YCCK;
    otherwise a guess from the component IDs."""
    n = len(jp.components)
    if n == 1:
        return "grayscale"
    if n == 2:
        # libjpeg has no colour transform for 2 components
        raise ValueError("unsupported color conversion request "
                         "(2-component frame)")
    if n == 4:
        return "ycck" if jp.adobe_transform == 2 else "cmyk"
    if jp.adobe_transform is not None:
        return "rgb" if jp.adobe_transform == 0 else "ycbcr"
    if [c.cid for c in jp.components] == [0x52, 0x47, 0x42]:
        return "rgb"
    return "ycbcr"


def _check_slice(jp: marker.ParsedJpeg):
    """Refuse what this slice does not carry, naming the ROADMAP.md item
    (queue 1) that brings it; malformed streams raise ValueError first,
    as in the JAX package (a 2-component frame among them)."""
    if jp.lossless:
        _not_ported("lossless (SOF3) decode", "6.10")
    marker.validate_decodable(jp)
    if jp.precision != 8:
        _not_ported("%d-bit decode" % jp.precision, "6.2")
    _jpeg_colorspace(jp)


def _entropy(jp: marker.ParsedJpeg, data: bytes) -> List[np.ndarray]:
    """The coefficient planes of a Huffman or an arithmetic-coded
    stream."""
    if jp.arithmetic:
        return arith.decode_coefficients_arith(jp, data)
    return decode_coefficients(jp, data)


def _upsample_mode(jp, fancy=True, comp=1):
    """(mode, hexp, vexp) per jdsample.c:448-530 at full size, for the
    given component (each component upsamples on its own)."""
    c1 = jp.components[comp]
    hexp = jp.max_h // c1.h
    vexp = jp.max_v // c1.v
    if (hexp, vexp) == (1, 1):
        return "none", 1, 1
    if (hexp, vexp) == (2, 2) and fancy:
        return "h2v2", 2, 2
    if (hexp, vexp) == (2, 1) and fancy:
        return "h2v1", 2, 1
    if (hexp, vexp) == (1, 2) and fancy:
        return "h1v2", 1, 2
    return "int", hexp, vexp


def _comp_dims(jp, c) -> Tuple[int, int, int, int]:
    """(bh, bw, ch, cw): a component's blocks and samples, unpadded."""
    cw = -(-jp.width * c.h // jp.max_h)
    ch = -(-jp.height * c.v // jp.max_v)
    return -(-ch // 8), -(-cw // 8), ch, cw


def _smoothing_active(jp, block_smoothing: bool) -> bool:
    return (block_smoothing and jp.coef_bits is not None
            and smooth.smoothing_ok(jp, jp.coef_bits))


def _smooth_latches(jp):
    """coef_bits latches for block smoothing (smoothing_ok,
    jdcoefct.c:373-420): current = this scan's coef_bits; previous = the
    prior scan's, or -1 when only one scan was started."""
    n = len(jp.components)
    cur = np.asarray(jp.coef_bits)[:, :10].copy()
    prev = np.full((n, 10), -1, dtype=np.int32)
    if len(jp.scans) > 1:
        prev[:, 1:10] = np.asarray(jp.coef_bits_prev)[:, 1:10]
    prev[:, 0] = cur[:, 0]
    return cur, prev


def _maybe_smooth(jp, planes, block_smoothing: bool,
                  ncomps: Optional[int] = None):
    """Per-component (bh, bw, 64) planes of the first `ncomps` components
    (all by default): int16 views of the decoded planes, or int32
    smoothed copies (the estimates need not fit int16)."""
    use = _smoothing_active(jp, block_smoothing)
    if use:
        cur, prev = _smooth_latches(jp)
        mcus_y = -(-jp.height // (8 * jp.max_v))
    out = []
    for ci, c in enumerate(jp.components[:ncomps]):
        bh, bw, _, _ = _comp_dims(jp, c)
        if use:
            out.append(smooth.smooth_component(
                planes[ci], bh, bw, c.v, mcus_y, _comp_qtable(jp, ci),
                cur[ci], prev[ci], jp.last_good_imcu_row))
        else:
            out.append(planes[ci][:bh, :bw])
    return out


def _dct_table(jp, ci: int, dct_method: str) -> np.ndarray:
    """Component ci's table for the IDCT: the quant table (islow), or the
    ifast or float multipliers built from it (jddctmgr.c)."""
    qt = _comp_qtable(jp, ci)
    if dct_method == "ifast":
        return dct.ifast_multipliers(qt)
    if dct_method == "float":
        return dct.float_multipliers(qt)
    return qt.astype(np.int32)


def render_planes(zz: torch.Tensor, qt: torch.Tensor, ch: int, cw: int,
                  dct_method: str = "islow") -> torch.Tensor:
    """(B, bh, bw, 64) zigzag coefficients + (B, 8, 8) natural-order
    tables (_dct_table) -> (B, ch, cw) uint8 samples (the JAX
    _render_plane, vmapped). Each image's table broadcasts over its
    blocks as (B, 1, 1, 8, 8). Any dct_method but ifast and float is
    islow, as there."""
    blocks = layout.from_zigzag(zz)
    qt = qt[:, None, None]
    if dct_method == "ifast":
        pix = dct.idct_ifast(blocks, qt)
    elif dct_method == "float":
        pix = dct.idct_float(blocks, qt)
    else:
        pix = dct.idct_islow(blocks, qt, dct.PASS1_BITS, 8)
    return layout.unblockify(pix)[:, :ch, :cw]


def _up(pl, mode: str, hexp: int, vexp: int):
    if mode == "h2v2":
        return sample.upsample_h2v2_fancy(pl)
    if mode == "h2v1":
        return sample.upsample_h2v1_fancy(pl)
    if mode == "h1v2":
        return sample.upsample_h1v2_fancy(pl)
    if mode == "int":
        # replicate (jdsample.c int_upsample); also the -nosmooth box filter
        return sample.upsample_replicate(pl, hexp, vexp)
    return pl


def upsample_color(y, cb, cr, mode: str, height: int, width: int,
                   hexp: int = 1, vexp: int = 1) -> torch.Tensor:
    """(..., H, W) uint8 Y, Cb, Cr sample planes -> (..., height, width,
    3) uint8 RGB (the JAX _upsample_color)."""
    ycc = torch.stack([y[..., :height, :width],
                       _up(cb, mode, hexp, vexp)[..., :height, :width],
                       _up(cr, mode, hexp, vexp)[..., :height, :width]],
                      dim=-1)
    return color.ycc_to_rgb(ycc)


def upsample_ycck(y, cb, cr, k, mode: str, height: int, width: int,
                  hexp: int = 1, vexp: int = 1, kmode: str = "none",
                  khexp: int = 1, kvexp: int = 1) -> torch.Tensor:
    """(H, W) uint8 Y, Cb, Cr, K sample planes -> (height, width, 4) uint8
    CMYK (the JAX _upsample_ycck); K upsamples on its own mode."""
    ycck = torch.stack([y[..., :height, :width],
                        _up(cb, mode, hexp, vexp)[..., :height, :width],
                        _up(cr, mode, hexp, vexp)[..., :height, :width],
                        _up(k, kmode, khexp, kvexp)[..., :height, :width]],
                       dim=-1)
    return color.ycck_to_cmyk(ycck)


def _to_device(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _render_comp(jp, plane, ci: int, dct_method: str, dev) -> torch.Tensor:
    """One component's (bh, bw, 64) coefficients -> its (ch, cw) uint8
    samples on dev."""
    _, _, ch, cw = _comp_dims(jp, jp.components[ci])
    return render_planes(_to_device(plane[None], dev),
                         _to_device(_dct_table(jp, ci, dct_method)[None],
                                    dev), ch, cw, dct_method)[0]


def _convert(jp, samples, cs: str, fancy_upsample: bool,
             width: int) -> torch.Tensor:
    """Per-component sample planes -> pixels `width` wide (the image's,
    or a crop's): gray (H, W), RGB (H, W, 3), or CMYK (H, W, 4); RGB and
    CMYK are the null conversion of the stored components."""
    h = jp.height
    if cs == "grayscale":
        return samples[0][:h, :width]
    if cs in ("rgb", "cmyk"):
        out = [p[:h, :width] for p in samples]
        if any(o.shape != out[0].shape for o in out):
            # the JAX package stacks the planes unupsampled (np.stack)
            raise ValueError("all input arrays must have the same shape")
        return torch.stack(out, dim=-1)
    mode, hexp, vexp = _upsample_mode(jp, fancy_upsample)
    if cs == "ycck":
        y, cb, cr, k = samples
        kmode, khexp, kvexp = _upsample_mode(jp, fancy_upsample, comp=3)
        return upsample_ycck(y, cb, cr, k, mode, h, width, hexp, vexp,
                             kmode, khexp, kvexp)
    return upsample_color(*samples[:3], mode, h, width, hexp, vexp)


def _render_t(jp, planes, colorspace, fancy_upsample, dct_method,
              block_smoothing, dev) -> torch.Tensor:
    smoothed = _maybe_smooth(jp, planes, block_smoothing)
    samples = [_render_comp(jp, smoothed[ci], ci, dct_method, dev)
               for ci in range(len(jp.components))]
    return _convert(jp, samples, colorspace or _jpeg_colorspace(jp),
                    fancy_upsample, jp.width)


def render(jp: marker.ParsedJpeg, planes: List[np.ndarray],
           colorspace: Optional[str] = None, fancy_upsample: bool = True,
           dct_method: str = "islow", block_smoothing: bool = True,
           device=None) -> np.ndarray:
    """Coefficient planes -> pixels on `device`: RGB (H, W, 3), gray
    (H, W), or CMYK (H, W, 4) for 4-component streams (the device branch
    of the JAX package's render: block smoothing on the host, then every
    component's IDCT, the upsampling and the colour conversion on the
    device)."""
    return _render_t(jp, planes, colorspace, fancy_upsample, dct_method,
                     block_smoothing, _device(device)).cpu().numpy()


def decode_raw_planes_parsed(jp: marker.ParsedJpeg, planes,
                             device=None) -> List[np.ndarray]:
    """jpeg_read_raw_data render: per-component (ph, pw) uint8 sample
    planes at sampling-grid-padded dims, decoded samples out to the last
    block's edge and zeros past it; no smoothing, upsampling or colour."""
    dev = _device(device)
    pw0 = -(-jp.width // jp.max_h) * jp.max_h
    ph0 = -(-jp.height // jp.max_v) * jp.max_v
    out = []
    for ci, c in enumerate(jp.components):
        pw = pw0 * c.h // jp.max_h
        ph = ph0 * c.v // jp.max_v
        bh, bw, _, _ = _comp_dims(jp, c)
        qt = _comp_qtable(jp, ci).astype(np.int32)
        pl = render_planes(_to_device(planes[ci][None, :bh, :bw], dev),
                           _to_device(qt[None], dev), min(ph, bh * 8),
                           min(pw, bw * 8))[0].cpu().numpy()
        full = np.zeros((ph, pw), np.uint8)
        full[:pl.shape[0], :pl.shape[1]] = pl
        out.append(full)
    return out


def decode_raw_planes(data: bytes, device=None):
    """jpeg_read_raw_data (jdapistd.c, raw_data_out; mozjpeg_tpu
    decode_raw_planes): -> (planes, width, height, samp), planes[i] the
    (ph, pw) uint8 samples of component i at sampling-grid-padded dims,
    samp the (h, v) factors; no upsampling or colour conversion."""
    dev = _device(device)
    jp = marker.parse(data)
    _check_slice(jp)
    planes = decode_raw_planes_parsed(jp, _entropy(jp, data), dev)
    return (planes, jp.width, jp.height,
            [(c.h, c.v) for c in jp.components])


def decode(data: bytes, fancy_upsample: bool = True,
           dct_method: str = "islow", block_smoothing: bool = True,
           device=None) -> np.ndarray:
    """Decode a JPEG byte stream to RGB (H, W, 3), grayscale (H, W) or
    CMYK (H, W, 4) uint8, pixel-identical to mozjpeg_tpu.decode, whose
    positional order it keeps. device: None or "cuda" (the default, the
    GPU; raises without one) or "cpu".

    fancy_upsample=False is djpeg -nosmooth's replicating upsample (pass
    block_smoothing=False too for all of -nosmooth); dct_method "ifast"
    and "float" are djpeg -dct fast and -dct float. Truncated progressive
    streams render like djpeg: missing data leaves coefficients at their
    last decoded state and block smoothing estimates the rest."""
    dev = _device(device)
    jp = marker.parse(data)
    _check_slice(jp)
    planes = _entropy(jp, data)
    return render(jp, planes, None, fancy_upsample, dct_method,
                  block_smoothing, dev)


def decode_grayscale(data: bytes, fancy_upsample: bool = True,
                     block_smoothing: bool = True,
                     device=None) -> np.ndarray:
    """djpeg -grayscale (mozjpeg_tpu decode_grayscale): YCbCr and gray
    sources render component 0 alone (jdcolor.c's null conversion; the
    chroma is not even transformed), RGB sources take the fixed-point Y
    of rgb_gray_convert; other colour spaces raise ValueError."""
    dev = _device(device)
    jp = marker.parse(data)
    _check_slice(jp)
    planes = _entropy(jp, data)
    cs = _jpeg_colorspace(jp)
    if cs == "rgb":
        return color.rgb_to_gray(_render_t(
            jp, planes, None, fancy_upsample, "islow", block_smoothing,
            dev)).cpu().numpy()
    if cs not in ("grayscale", "ycbcr"):
        raise ValueError("cannot convert %s to grayscale" % cs)
    y = _maybe_smooth(jp, planes, block_smoothing, 1)[0]
    return _render_comp(jp, y, 0, "islow", dev)[:jp.height, :jp.width] \
        .cpu().numpy()


def render_plane_scaled(zz: torch.Tensor, qt: torch.Tensor, ch: int,
                        cw: int, size: int) -> torch.Tensor:
    """(..., bh, bw, 64) zigzag coefficients + a broadcastable (8, 8)
    natural-order quant table -> (..., ch, cw) uint8 samples from the
    size x size scaled IDCT, size 1..16 (the JAX _render_plane_scaled:
    jidctred.c at 1, 2 and 4, islow at 8, jidctint.c elsewhere)."""
    blocks = layout.from_zigzag(zz.to(torch.int32))
    if size == 8:
        pix = dct.idct_islow(blocks, qt)
    elif size == 4:
        pix = idct_scaled.idct_4x4(blocks, qt)
    elif size == 2:
        pix = idct_scaled.idct_2x2(blocks, qt)
    elif size == 1:
        pix = idct_scaled.idct_1x1(blocks, qt)
    elif size in idct_scaled._REDUCED:
        pix = idct_scaled.idct_reduced(blocks, qt, size)
    else:
        pix = idct_scaled.idct_expanded(blocks, qt, size)
    return layout.unblockify(pix)[..., :ch, :cw]


# the JAX package's scaled upsampler names -> _up's
_SCALED_MODES = {"fancy_h2v2": "h2v2", "fancy_h2v1": "h2v1",
                 "fancy_h1v2": "h1v2", "int": "int"}


def upsample_plane_scaled(pl: torch.Tensor, mode: str, hexp: int,
                          vexp: int) -> torch.Tensor:
    """One component's samples through the upsampler decode_scaled chose
    ("fancy_h2v2", "fancy_h2v1", "fancy_h1v2", "int" or "none"; the JAX
    _upsample_plane_scaled)."""
    return _up(pl, _SCALED_MODES.get(mode, "none"), hexp, vexp)


def _scaled_upsampler(jp, c, ssize: int, min_size: int, fancy: bool,
                      down_w: int):
    """(mode, hexp, vexp) of jdsample.c:448-530 for a component whose
    IDCT runs at ssize when the output is at min_size/8."""
    max_h, max_v = jp.max_h, jp.max_v
    h_in = c.h * ssize // min_size
    v_in = c.v * ssize // min_size
    if h_in == max_h and v_in == max_v:
        return "none", 1, 1
    if h_in * 2 == max_h and v_in == max_v:
        return ("fancy_h2v1" if fancy and down_w > 2 else "int"), 2, 1
    if h_in == max_h and v_in * 2 == max_v and fancy:
        return "fancy_h1v2", 1, 1
    if h_in * 2 == max_h and v_in * 2 == max_v:
        return ("fancy_h2v2" if fancy and down_w > 2 else "int"), 2, 2
    if max_h % h_in == 0 and max_v % v_in == 0:
        return "int", max_h // h_in, max_v // v_in
    raise NotImplementedError("fractional upsampling")


def decode_scaled(data: bytes, num: int, den: int,
                  fancy_upsample: bool = True, block_smoothing: bool = True,
                  colorspace: Optional[str] = None,
                  device=None) -> np.ndarray:
    """Scaled decode (djpeg -scale num/den; mozjpeg_tpu decode_scaled):
    the output is min_size/8 of the image, min_size the least M in 1..16
    with num/den <= M/8; above 2/1 raises ValueError. Each component's
    IDCT runs at min_size, doubled while the sampling allows and below 8
    (jdmaster.c:289-296), then jdsample.c's upsampler for what is left
    (fancy upsampling off at 1/8, and at h2 only on planes over 2 samples
    wide); the IDCTs, the upsampling and the colour conversion run on
    `device` (None or "cuda", the default, the GPU; or "cpu")."""
    dev = _device(device)
    jp = marker.parse(data)
    min_size = next((sz for sz in range(1, 17) if num * 8 <= den * sz),
                    None)
    if min_size is None:
        raise ValueError("scale %d/%d > 2 not supported" % (num, den))
    _check_slice(jp)
    return render_scaled_t(jp, _entropy(jp, data), min_size, fancy_upsample,
                           block_smoothing, colorspace, dev).cpu().numpy()


def render_scaled_t(jp, planes, min_size: int, fancy_upsample: bool,
                    block_smoothing: bool, colorspace: Optional[str],
                    dev) -> torch.Tensor:
    """decode_scaled's device half: coefficient planes -> the pixels at
    min_size/8 on dev (smoothing on the host, upload, the scaled IDCTs,
    upsampling and colour conversion on dev)."""
    out_w = -(-jp.width * min_size // 8)
    out_h = -(-jp.height * min_size // 8)
    max_h, max_v = jp.max_h, jp.max_v
    smoothed = _maybe_smooth(jp, planes, block_smoothing)
    fancy = fancy_upsample and min_size > 1   # jdsample.c:444
    samples = []
    for ci, c in enumerate(jp.components):
        ssize = min_size
        while (ssize < 8
               and (max_h * min_size) % (c.h * ssize * 2) == 0
               and (max_v * min_size) % (c.v * ssize * 2) == 0):
            ssize *= 2
        down_w = -(-jp.width * c.h * ssize // (max_h * 8))
        down_h = -(-jp.height * c.v * ssize // (max_v * 8))
        pl = render_plane_scaled(
            _to_device(smoothed[ci], dev),
            _to_device(_comp_qtable(jp, ci).astype(np.int32), dev),
            down_h, down_w, ssize)
        mode, hexp, vexp = _scaled_upsampler(jp, c, ssize, min_size, fancy,
                                             down_w)
        samples.append(upsample_plane_scaled(pl, mode, hexp, vexp))
    cs = colorspace or _jpeg_colorspace(jp)
    if cs == "grayscale":
        out = samples[0][:out_h, :out_w]
    elif cs in ("rgb", "cmyk"):
        out = [p[:out_h, :out_w] for p in samples]
        if any(o.shape != out[0].shape for o in out):
            # the JAX package stacks the planes as they are (np.stack)
            raise ValueError("all input arrays must have the same shape")
        out = torch.stack(out, dim=-1)
    elif cs == "ycck":
        out = upsample_ycck(*samples[:4], "none", out_h, out_w)
    else:
        out = upsample_color(*samples[:3], "none", out_h, out_w)
    return out


# byte c % 4 of jdcolor.c:617-625's dither_matrix[r % 4]
_DITHER_565 = np.array([
    [0x0A, 0x02, 0x08, 0x00],
    [0x06, 0x0E, 0x04, 0x0C],
    [0x09, 0x01, 0x0B, 0x03],
    [0x05, 0x0D, 0x07, 0x0F]], np.int32)


def _pack_565(r, g, b) -> torch.Tensor:
    r, g, b = (torch.clamp(v, 0, 255) for v in (r, g, b))
    return ((r << 8) & 0xF800) | ((g << 3) & 0x7E0) | (b >> 3)


def decode_rgb565(data: bytes, fancy_upsample: bool = True,
                  dither: bool = True, device=None) -> np.ndarray:
    """Decode to packed little-endian RGB565, (H, W) uint16 (jdcol565.c
    ycc_rgb565[D]_convert with the 4x4 ordered dither of
    jdcolor.c:617-625; mozjpeg_tpu decode_rgb565). The dither adds d to R
    and B and d >> 1 to G, d indexed by row % 4 and column % 4; a gray
    stream packs one dithered value into all three fields
    (gray_rgb565D). YCbCr and gray streams only, else ValueError. The
    IDCT, upsampling, YCbCr -> RGB and the pack run in int32 on `device`;
    the cast to uint16 is on the host."""
    dev = _device(device)
    jp = marker.parse(data)
    _check_slice(jp)
    planes = _entropy(jp, data)
    cs = _jpeg_colorspace(jp)
    if cs not in ("ycbcr", "grayscale"):
        raise ValueError("RGB565 output requires YCbCr or grayscale")
    smoothed = _maybe_smooth(jp, planes, True)
    comps = [_render_comp(jp, smoothed[ci], ci, "islow", dev)
             for ci in range(len(jp.components))]
    h, w = jp.height, jp.width
    y = comps[0][:h, :w].to(torch.int32)
    d = (torch.as_tensor(_DITHER_565, device=dev)
         .repeat(-(-h // 4), -(-w // 4))[:h, :w] if dither else 0)
    if cs == "grayscale":
        g = y + d
        out = _pack_565(g, g, g)
    else:
        mode, hexp, vexp = _upsample_mode(jp, fancy_upsample)
        cb, cr = (_up(p, mode, hexp, vexp)[:h, :w].to(torch.int32) - 128
                  for p in comps[1:3])
        r = y + ((color.FIX_1_40200 * cr + color.ONE_HALF)
                 >> color.SCALEBITS)
        b = y + ((color.FIX_1_77200 * cb + color.ONE_HALF)
                 >> color.SCALEBITS)
        g = y + ((-color.FIX_0_34414 * cb - color.FIX_0_71414 * cr
                  + color.ONE_HALF) >> color.SCALEBITS)
        out = _pack_565(r + d, g + (d >> 1), b + d)
    return out.cpu().numpy().astype(np.uint16)


def quantize_colors(rgb: np.ndarray, ncolors: int, dither: str = "fs",
                    two_pass: bool = True):
    """djpeg -colors N on the host (mozjpeg_tpu quantize_colors) ->
    (indices (H, W) uint8, colormap (n, 3) uint8). two_pass is jquant2
    (median cut, FS dither or none; ordered falls back to FS as in the
    reference; below 8 colours raises ValueError); otherwise jquant1's
    fixed orthogonal palette with none, ordered or FS dithering, on gray
    (H, W) input too."""
    if two_pass and ncolors < 8:
        # jinit_2pass_quantizer's lower bound (jquant2.c)
        raise ValueError("cannot quantize to fewer than 8 colors")
    nat = lib()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    gray = rgb.ndim == 2
    if gray and two_pass:
        rgb = np.ascontiguousarray(np.stack([rgb] * 3, axis=-1))
        gray = False
    h, w = rgb.shape[:2]
    idx = np.empty((h, w), np.uint8)
    cmap = np.empty(3 * 256, np.uint8)
    if two_pass:
        n = nat.mj_quantize_colors(
            _ptr(rgb, u8p), w, h, ncolors,
            0 if dither in ("none", None) else 1, _ptr(idx, u8p),
            _ptr(cmap, u8p))
    else:
        dmode = {"none": 0, None: 0, "ordered": 1, "fs": 2}[dither]
        n = nat.mj_quantize_onepass(
            _ptr(rgb, u8p), w, h, ncolors, dmode, 1 if gray else 0,
            _ptr(idx, u8p), _ptr(cmap, u8p))
    if n < 0:
        raise ValueError("quantize_colors failed (need 1..256 colors)")
    return idx, np.stack([cmap[:256], cmap[256:512], cmap[512:]],
                         axis=-1)[:n]


def read_color_map(data: bytes) -> np.ndarray:
    """djpeg -map FILE (rdcolmap.c): the palette of a GIF's global
    colormap or of the pixels of a maxval-255 PPM (P3 or P6), without
    repeats, in order of first appearance -> (n, 3) uint8; at most 256
    colours, and anything else raises ValueError."""
    if not data:
        raise ValueError("bad colormap file")
    out: list = []
    seen = set()

    def add(r, g, b):
        if (r, g, b) not in seen:
            if len(out) >= 256:
                raise ValueError("too many colors in map file")
            seen.add((r, g, b))
            out.append((r, g, b))

    if data[0] == 0x47:                       # GIF
        if len(data) < 13 or data[:3] != b"GIF":
            raise ValueError("bad colormap file")
        flags = data[10]
        if not flags & 0x80:
            raise ValueError("bad colormap file")
        n = 2 << (flags & 7)
        pal = data[13:13 + 3 * n]
        for i in range(n):
            add(pal[3 * i], pal[3 * i + 1], pal[3 * i + 2])
    elif data[0] == 0x50:                     # PPM
        m = re.match(rb"P([36])\s+(?:#[^\n]*\n\s*)*(\d+)\s+(\d+)\s+"
                     rb"(\d+)\s", data)
        if not m:
            raise ValueError("bad colormap file")
        fmt, w, h, maxval = (int(m.group(i)) for i in range(1, 5))
        if maxval != 255:
            raise ValueError("bad colormap file")
        if fmt == 6:
            px = np.frombuffer(data[m.end():m.end() + w * h * 3], np.uint8)
        else:
            px = np.array(data[m.end():].split()[:w * h * 3], np.uint8)
        for r, g, b in px.reshape(-1, 3):
            add(int(r), int(g), int(b))
    else:
        raise ValueError("bad colormap file")
    return np.array(out, np.uint8)


def quantize_to_map(rgb: np.ndarray, cmap: np.ndarray, dither: str = "fs"):
    """djpeg -map on the host (mozjpeg_tpu quantize_to_map): jquant2's
    pass 2 with a supplied palette (ordered dithering falls back to FS,
    as in the reference) -> (indices (H, W) uint8, colormap)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim == 2:
        rgb = np.ascontiguousarray(np.stack([rgb] * 3, axis=-1))
    h, w = rgb.shape[:2]
    idx = np.empty((h, w), np.uint8)
    cm = np.ascontiguousarray(cmap, np.uint8)
    r = lib().mj_quantize_to_map(
        _ptr(rgb, u8p), w, h, _ptr(cm, u8p), len(cm),
        0 if dither in ("none", None) else 1, _ptr(idx, u8p))
    if r < 0:
        raise ValueError("quantize_to_map failed")
    return idx, cm


def decode_cropped(data: bytes, x: int, w: int, fancy_upsample: bool = True,
                   block_smoothing: bool = True,
                   colorspace: Optional[str] = None, device=None):
    """Partial-width decode (mozjpeg_tpu decode_cropped, jpeg_crop_scanline
    jdapistd.c:186-300) -> (pixels, aligned_x, aligned_w). x aligns down
    to an iMCU column, the width grows left to make up for it, and the
    upsampling runs over the region with the image-edge semantics at both
    of its borders; callers slice rows themselves."""
    dev = _device(device)
    jp = marker.parse(data)
    _check_slice(jp)
    planes = _entropy(jp, data)
    ncomps = len(jp.components)
    align = 8 if ncomps == 1 else 8 * jp.max_h
    if w == 0 or x + w > jp.width:
        raise ValueError("bad crop width")
    if w == jp.width:
        return render(jp, planes, colorspace, fancy_upsample, "islow",
                      block_smoothing, dev), 0, jp.width
    ax = (x // align) * align
    w2 = w + x - ax
    smoothed = _maybe_smooth(jp, planes, block_smoothing)
    slices = []
    for ci, c in enumerate(jp.components):
        hsf = 1 if ncomps == 1 else c.h
        start = ax * hsf // align * 8
        dw = -(-w2 * c.h // jp.max_h) if ncomps > 1 else w2
        slices.append(_render_comp(jp, smoothed[ci], ci, "islow",
                                   dev)[:, start:start + dw])
    pix = _convert(jp, slices, colorspace or _jpeg_colorspace(jp),
                   fancy_upsample, w2)
    return pix.cpu().numpy(), ax, w2


def _truncated(data: bytes, nscans: int) -> marker.ParsedJpeg:
    """The stream parsed with its scans after the first nscans dropped."""
    jp = marker.parse(data)
    for attr in ("scans", "scan_htables", "scan_restart", "scan_qtables",
                 "scan_arith_cond"):
        setattr(jp, attr, getattr(jp, attr)[:nscans])
    return jp


class BufferedImage:
    """Buffered-image decode (mozjpeg_tpu BufferedImage,
    jpeg_start_output / jpeg_finish_output): the image as of each
    completed input scan. Pass k shows the coefficients after scans 1..k,
    with block smoothing estimating the ones not yet received, as a
    progressive viewer does. device: None or "cuda" (the default, the
    GPU; raises without one) or "cpu"."""

    def __init__(self, data: bytes, fancy_upsample: bool = True,
                 block_smoothing: bool = True, dct_method: str = "islow",
                 device=None):
        self._dev = _device(device)
        self._data = data
        self._jp = marker.parse(data)
        _check_slice(self._jp)
        self._fancy = fancy_upsample
        self._smooth = block_smoothing
        self._dct = dct_method

    @property
    def num_scans(self) -> int:
        return len(self._jp.scans)

    @property
    def progressive(self) -> bool:
        return self._jp.progressive

    def _render(self, jp, planes) -> np.ndarray:
        return render(jp, planes, None, self._fancy, self._dct,
                      self._smooth, self._dev)

    def render_pass(self, nscans: int) -> np.ndarray:
        """The image after the first nscans scans (1-based), entropy-
        decoded afresh."""
        if not 1 <= nscans <= len(self._jp.scans):
            raise ValueError("pass out of range")
        jp = _truncated(self._data, nscans)
        return self._render(jp, _entropy(jp, self._data))

    def __iter__(self):
        """Every pass in order. Each scan is entropy-decoded once into
        persistent coefficient planes (the jpeg_consume_input model);
        arithmetic streams decode scans 1..k afresh for each pass, as in
        the JAX package (its adaptive coder state is not kept between
        scans)."""
        jp0 = marker.parse(self._data)
        n = len(jp0.scans)
        if jp0.arithmetic:
            for k in range(1, n + 1):
                yield self.render_pass(k)
            return
        planes = None
        ncomps = len(jp0.components)
        cb_cur = np.full((ncomps, 64), -1, dtype=np.int32)
        cb_prev = np.full((ncomps, 64), -1, dtype=np.int32)
        warnings = 0
        for k in range(1, n + 1):
            jpk = marker.parse(self._data)
            one = slice(k - 1, k)
            jpk.scans, jpk.scan_htables, jpk.scan_restart, \
                jpk.scan_qtables = (jp0.scans[one], jp0.scan_htables[one],
                                    jp0.scan_restart[one],
                                    jp0.scan_qtables[one])
            planes = decode_coefficients(jpk, self._data, planes=planes)
            warnings += jpk.warnings
            if jp0.progressive:
                # the progression status over scans 1..k
                # (jdphuff.c:126-144)
                scan = jp0.scans[k - 1]
                for ci in scan.comp_indices:
                    lo, hi = min(scan.Ss, 1), max(scan.Se, 9)
                    cb_prev[ci, lo:hi + 1] = (cb_cur[ci, lo:hi + 1]
                                              if k > 1 else 0)
                    cb_cur[ci, scan.Ss:scan.Se + 1] = scan.Al
            jpk.scans, jpk.scan_htables, jpk.scan_restart, \
                jpk.scan_qtables = (jp0.scans[:k], jp0.scan_htables[:k],
                                    jp0.scan_restart[:k],
                                    jp0.scan_qtables[:k])
            jpk.coef_bits = cb_cur if jp0.progressive else None
            jpk.coef_bits_prev = cb_prev if jp0.progressive else None
            jpk.warnings = warnings
            yield self._render(jpk, planes)


class GroupKey(NamedTuple):
    """What the images rendered in one batch share (decoder.py:1630)."""
    width: int
    height: int
    gray: bool
    mode: Optional[str]
    hexp: int
    vexp: int
    dims: tuple           # ((bh, bw, ch, cw) luma, (...) chroma)
    shapes: tuple         # the padded plane shapes


def group_key(jp, planes, fancy_upsample: bool = True,
              block_smoothing: bool = True) -> Optional[GroupKey]:
    """The batch an image joins, or None for the per-image render: a
    colour space other than YCbCr and gray, active block smoothing, or
    Cb/Cr planes that differ in geometry or quant table
    (decoder.py:1595-1629)."""
    cs = _jpeg_colorspace(jp)
    if cs not in ("ycbcr", "grayscale") or _smoothing_active(
            jp, block_smoothing):
        return None
    gray = cs == "grayscale"
    mode, hexp, vexp = ((None, 1, 1) if gray
                        else _upsample_mode(jp, fancy_upsample))
    dims = [_comp_dims(jp, c) for c in jp.components[:1 if gray else 3]]
    if gray:
        dims = [dims[0], (0, 0, 0, 0)]
    elif (dims[1] == dims[2]
          and np.array_equal(_comp_qtable(jp, 1), _comp_qtable(jp, 2))):
        dims = dims[:2]
    else:
        return None
    return GroupKey(jp.width, jp.height, gray, mode, hexp, vexp,
                    tuple(dims), tuple(p.shape for p in planes))


def render_ycc_batch(yzz, cbzz, crzz, qty, qtc, key: GroupKey):
    """Batched render (the JAX _render_ycc_batch): (B, bh, bw, 64) zigzag
    planes and (B, 8, 8) per-image quant tables on the device -> (B, H, W,
    3) uint8 RGB, or (B, H, W) gray. Cb and Cr render in one call; they
    share qtc because the group key guarantees it."""
    (lbh, lbw, lch, lcw), (cbh, cbw, cch, ccw) = key.dims
    py = render_planes(yzz, qty, lch, lcw)
    if key.gray:
        return py[:, :key.height, :key.width]
    b = yzz.shape[0]
    pc = render_planes(torch.cat([cbzz, crzz]), torch.cat([qtc, qtc]),
                       cch, ccw)
    return upsample_color(py, pc[:b], pc[b:], key.mode, key.height,
                          key.width, key.hexp, key.vexp)


def render_group(key: GroupKey, jps, planes_list, dev, times=None,
                 record=None) -> List[np.ndarray]:
    """Render same-key images in one batch: upload the int16 zigzag
    planes and int32 quant tables, render, download uint8. With `times`
    (dict) each stage is synchronised and timed; with `record` (dict)
    record["render_ycc_batch"] gets the device arguments of the render."""
    (lbh, lbw, _, _), (cbh, cbw, _, _) = key.dims
    with stage(times, "upload", dev):
        args = [_to_device(np.stack([p[0][:lbh, :lbw] for p in planes_list]),
                           dev)]
        if key.gray:
            args += [None, None]
        else:
            args += [_to_device(np.stack([p[ci][:cbh, :cbw]
                                          for p in planes_list]), dev)
                     for ci in (1, 2)]
        args.append(_to_device(np.stack(
            [_comp_qtable(jp, 0) for jp in jps]).astype(np.int32), dev))
        args.append(None if key.gray else _to_device(np.stack(
            [_comp_qtable(jp, 1) for jp in jps]).astype(np.int32), dev))
    if record is not None:
        record["render_ycc_batch"] = tuple(args) + (key,)
    with stage(times, "render", dev):
        res = render_ycc_batch(*args, key)
    with stage(times, "download", dev):
        res = res.cpu().numpy()
    return list(res)


def decode_many(datas, fancy_upsample: bool = True,
                block_smoothing: bool = True, output: str = "rgb",
                device=None) -> List:
    """Decode a list of JPEGs, pixel-identical to mozjpeg_tpu.decode_many.
    The host entropy decode (Huffman or arithmetic) runs on a thread
    pool; as soon as GROUP YCbCr or gray images of one geometry are ready
    they render in one batch on the device while the pool goes on; the
    others (RGB, CMYK, YCCK, active block smoothing) render one at a time
    on the device. output="rgb" gives (H, W, 3), gray (H, W) or CMYK
    (H, W, 4) uint8 per image; output="yuv" the per-component sample
    planes at jpeg_read_raw_data dims; output="rgb565" decode_rgb565's
    (H, W) uint16, one image at a time. device: None or "cuda" (the
    default, the GPU; raises without one) or "cpu"."""
    if output not in ("rgb", "yuv", "rgb565"):
        raise ValueError("output must be rgb, yuv or rgb565")
    dev = _device(device)
    if output == "rgb565":
        # per image, as in the JAX package
        return [decode_rgb565(d, fancy_upsample, device=dev) for d in datas]
    jps = [marker.parse(d) for d in datas]
    for jp in jps:
        _check_slice(jp)
    out: List = [None] * len(datas)
    planes_list: List = [None] * len(datas)
    nthreads = min(8, max(2, os.cpu_count() or 4))
    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        futs = [pool.submit(_entropy, jp, d) for jp, d in zip(jps, datas)]
        pending: dict = {}
        for i, f in enumerate(futs):
            planes_list[i] = f.result()
            if output == "yuv":
                out[i] = decode_raw_planes_parsed(jps[i], planes_list[i],
                                                  dev)
                continue
            key = group_key(jps[i], planes_list[i], fancy_upsample,
                            block_smoothing)
            if key is None:
                out[i] = render(jps[i], planes_list[i], None,
                                fancy_upsample, "islow", block_smoothing,
                                dev)
                continue
            pending.setdefault(key, []).append(i)
            if len(pending[key]) == GROUP:
                _render_into(out, key, pending.pop(key), jps, planes_list,
                             dev)
        for key, idxs in pending.items():
            _render_into(out, key, idxs, jps, planes_list, dev)
    return out


def _render_into(out, key, idxs, jps, planes_list, dev):
    res = render_group(key, [jps[i] for i in idxs],
                       [planes_list[i] for i in idxs], dev)
    for i, r in zip(idxs, res):
        out[i] = r
        planes_list[i] = None           # the coefficients are done with
