"""Decode: marker parse -> native Huffman decode on the host -> dequant +
islow IDCT, fancy upsampling and YCbCr -> RGB on a device.

Port of mozjpeg_tpu/codec/decoder.py, pixel-identical to
mozjpeg_tpu.decode and mozjpeg_tpu.decode_many (whose outputs are pinned
to djpeg). The host half is the shared C++ entropy decoder (entropy.cpp,
through the port's own library); the pixel half is PyTorch on the device
the caller names:

  decode       parse, entropy decode, then `render` (the device branch of
               the JAX package's render: block smoothing on the host,
               then each plane and the colour conversion on the device);
  decode_many  the JAX package's route for a locally attached device
               (merged_local): every stream is parsed, entropy-decoded on
               a thread pool, and the images of one geometry are rendered
               together, GROUP at a time (render_ycc_batch: upload the
               int16 zigzag planes and per-image quant tables, render,
               download uint8 RGB). Images with active block smoothing or
               Cb/Cr planes that differ in geometry or quant table go
               through `render` one at a time. output="yuv" returns the
               per-component sample planes (decode_raw_planes_parsed).

The slice is Huffman-coded 8-bit sequential and progressive streams,
YCbCr with three components or grayscale, any sampling, with restart
intervals, truncated and corrupt streams, fancy or replicating
upsampling and block smoothing. Other streams and options raise
NotImplementedError naming the ROADMAP.md item that brings them, as do
the JAX package's other decode entry points (decode_grayscale,
decode_scaled, decode_cropped, BufferedImage); none falls back to the CPU
or to another route.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..entropy.huffman import derive_decode_table
from ..native import CompPlane, i32p, i64p, lib, u8p
from ..ops import color, dct, layout, sample
from . import marker, smooth
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


def decode_coefficients(jp: marker.ParsedJpeg, data: bytes):
    """Entropy-decode all scans -> list of (bh_pad, bw_pad, 64) int16
    zigzag planes (MCU-padded dims).

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
    planes = [np.zeros((mcus_y * c.v, mcus_x * c.h, 64), dtype=np.int16)
              for c in jp.components]
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
    as in the JAX package."""
    if jp.lossless:
        _not_ported("lossless (SOF3) decode", "6.10")
    marker.validate_decodable(jp)
    if jp.arithmetic:
        _not_ported("arithmetic-coded decode", "6.9")
    if jp.precision != 8:
        _not_ported("%d-bit decode" % jp.precision, "6.2")
    cs = _jpeg_colorspace(jp)
    if cs not in ("ycbcr", "grayscale") or len(jp.components) > 3:
        _not_ported("decode of %d-component %s streams"
                    % (len(jp.components), cs.upper()), "6.1")


def _upsample_mode(jp, fancy=True, comp=1):
    """(mode, hexp, vexp) per jdsample.c:448-530 at full size, for the
    given component."""
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


def _maybe_smooth(jp, planes, block_smoothing: bool):
    """Per-component (bh, bw, 64) planes: int16 views of the decoded
    planes, or int32 smoothed copies (the estimates need not fit int16)."""
    use = _smoothing_active(jp, block_smoothing)
    if use:
        cur, prev = _smooth_latches(jp)
        mcus_y = -(-jp.height // (8 * jp.max_v))
    out = []
    for ci, c in enumerate(jp.components):
        bh, bw, _, _ = _comp_dims(jp, c)
        if use:
            out.append(smooth.smooth_component(
                planes[ci], bh, bw, c.v, mcus_y, _comp_qtable(jp, ci),
                cur[ci], prev[ci], jp.last_good_imcu_row))
        else:
            out.append(planes[ci][:bh, :bw])
    return out


def render_planes(zz: torch.Tensor, qt: torch.Tensor, ch: int,
                  cw: int) -> torch.Tensor:
    """(B, bh, bw, 64) zigzag coefficients + (B, 8, 8) natural-order
    quant tables -> (B, ch, cw) uint8 samples (the JAX _render_plane,
    vmapped). Each image's table broadcasts over its blocks as
    (B, 1, 1, 8, 8)."""
    blocks = layout.from_zigzag(zz)
    pix = dct.idct_islow(blocks, qt[:, None, None], dct.PASS1_BITS, 8)
    return layout.unblockify(pix)[:, :ch, :cw]


def upsample_color(y, cb, cr, mode: str, height: int, width: int,
                   hexp: int = 1, vexp: int = 1) -> torch.Tensor:
    """(..., H, W) uint8 Y, Cb, Cr sample planes -> (..., height, width,
    3) uint8 RGB (the JAX _upsample_color)."""
    def up(pl):
        if mode == "h2v2":
            return sample.upsample_h2v2_fancy(pl)
        if mode == "h2v1":
            return sample.upsample_h2v1_fancy(pl)
        if mode == "h1v2":
            return sample.upsample_h1v2_fancy(pl)
        if mode == "int":
            # replicate (jdsample.c int_upsample); also the -nosmooth box
            # filter
            return sample.upsample_replicate(pl, hexp, vexp)
        return pl

    ycc = torch.stack([y[..., :height, :width],
                       up(cb)[..., :height, :width],
                       up(cr)[..., :height, :width]], dim=-1)
    return color.ycc_to_rgb(ycc)


def _to_device(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def render(jp: marker.ParsedJpeg, planes: List[np.ndarray],
           fancy_upsample: bool = True, block_smoothing: bool = True,
           device=None) -> np.ndarray:
    """Coefficient planes -> RGB (H, W, 3) or gray (H, W) uint8 on
    `device` (the device branch of the JAX package's render)."""
    dev = _device(device)
    smoothed = _maybe_smooth(jp, planes, block_smoothing)
    gray = _jpeg_colorspace(jp) == "grayscale"
    samples = []
    for ci in range(1 if gray else 3):
        _, _, ch, cw = _comp_dims(jp, jp.components[ci])
        qt = _comp_qtable(jp, ci).astype(np.int32)
        samples.append(render_planes(_to_device(smoothed[ci][None], dev),
                                     _to_device(qt[None], dev), ch, cw)[0])
    if gray:
        return samples[0][:jp.height, :jp.width].cpu().numpy()
    mode, hexp, vexp = _upsample_mode(jp, fancy_upsample)
    return upsample_color(*samples, mode, jp.height, jp.width, hexp,
                          vexp).cpu().numpy()


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


def decode(data: bytes, fancy_upsample: bool = True,
           block_smoothing: bool = True, device=None,
           dct_method: str = "islow") -> np.ndarray:
    """Decode a JPEG byte stream to RGB (H, W, 3) or grayscale (H, W)
    uint8, pixel-identical to mozjpeg_tpu.decode. device: None or "cuda"
    (the default, the GPU; raises without one) or "cpu".

    fancy_upsample=False is djpeg -nosmooth's replicating upsample (pass
    block_smoothing=False too for all of -nosmooth). Truncated progressive
    streams render like djpeg: missing data leaves coefficients at their
    last decoded state and block smoothing estimates the rest."""
    dev = _device(device)
    if dct_method != "islow":
        _not_ported("the %s IDCT" % dct_method, "6.3")
    jp = marker.parse(data)
    _check_slice(jp)
    planes = decode_coefficients(jp, data)
    return render(jp, planes, fancy_upsample, block_smoothing, dev)


def decode_grayscale(data: bytes, *args, **kwargs):
    """Gray output of a colour stream (mozjpeg_tpu decode_grayscale)."""
    _not_ported("grayscale output of colour streams", "6.4")


def decode_scaled(data: bytes, num: int, den: int, *args, **kwargs):
    """Scaled decode (mozjpeg_tpu decode_scaled, ops/idct_scaled.py)."""
    _not_ported("scaled decode", "6.5")


def decode_cropped(data: bytes, x: int, w: int, *args, **kwargs):
    """Cropped decode (mozjpeg_tpu decode_cropped)."""
    _not_ported("cropped decode", "6.6")


class BufferedImage:
    """Buffered-image decode, one render per scan (mozjpeg_tpu
    BufferedImage)."""

    def __init__(self, data: bytes, *args, **kwargs):
        _not_ported("buffered-image decode", "6.8")


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
    """The batch an image joins, or None for the per-image render: active
    block smoothing, or Cb/Cr planes that differ in geometry or quant
    table (decoder.py:1595-1629)."""
    if _smoothing_active(jp, block_smoothing):
        return None
    gray = _jpeg_colorspace(jp) == "grayscale"
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
    The host entropy decode runs on a thread pool; as soon as GROUP
    images of one geometry are ready they render in one batch on the
    device while the pool goes on. output="rgb" gives (H, W, 3) or gray
    (H, W) uint8 per image; output="yuv" the per-component sample planes
    at jpeg_read_raw_data dims. device: None or "cuda" (the default, the
    GPU; raises without one) or "cpu"."""
    if output not in ("rgb", "yuv", "rgb565"):
        raise ValueError("output must be rgb, yuv or rgb565")
    dev = _device(device)
    if output == "rgb565":
        _not_ported("RGB565 output", "6.7")
    jps = [marker.parse(d) for d in datas]
    for jp in jps:
        _check_slice(jp)
    out: List = [None] * len(datas)
    planes_list: List = [None] * len(datas)
    nthreads = min(8, max(2, os.cpu_count() or 4))
    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        futs = [pool.submit(decode_coefficients, jp, d)
                for jp, d in zip(jps, datas)]
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
                out[i] = render(jps[i], planes_list[i], fancy_upsample,
                                block_smoothing, dev)
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
