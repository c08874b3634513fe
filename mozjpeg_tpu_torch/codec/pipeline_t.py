"""Batched p1 and the dense coefficient download.

Port of mozjpeg_tpu/codec/pipeline_t.py. p1 runs on the device over every
block of a group of same-shape images at once, per component:

  blockify -> [zigzag -> dering -> natural] -> FDCT (islow, ifast or
  float) -> quantize -> clip +-(2^(precision+2)-1) -> zigzag; norm sums;
  AC-first histograms (segmented at the trellis's restart intervals).
The islow chain, the norms and the histograms run in ops/p1.py: two
hand-written CUDA kernels a component on the card, their plain PyTorch
versions on the CPU.

Its planes come one of three ways, as in the JAX package's _batch_p1:
  - host prep (run_p1_batch_pre): the native mj_prep_ycc converts and
    downsamples each RGB image into one uint8 buffer [Y | Cb | Cr] of
    edge-padded planes, and the group's buffers go up in one upload
    (YCbCr without smoothing);
  - host prep plane-packed (run_p1_batch_packed, plane_pack): the same
    buffers, each packed by the native mj_plane_pack (ops/planepack.py's
    format), go up as one stream of words and expand on the device into
    the same buffers;
  - device prep (run_p1_batch -> _p1): the raw images go up, and the
    colour conversion (YCbCr, gray, YCCK, or none for RGB and CMYK),
    padding, input smoothing and downsampling run on the device.

Block data is coefficient-major, (64, B*n) image-major, like the JAX
package's merged planes. The small sidecar is the JAX package's layout:
per image [norm f32 bits per comp | AC-first histogram per comp], int32.

Samples are uint8 at 8 bits; 12-bit samples go up as uint16 bits and are
carried as int32 from there on (to_samples), since torch's uint16
supports few operations. Host prep is 8-bit YCbCr only, as in the JAX
package.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import native
from ..ops import (bitpack, color, dct, dering, layout, p1, planepack,
                   sample, symbols)
from ..ops.p1 import norm_seq  # noqa: F401  (the port's name for it)
from .pipeline import CompGeom, geometry


def prep_ycc_batch(images, samp):
    """Host C++ colour conversion + downsampling -> (geom, (B, total)
    uint8 buffers of [Y | Cb | Cr] edge-padded iMCU planes)."""
    b = len(images)
    h, w = images[0].shape[:2]
    mcus_x, mcus_y, geom = geometry(w, h, samp)
    gy, gc = geom[0], geom[1]
    pw_y, ph_y = gy.bw_pad * 8, gy.bh_pad * 8
    pw_c, ph_c = gc.bw_pad * 8, gc.bh_pad * 8
    total = ph_y * pw_y + 2 * ph_c * pw_c
    bufs = np.empty((b, total), np.uint8)
    nt = max(1, (os.cpu_count() or 4) - 1)
    so = native.lib()
    for i, img in enumerate(images):
        rgb = np.ascontiguousarray(img)
        yp = bufs[i, :ph_y * pw_y]
        cbp = bufs[i, ph_y * pw_y:ph_y * pw_y + ph_c * pw_c]
        crp = bufs[i, ph_y * pw_y + ph_c * pw_c:]
        so.mj_prep_ycc(rgb.ctypes.data_as(native.u8p), w, h,
                       samp[0][0], samp[0][1], pw_y, ph_y, pw_c, ph_c,
                       yp.ctypes.data_as(native.u8p),
                       cbp.ctypes.data_as(native.u8p),
                       crp.ctypes.data_as(native.u8p), nt)
    return (mcus_x, mcus_y, geom), bufs


def pack_ycc_batch(images, samp):
    """Host prep as prep_ycc_batch, then each image's buffer plane-packed
    (native mj_plane_pack) -> (geom, hdrs (B, nwh) uint32 width words,
    flat (capt,) uint32 payloads back to back, bases (B,) int32 each
    image's first word, total samples an image)."""
    geom, bufs = prep_ycc_batch(images, samp)
    b, total = bufs.shape
    nst = -(-total // planepack.T)
    nt = max(1, (os.cpu_count() or 4) - 1)
    so = native.lib()
    widths = np.empty((b, nst), np.uint8)
    words = np.empty((b, nst * 4 + 4), np.uint32)
    nws = [int(so.mj_plane_pack(bufs[i].ctypes.data_as(native.u8p), total,
                                widths[i].ctypes.data_as(native.u8p),
                                words[i].ctypes.data_as(native.u32p), nt))
           for i in range(b)]
    bases = np.zeros(b, np.int32)
    bases[1:] = np.cumsum(nws[:-1])
    # one bucket a group, as the JAX package sizes its upload
    flat = np.zeros(max(1, -(-sum(nws) // 8192) * 8192), np.uint32)
    for i in range(b):
        flat[bases[i]:bases[i] + nws[i]] = words[i, :nws[i]]
    return geom, planepack.widths_to_words_host(widths), flat, bases, total


def unpack_ycc_batch(hdrs: torch.Tensor, flat: torch.Tensor,
                     bases: torch.Tensor, total: int) -> torch.Tensor:
    """The uploaded plane-packed group on the device -> (B, total) uint8
    host-prepped buffers, exactly prep_ycc_batch's."""
    nst = -(-total // planepack.T)
    widths = planepack.widths_from_words(bitpack.words_i64(hdrs), nst)
    return planepack.expand_stream(bitpack.words_i64(flat), widths, total,
                                   bases.to(torch.int64))


def _t81(table: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(table).reshape(8, 8, 1),
                           device=device)


def to_samples(images: np.ndarray, dev) -> torch.Tensor:
    """A stack of uint8 or uint16 images -> its samples on dev: uint8 as
    they are, uint16 uploaded as their 16 bits and widened to int32
    there."""
    if images.dtype == np.uint8:
        return torch.from_numpy(images).to(dev)
    bits = torch.from_numpy(images.view(np.int16)).to(dev)
    return bits.to(torch.int32) & 0xFFFF


def quantize_comp(plane: torch.Tensor, g: CompGeom, qtbl: np.ndarray,
                  dering_on: bool, dct_method: str = "islow",
                  precision: int = 8):
    """The real blocks of one component's planes (B, >= bh*8, >= bw*8)
    samples (uint8, or int32 above 8 bits) -> (q_zz (64, B*n), raw_zz
    (64, B*n) int32): [dering], FDCT, quantization, the post-dering
    clamp, zigzag. islow runs through ops/p1.p1_blocks (its kernel on
    the card)."""
    if dct_method == "islow":
        return p1.p1_blocks(plane, g.bh, g.bw, qtbl, dering_on,
                            precision)[:2]
    dev = plane.device
    qtbl = np.asarray(qtbl)
    q0 = int(qtbl.reshape(64)[0])
    blocks = layout.blockify_t(
        plane[:, :g.bh * 8, :g.bw * 8].to(torch.int32)
        - (1 << (precision - 1)))
    # the dering threshold stays 255 - CENTERJSAMPLE's 8-bit literal at
    # every precision (jcdctmgr.c:419)
    if dering_on and dct_method != "float":
        blocks = layout.from_zigzag_t(
            dering.dering_t(layout.to_zigzag_t(blocks), q0))
    if dct_method == "ifast":
        sc = dct.fdct_ifast_t(blocks)                  # AAN-scaled
        qz = dct.quantize_ifast_t(sc, _t81(dct.ifast_divisors(qtbl), dev))
        coeffs = dct.rescale_ifast_t(sc)               # nominal-range raw
    elif dct_method == "float":
        fblocks = blocks.to(torch.float32)
        if dering_on:
            fblocks = layout.from_zigzag_t(
                dering.dering_float_t(layout.to_zigzag_t(fblocks), q0))
        sc = dct.fdct_float_t(fblocks)
        qz = dct.quantize_float_t(sc, _t81(dct.float_divisors(qtbl), dev))
        coeffs = dct.rescale_float_t(sc)
    else:
        raise ValueError("unknown dct_method %r" % dct_method)
    if dering_on:
        # post-dering clamp (jcdctmgr.c:706,764)
        maxc = (1 << (precision + 2)) - 1
        qz = torch.clamp(qz, -maxc, maxc)
    return layout.to_zigzag_t(qz), layout.to_zigzag_t(coeffs)


def p1_comp(plane: torch.Tensor, g: CompGeom, qtbl: np.ndarray,
            dering_on: bool, batch: int, dct_method: str = "islow",
            ri: int = 0, precision: int = 8):
    """One component of a group: plane (B, >= bh*8, >= bw*8) samples
    (uint8, or int32 above 8 bits) -> (q_zz (64, B*n) int16, raw_zz
    (64, B*n) int32, norm (B*n,) f32, AC-first histograms (B, 256)
    int32). islow runs through ops/p1.p1_islow (two kernel launches on
    the card); ifast and float through quantize_comp's PyTorch ops."""
    if dct_method == "islow":
        return p1.p1_islow(plane, g.bh, g.bw, qtbl, dering_on, ri,
                           precision)
    q_zz, raw_zz = quantize_comp(plane, g, qtbl, dering_on, dct_method,
                                 precision)
    return (q_zz, raw_zz, norm_seq(raw_zz),
            symbols.ac_first_histograms_t(q_zz, batch, ri))


def _p1_planes(planes, geom, qtables, dering_on: bool, dct_method: str,
               ris, precision: int = 8):
    """Per component (B, H, W) sample planes -> ([(q_zz, raw_zz)] per
    comp, smalls (B*stride,) int32, [norm (B*n,) f32] per comp)."""
    b = planes[0].shape[0]
    merged, norms, hists = [], [], []
    for ci, (plane, g) in enumerate(zip(planes, geom)):
        q_zz, raw_zz, norm, hist = p1_comp(
            plane, g, qtables[ci], dering_on, b, dct_method,
            ris[ci] if ris else 0, precision)
        merged.append((q_zz, raw_zz))
        norms.append(norm)
        hists.append(hist)
    smalls = torch.cat(
        [n.view(torch.int32).reshape(b, -1) for n in norms] + hists, 1)
    return merged, smalls.reshape(-1), norms


def comp_qtables(qtables, slots) -> list:
    """The quant table of each component's slot (the last table where a
    slot has none, as the JAX package's min(slot, len - 1))."""
    return [qtables[min(s, len(qtables) - 1)] for s in slots]


def p1_batch_pre(bufs: torch.Tensor, geom: tuple, qtables, dering_on: bool,
                 dct_method: str = "islow", ris=None, slots=(0, 1, 1)):
    """bufs (B, total) uint8 of host-prepped [Y | Cb | Cr] planes on the
    device -> ([(q_zz, raw_zz)] per comp, smalls (B*stride,) int32,
    [norm (B*n,) f32] per comp). qtables: the table list, per slot;
    slots: the components' quant slots."""
    b = bufs.shape[0]
    planes, off = [], 0
    for g in geom:
        size = g.bh_pad * 8 * g.bw_pad * 8
        planes.append(bufs[:, off:off + size].reshape(b, g.bh_pad * 8,
                                                      g.bw_pad * 8))
        off += size
    return _p1_planes(planes, geom, comp_qtables(qtables, slots),
                      dering_on, dct_method, ris)


def _comp_plane(p: torch.Tensor, g: CompGeom, max_h: int, max_v: int,
                h2: int, smoothing: int = 0) -> torch.Tensor:
    """One component's (B, ph, pw) full-rate padded plane -> its
    (B, bh_pad*8, bw_pad*8) plane, downsampled and padded."""
    if smoothing:
        # context mode (jcprepct.c pre_process_context): rows replicate
        # through the whole iMCU height before downsampling, so the
        # two-stage (downsample, then replicate) padding does not apply
        if g.h == max_h and g.v == max_v:
            p = sample.smooth_fullsize(p, smoothing)
        elif g.h * 2 == max_h and g.v * 2 == max_v:
            p = sample.downsample_h2v2_smooth(p, smoothing)
        elif g.h * 2 == max_h and g.v == max_v:
            # h2v1 has no smoothing variant (jcsample.c:499-507)
            p = sample.downsample_h2v1(p)
        elif g.h < max_h or g.v < max_v:
            p = sample.downsample_int(p, max_h // g.h, max_v // g.v)
        return p[..., :g.bh_pad * 8, :g.bw_pad * 8]
    if g.v < max_v:
        p = p[..., :h2, :]
    hexp, vexp = max_h // g.h, max_v // g.v
    if (hexp, vexp) == (2, 2):
        p = sample.downsample_h2v2(p)
    elif (hexp, vexp) == (2, 1):
        p = sample.downsample_h2v1(p)
    elif (hexp, vexp) != (1, 1):
        # jcsample has no special 1x2 kernel: every other ratio (1x2,
        # 4x1, 1x4, 4x2, ...) takes the plain integral average
        p = sample.downsample_int(p, hexp, vexp)
    p = layout.pad_plane(p, g.bh_pad * 8, g.bw_pad * 8)
    return p[..., :g.bh_pad * 8, :g.bw_pad * 8]


def prep_planes(images: torch.Tensor, geom_full, cs: str,
                smoothing: int = 0, precision: int = 8):
    """Device prep: images (B, H, W) or (B, H, W, C) samples on the
    device (to_samples) -> per component (B, bh_pad*8, bw_pad*8) planes
    of the samples' type. cs names the colour conversion (YCbCr, gray,
    YCCK, or none for RGB and CMYK)."""
    mcus_x, mcus_y, geom = geom_full
    max_h, max_v = geom[0].h, geom[0].v
    h = images.shape[1]
    ph, pw = mcus_y * 8 * max_v, mcus_x * 8 * max_h
    h2 = -(-h // max_v) * max_v
    if cs == "ycck":
        chans = color.cmyk_to_ycck(images, precision)
    elif cs in ("rgb", "cmyk"):
        chans = images                # null conversion (jccolor.c:723)
    elif images.dim() == 4:
        chans = color.rgb_to_ycc(images, precision)
    else:
        chans = images[..., None]
    return [_comp_plane(layout.pad_plane(chans[..., ci], ph, pw), g,
                        max_h, max_v, h2, smoothing)
            for ci, g in enumerate(geom)]


def p1_batch(images: torch.Tensor, geom_full, cs: str, qtables, slots,
             dering_on: bool, dct_method: str = "islow", ris=None,
             smoothing: int = 0, precision: int = 8):
    """Device prep + p1 -> as p1_batch_pre; slots are the components'
    quant slots."""
    planes = prep_planes(images, geom_full, cs, smoothing, precision)
    return _p1_planes(planes, geom_full[2], comp_qtables(qtables, slots),
                      dering_on, dct_method, ris, precision)


def download_hists(geom, small: torch.Tensor, b: int) -> np.ndarray:
    """The sidecar's AC-first histograms on the host, (B, ncomps, 256)
    int32, in one download; the norms stay on the device."""
    _, _, comps = geom
    nnorm = sum(g.bh * g.bw for g in comps)
    return small.reshape(b, -1)[:, nnorm:].cpu().numpy() \
        .reshape(b, len(comps), 256)


def hists_t(geom, small: torch.Tensor, b: int):
    """The sidecar's AC-first histograms on the device, per component
    (B, 256) int32 views."""
    _, _, comps = geom
    nnorm = sum(g.bh * g.bw for g in comps)
    h = small.reshape(b, -1)[:, nnorm:]
    return [h[:, 256 * ci:256 * (ci + 1)] for ci in range(len(comps))]


def pack_all_batch(planes_t, b: int) -> torch.Tensor:
    """Per comp (64, B*n) planes -> ONE flat int16 tensor ordered
    [image0: comp0 blocks (n, 64), comp1, ...][image1: ...]."""
    return torch.cat([q.reshape(64, b, -1).permute(1, 2, 0).reshape(b, -1)
                      for q in planes_t], 1).reshape(-1)


def split_flat_batch(geom, flat: np.ndarray, b: int):
    """Flat host buffer -> per image [(bh, bw, 64) int16 per comp]."""
    _, _, comps = geom
    out = []
    off = 0
    for _ in range(b):
        planes = []
        for g in comps:
            n = g.bh * g.bw * 64
            planes.append(flat[off:off + n].reshape(g.bh, g.bw, 64))
            off += n
        out.append(planes)
    return out


def planes_t(finals, geom, b: int):
    """Per component (64, B*n) planes -> (B, bh_pad, bw_pad, 64) on their
    device, with the iMCU dummy blocks (layout.add_dummy_blocks)."""
    out = []
    for q, g in zip(finals, geom[2]):
        p = q.reshape(64, b, g.bh, g.bw).permute(1, 2, 3, 0)
        p = torch.nn.functional.pad(
            p, (0, 0, 0, g.bw_pad - g.bw, 0, g.bh_pad - g.bh))
        out.append(layout.add_dummy_blocks(p, g.bw, g.bh, g.h, g.v)
                   .contiguous())
    return out


def add_dummy_blocks_host(plane: np.ndarray, g: CompGeom) -> np.ndarray:
    """(bh, bw, 64) real-block plane -> (bh_pad, bw_pad, 64) with iMCU
    dummy blocks: DC of the row's last real block for dummy columns,
    per-MCU-column repeated DC for dummy rows, zero AC
    (mozjpeg jccoefct.c:300-347)."""
    if g.bw == g.bw_pad and g.bh == g.bh_pad:
        return plane
    out = np.zeros((g.bh_pad, g.bw_pad, 64), plane.dtype)
    out[:g.bh, :g.bw] = plane
    if g.bw < g.bw_pad:
        out[:g.bh, g.bw:, 0] = plane[:, g.bw - 1, 0:1]
    if g.bh < g.bh_pad:
        src = out[g.bh - 1, :, 0].reshape(g.bw_pad // g.h, g.h)[:, -1]
        out[g.bh:, :, 0] = np.repeat(src, g.h)[None, :]
    return out
