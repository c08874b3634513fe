"""Batched p1 from host-prepped planes, and the dense coefficient download.

Port of the mozjpeg_tpu/codec/pipeline_t.py route the main path runs
(run_p1_batch_pre -> _p1_batch_pre -> _p1_raw, islow): the native
mj_prep_ycc converts and downsamples each image into one uint8 buffer
[Y | Cb | Cr] (edge-padded planes), the group's buffers go up in one
upload, and p1 runs on the device over every block of the group at once:

  blockify -> zigzag -> dering -> natural -> islow FDCT -> quantize
  -> clip +-1023 -> zigzag; norm sums; AC-first histograms.

Block data is coefficient-major, (64, B*n) image-major, like the JAX
package's merged planes. The small sidecar is the JAX package's layout:
per image [norm f32 bits per comp | AC-first histogram per comp], int32.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import consts, native
from ..ops import dct, dering, layout, quant, symbols
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


def norm_seq(raw_zz: torch.Tensor) -> torch.Tensor:
    """Sequential f32 sum of squared AC coefficients in NATURAL index
    order (63 elementwise adds, the C reference's order)."""
    r = raw_zz.to(torch.float32)
    terms = r * r
    acc = torch.zeros(raw_zz.shape[1], dtype=torch.float32,
                      device=raw_zz.device)
    for zpos in consts.JPEG_ZIGZAG_INV[1:]:
        acc = acc + terms[int(zpos)]
    return acc


def p1_comp(plane: torch.Tensor, g: CompGeom, qtbl: np.ndarray,
            dering_on: bool, batch: int):
    """One component of a group: plane (B, bh_pad*8, bw_pad*8) uint8 ->
    (q_zz (64, B*n) int16, raw_zz (64, B*n) int32, norm (B*n,) f32,
    AC-first histograms (B, 256) int32)."""
    blocks = layout.blockify_t(
        plane[:, :g.bh * 8, :g.bw * 8].to(torch.int32) - 128)
    if dering_on:
        szz = dering.dering_t(layout.to_zigzag_t(blocks), int(qtbl[0, 0]))
        blocks = layout.from_zigzag_t(szz)
    coeffs = dct.fdct_islow_t(blocks)
    q81 = torch.as_tensor(np.asarray(qtbl, np.int32).reshape(8, 8, 1),
                          device=plane.device)
    qz = quant.quantize_islow_t(coeffs, q81)
    if dering_on:
        qz = torch.clamp(qz, -1023, 1023)    # post-dering clamp
    q_zz = layout.to_zigzag_t(qz)
    raw_zz = layout.to_zigzag_t(coeffs)
    return (q_zz, raw_zz, norm_seq(raw_zz),
            symbols.ac_first_histograms_t(q_zz, batch))


def p1_batch_pre(bufs: torch.Tensor, geom: tuple, qtables, dering_on: bool):
    """bufs (B, total) uint8 on the device -> ([(q_zz, raw_zz)] per comp,
    smalls (B*stride,) int32, [norm (B*n,) f32] per comp)."""
    b = bufs.shape[0]
    merged, norms, hists = [], [], []
    off = 0
    for ci, g in enumerate(geom):
        size = g.bh_pad * 8 * g.bw_pad * 8
        plane = bufs[:, off:off + size].reshape(b, g.bh_pad * 8,
                                                g.bw_pad * 8)
        off += size
        qtbl = np.asarray(qtables[min(ci, 1, len(qtables) - 1)])
        q_zz, raw_zz, norm, hist = p1_comp(plane, g, qtbl, dering_on, b)
        merged.append((q_zz, raw_zz))
        norms.append(norm)
        hists.append(hist)
    smalls = torch.cat(
        [n.view(torch.int32).reshape(b, -1) for n in norms] + hists, 1)
    return merged, smalls.reshape(-1), norms


def download_hists(geom, small: torch.Tensor, b: int) -> np.ndarray:
    """The sidecar's AC-first histograms on the host, (B, ncomps, 256)
    int32, in one download; the norms stay on the device."""
    _, _, comps = geom
    nnorm = sum(g.bh * g.bw for g in comps)
    return small.reshape(b, -1)[:, nnorm:].cpu().numpy() \
        .reshape(b, len(comps), 256)


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
