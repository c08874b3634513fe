"""Batched encode: host prep -> device p1 -> device trellis -> dense
download -> host scan search and entropy.

Port of the mozjpeg_tpu/codec/encoder.py main path: encode_many groups
the images by shape into batches of up to 8 (fewer for large frames) and
runs each group through

  _batch_p1    host mj_prep_ycc, one upload, p1 on the device;
  _batch_rest  the AC-first histograms come down, the host builds the
               rate tables, and the device runs lambda, the rate LUT, the
               AC trellis kernel and the DC trellis (the JAX package's
               dev_first=None route, byte-identical to its default);
  _batch_host  one dense download, iMCU dummy blocks on the host, then
               the native scan search per image on a thread pool, which
               overlaps the next group's device work.

The slice is mozjpeg's default profile for RGB input: YCbCr, 8-bit,
islow, progressive + trellis + deringing + optimized Huffman + scan
search, any quality, subsampling 2x2, 2x1 or 1x1. Other configurations
raise NotImplementedError naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import consts
from ..entropy.huffman import HuffTable
from . import pipeline_t, scanopt, trellis
from .config import DCTMethod, EncoderConfig, Profile, ResolvedConfig
from .stages import stage

STD_TABLES = {
    (0, 0): HuffTable(*consts.STD_DC_LUMINANCE),
    (0, 1): HuffTable(*consts.STD_DC_CHROMINANCE),
    (1, 0): HuffTable(*consts.STD_AC_LUMINANCE),
    (1, 1): HuffTable(*consts.STD_AC_CHROMINANCE),
}

# YCbCr component layout: quant slots and huff table slots per component
# (jcparam.c:600-646 jpeg_set_colorspace SET_COMP calls)
YCC_QUANT_SLOTS = (0, 1, 1)
YCC_HUFF_SLOTS = (0, 1, 1)

GROUP = 8             # images per device batch
BUDGET_MP = 128.0     # megapixels per batch (big frames get smaller ones)


def make_qtables(cfg) -> List[np.ndarray]:
    """The luminance and chrominance tables of quant_tbl_idx; per-table
    quality ratings replicate the last value (rdswitch.c
    set_quality_ratings, jcparam.c:31-68)."""
    quals = (list(cfg.quality) if isinstance(cfg.quality, (list, tuple))
             else [cfg.quality])
    sfs = [consts.quality_scaling(q) for q in quals[:2]]
    if len(sfs) < 2:
        sfs.append(sfs[-1])
    bases = (consts.STD_LUMINANCE_QUANT_TBL[cfg.quant_tbl_idx],
             consts.STD_CHROMINANCE_QUANT_TBL[cfg.quant_tbl_idx])
    return [consts.scale_quant_table(b, sf, cfg.force_baseline)
            .reshape(8, 8) for b, sf in zip(bases, sfs)]


class GroupCtx(NamedTuple):
    """What every group of one image shape shares."""
    cfg: ResolvedConfig
    ncomps: int
    samp: list                  # (h, v) sampling factors per component
    qtables: List[np.ndarray]


def resolve_group(image, config: Optional[EncoderConfig] = None,
                  **overrides) -> GroupCtx:
    """The context of a group of images shaped like `image`; raises
    NotImplementedError for what this slice does not carry."""
    if config is None:
        config = EncoderConfig(**overrides)
    cfg = config.resolved()
    _check_slice(image, config, cfg)
    return GroupCtx(cfg, 3, [cfg.subsampling, (1, 1), (1, 1)],
                    make_qtables(cfg))


def _check_slice(image, config, cfg):
    """Refuse what this slice does not carry, naming the ROADMAP.md item
    (queue 1) that brings it."""
    def no(what, item):
        raise NotImplementedError(
            "mozjpeg_tpu_torch: %s is not ported yet (ROADMAP.md queue 1 "
            "item %s)" % (what, item))

    if (image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8
            or config.grayscale
            or (cfg.colorspace or "ycbcr").lower() != "ycbcr"):
        no("input other than RGB (H, W, 3) uint8 to YCbCr", "5")
    if cfg.precision != 8:
        no("12-bit precision", "5")
    if cfg.dct_method != DCTMethod.ISLOW:
        no("the %s DCT" % cfg.dct_method.value, "5")
    if config.profile != Profile.MAX_COMPRESSION:
        no("the FASTEST profile", "5")
    if tuple(cfg.subsampling) not in ((2, 2), (2, 1), (1, 1)):
        no("subsampling %r" % (tuple(cfg.subsampling),), "5")
    if not (cfg.progressive and cfg.optimize_coding and cfg.optimize_scans
            and cfg.trellis_quant and cfg.trellis_quant_dc
            and cfg.overshoot_deringing):
        no("turning off progressive, optimized Huffman, scan search, "
           "trellis or deringing", "5")
    if cfg.arithmetic:
        no("arithmetic coding", "5")
    if cfg.restart_interval or cfg.restart_in_rows:
        no("restart intervals", "5")
    if cfg.smoothing_factor:
        no("input smoothing", "5")
    if cfg.scan_script is not None or cfg.dc_scan_opt_mode:
        no("custom scan scripts and DC scan modes", "5")
    if cfg.qslots or cfg.base_quant_tables is not None:
        no("custom quant tables and slots", "5")
    if cfg.icc:
        no("ICC profiles", "5")
    if cfg.use_scans_in_trellis:
        no("use_scans_in_trellis", "5")
    if cfg.trellis_num_loops != 1:
        no("trellis_num_loops > 1 (device tables)", "5")
    if cfg.trellis_q_opt or cfg.trellis_delta_dc_weight > 0:
        no("trellis_q_opt and the DC delta weight", "5")
    if cfg.trellis_eob_opt:
        no("trellis_eob_opt (the _eob_block_dp)", "3")
    if not cfg.host_prep:
        no("on-device colour conversion and downsampling", "5")
    if cfg.device_entropy or cfg.device_scanopt:
        no("the device entropy and scan-search engines", "7")
    if cfg.sparse_download or cfg.plane_pack or cfg.coef_transport:
        no("the transfer codecs", "8")


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mozjpeg_tpu_torch: CUDA is not available; the port runs on "
                "the GPU unless the caller passes device='cpu'")
    elif dev.type != "cpu":
        raise ValueError("mozjpeg_tpu_torch: unsupported device %s" % dev)
    return dev


def encode_many(images, config: Optional[EncoderConfig] = None,
                device=None, **overrides) -> List[bytes]:
    """Encode RGB (H, W, 3) uint8 images to JPEG bytes, byte-identical
    to mozjpeg_tpu.encode_many. device: None or "cuda" (the default, the
    GPU; raises without one) or "cpu" (the kernels' plain versions)."""
    dev = _device(device)
    out = [None] * len(images)
    by_shape = {}
    for i, img in enumerate(images):
        by_shape.setdefault(np.asarray(img).shape, []).append(i)
    chunks = []
    for idxs in by_shape.values():
        img0 = np.asarray(images[idxs[0]])
        ctx = resolve_group(img0, config, **overrides)
        mp = img0.shape[0] * img0.shape[1] / 1e6
        ge = max(1, min(GROUP, int(BUDGET_MP / max(mp, 1e-6))))
        for k in range(0, len(idxs), ge):
            chunks.append((idxs[k:k + ge], ctx))
    nthreads = max(2, (os.cpu_count() or 4) - 1)
    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        pending = []
        for idxs, ctx in chunks:
            imgs = [np.asarray(images[i]) for i in idxs]
            pending.append((idxs, encode_group(imgs, ctx, dev, pool)))
        for idxs, futs in pending:
            for i, f in zip(idxs, futs):
                out[i] = f.result()
    return out


def encode_group(images, ctx: GroupCtx, dev, pool, times=None,
                 record=None):
    """One same-shape group -> per image futures of the JPEG bytes.
    With `times` (dict) every stage is synchronised and timed, and the
    host entropy is waited for inside its stage. With `record` (dict)
    record["lambda"] gets each component's (norm sums, lambda) and
    record["trellis_ac"] the arguments of each trellis_ac call."""
    cfg, ncomps, samp, qtables = ctx
    p1 = _batch_p1(images, cfg, samp, qtables, dev, times)
    finals = _batch_rest(images, p1, cfg, ncomps, qtables, dev, times,
                         record)
    return _batch_host(images, p1[0], finals, cfg, ncomps, qtables, pool,
                       dev, times)


def _batch_p1(images, cfg, samp, qtables, dev, times=None):
    with stage(times, "prep", dev):
        geom, bufs = pipeline_t.prep_ycc_batch(images, samp)
        bufs_t = torch.from_numpy(bufs).to(dev)
    with stage(times, "p1", dev):
        merged, smalls, norms = pipeline_t.p1_batch_pre(
            bufs_t, tuple(geom[2]), qtables, cfg.overshoot_deringing)
    return geom, merged, smalls, norms


def _batch_rest(images, p1, cfg, ncomps, qtables, dev, times=None,
                record=None):
    b = len(images)
    geom, merged, smalls, norms = p1
    _, _, comps = geom
    with stage(times, "trellis_tables", dev):
        hists = pipeline_t.download_hists(geom, smalls, b)
        lams, ac_sis, dc_sis, qtblzz, ncands = [], [], [], [], []
        for ci in range(ncomps):
            tabs = [trellis.trellis_tables_from_hist(hists[i, ci],
                                                     YCC_HUFF_SLOTS[ci])
                    for i in range(b)]
            ac_sis.append(torch.as_tensor(np.stack([t[0] for t in tabs]),
                                          device=dev))
            dc_sis.append(tabs[0][1])
            qz = np.asarray(qtables[YCC_QUANT_SLOTS[ci]]).reshape(64)[
                consts.JPEG_ZIGZAG] \
                .astype(np.int32)
            qtblzz.append(qz)
            ncands.append(trellis.get_num_dc_candidates(int(qz[0])))
            lams.append(trellis.lambda_from_norm_t(
                norms[ci], cfg.lambda_log_scale1, cfg.lambda_log_scale2))
    if record is not None:
        record.setdefault("lambda", []).extend(zip(norms, lams))
    return trellis.trellis_all(
        tuple(comps), tuple(m[1] for m in merged),
        tuple(m[0] for m in merged), lams, ac_sis, dc_sis, qtblzz, ncands,
        batch=b, times=times, record=record)


def _batch_host(images, geom, finals, cfg, ncomps, qtables, pool, dev,
                times=None):
    b = len(images)
    _, _, comps = geom
    with stage(times, "download", dev):
        flat = pipeline_t.pack_all_batch(finals, b).cpu().numpy()
        per_image = [[pipeline_t.add_dummy_blocks_host(p, g)
                      for p, g in zip(planes, comps)]
                     for planes in pipeline_t.split_flat_batch(geom, flat, b)]
    # one image per pool thread; a lone image threads its own search
    nthreads = (os.cpu_count() or 1) if b == 1 else 1
    with stage(times, "host_entropy", dev):
        futs = [pool.submit(scanopt.encode_optimize_scans_native,
                            img.shape[1], img.shape[0], geom, planes,
                            qtables, cfg, ncomps, 8, nthreads)
                for img, planes in zip(images, per_image)]
        if times is not None:
            for f in futs:
                f.result()
    return futs
