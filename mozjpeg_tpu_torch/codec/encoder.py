"""Encode: prep -> device p1 -> device trellis -> coefficient download ->
host scan search or scan emission, and marker assembly.

Port of mozjpeg_tpu/codec/encoder.py: encode() and encode_many.
encode_many groups the images by shape into batches of up to 8 (fewer
for large frames) and runs each group through (encode_group)

  _batch_p1    host prep (native mj_prep_ycc, YCbCr without smoothing;
               with plane_pack on the batched route its buffers go up
               plane-packed and expand on the device) or device prep
               (colour conversion, smoothing, downsampling), one upload,
               p1 on the device;
  _batch_rest  the trellis passes: the AC-first histograms come down, the
               host builds the rate tables, and the device runs lambda,
               the rate LUT, the AC trellis kernel, the EOB-run DP and the
               DC trellis (the JAX package's host-tablegen route, byte-
               identical to its default); use_scans_in_trellis and
               trellis_num_loops regather histograms on the device and
               download them once per pass; or, for the arithmetic
               trellis, arith_trellis (row by row, the coder on the host);
  _batch_host  the coefficient download (dense, or on the batched route
               the transfer codecs' chain: coef_transport's Huffman
               transport, sparse_download's exact sparse pack; see
               _fetch_planes), iMCU dummy blocks on the host, then per
               image on a thread pool (which overlaps the next group's
               device work) the native scan search, the script's scans
               emitted one by one or arithmetic-coded, and the markers.

The configurations the JAX package does not batch (batchable: the
arithmetic trellis, trellis_q_opt, quant slots other than the
colorspace's) run its per-image route on the same groups; on the CPU
they, and encode()'s single images, take the host engine
(codec/host_engine.py) where the JAX package does. The surface is the
JAX package's whole lossy one: gray, YCbCr, RGB, CMYK and YCCK; any
subsampling; islow, ifast and float DCTs; smoothing; restart intervals;
sequential, progressive, custom and FASTEST scripts with optimized or
standard Huffman tables or arithmetic coding; every trellis option;
quant tables and slots, ICC and density; 8-bit samples (uint8) and
12-bit ones (uint16, precision=12: the AC trellis kernel at 14 bit
lengths, Huffman only, SOF1 when sequential). Lossless SOF3 is
codec/lossless.py. Images over MJ_BATCH_MAX_MP megapixels take the
per-image route one at a time or, in the rows profile on two or more
devices, the iMCU-row sharding of parallel/rows.py (_route_rows).
"""
from __future__ import annotations

import contextvars
import dataclasses
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import consts, native
from ..entropy import encode as entenc
from ..entropy.huffman import HuffTable, derive_codes
from ..ops import bitpack, sparsepack, tablegen, transport
from ..utils import xfer
from . import (arith, host_engine, marker, pipeline_t, report, scanopt,
               scanopt_dev, scans, stages, trellis)
from .config import (CS_INFO, EncoderConfig, Profile, ResolvedConfig,
                     qt_slots, scan_restart_interval, trellis_ris)
from .pipeline import geometry
from .stages import stage

STD_TABLES = {
    (0, 0): HuffTable(*consts.STD_DC_LUMINANCE),
    (0, 1): HuffTable(*consts.STD_DC_CHROMINANCE),
    (1, 0): HuffTable(*consts.STD_AC_LUMINANCE),
    (1, 1): HuffTable(*consts.STD_AC_CHROMINANCE),
}

GROUP = 8             # images per device batch
BUDGET_MP = 128.0     # megapixels per batch (big frames get smaller ones)


def make_qtables(cfg) -> List[np.ndarray]:
    """Up to 4 tables: per-table quality ratings replicate the last value
    (rdswitch.c set_quality_ratings); base_quant_tables replace slots
    0..n-1 and take the same per-slot scale factors (jcparam.c:31-68)."""
    quals = (list(cfg.quality) if isinstance(cfg.quality, (list, tuple))
             else [cfg.quality])
    sfs = [consts.quality_scaling(q) for q in quals[:4]]
    while len(sfs) < 4:
        sfs.append(sfs[-1])
    bases = [consts.STD_LUMINANCE_QUANT_TBL[cfg.quant_tbl_idx],
             consts.STD_CHROMINANCE_QUANT_TBL[cfg.quant_tbl_idx],
             None, None]
    if cfg.base_quant_tables is not None:
        for i, t in enumerate(cfg.base_quant_tables[:4]):
            bases[i] = np.asarray(t, dtype=np.uint32).reshape(-1)
    out = [None if b is None
           else consts.scale_quant_table(b, sf, cfg.force_baseline)
           .reshape(8, 8) for b, sf in zip(bases, sfs)]
    while out and out[-1] is None:
        out.pop()
    return out


class GroupCtx(NamedTuple):
    """What every group of one image shape shares."""
    cfg: ResolvedConfig
    profile: Profile
    cs: str                     # colorspace of the frame (CS_INFO key)
    ncomps: int
    samp: list                  # (h, v) sampling factors per component
    qtables: List[np.ndarray]
    # the frame's quant slot per component where it is not the
    # configuration's (a transcoded stream keeps its source's)
    slots: Optional[tuple] = None
    # markers written after the ICC profile (a transcode's copied ones)
    extra_markers: tuple = ()


def resolve_group(image, config: Optional[EncoderConfig] = None,
                  **overrides) -> GroupCtx:
    """The context of a group of images shaped like `image` (the JAX
    package's _resolve); raises ValueError for samples the configuration
    cannot take."""
    if config is None:
        config = EncoderConfig(**overrides)
    cfg = config.resolved()
    image = np.asarray(image)
    if image.ndim not in (2, 3):
        raise ValueError("expected an (H, W) or (H, W, C) image")
    channels = 1 if image.ndim == 2 else image.shape[2]
    cs = (cfg.colorspace or "").lower() or None
    if cs is None:
        if config.grayscale or channels == 1:
            cs = "grayscale"
        elif channels == 4:
            cs = "cmyk"           # jpeg_default_colorspace: no translation
        else:
            cs = "ycbcr"
    if cs not in CS_INFO:
        raise ValueError("unknown colorspace %r" % (cs,))
    ncomps = len(CS_INFO[cs][0])
    if cs in ("cmyk", "ycck") and channels != 4:
        raise ValueError("%s needs (H, W, 4) input" % cs)
    _check_slice(image, cfg)
    sub = tuple(cfg.subsampling)
    if cs == "ycbcr":
        samp = [sub, (1, 1), (1, 1)]
    elif cs == "ycck":
        samp = [sub, (1, 1), (1, 1), sub]   # Y and K full rate
    else:
        samp = [(1, 1)] * ncomps
    return GroupCtx(cfg, config.profile, cs, ncomps, samp, make_qtables(cfg))


def _check_slice(image, cfg):
    """Refuse sample types the configuration cannot take (ValueError)."""
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError("expected uint8 or uint16 samples, got %s"
                         % image.dtype)
    if image.dtype == np.uint16 and cfg.precision == 8:
        raise ValueError("uint16 samples need precision=12")


def _over_batch_limit(image) -> bool:
    """Whether the image is larger than the batched route takes
    (MJ_BATCH_MAX_MP megapixels, the JAX package's knob and default)."""
    max_mp = float(os.environ.get("MJ_BATCH_MAX_MP", "48.0"))
    return image.shape[0] * image.shape[1] > max_mp * 1e6


def _route_rows(img, config, overrides, dev) -> Optional[bytes]:
    """A huge single on several devices: the JAX package's route through
    parallel/rows.py's iMCU-row sharding, taken for an RGB image in the
    rows profile (the default with restart_in_rows set and a numeric
    quality: shard independence needs the restart markers, so another
    configuration's bytes would differ) with two or more devices of dev's
    kind (parallel/batch.device_count). Byte-exact against the
    per-image route; None where not taken."""
    from ..parallel import batch as pbatch
    from ..parallel import rows as prows
    if img.ndim != 3 or img.shape[2] != 3 or pbatch.device_count(dev) < 2:
        return None
    cfg = config if config is not None else EncoderConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rr = cfg.restart_in_rows
    if not rr or not isinstance(cfg.quality, (int, float)):
        return None
    if cfg != EncoderConfig(quality=cfg.quality, restart_in_rows=rr):
        return None
    return prows.encode_row_sharded_scanopt(
        img, float(cfg.quality), pbatch.make_mesh(pbatch.local_devices(dev)),
        restart_rows=rr)


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


def encode(image, config: Optional[EncoderConfig] = None, progress=None,
           trace=None, device=None, **overrides) -> bytes:
    """Encode one image to JPEG bytes, byte-identical to mozjpeg_tpu.encode.
    On the GPU (device None or "cuda", the default; raises without one)
    it is encode_many of the one image. With device="cpu" it routes as
    the JAX package does: the host engine (codec/host_engine.py) when
    MJ_HOST_ENGINE is not 0 and the configuration is in its matrix with
    the colorspace's quant slots, else encode_many.
    progress(completed, total, desc) is called after each pass and
    trace(msg) gets the reference's trace lines (codec/report.py)."""
    dev = _device(device)
    image = np.asarray(image)
    if dev.type == "cpu":
        ctx = resolve_group(image, config, **overrides)
        if _host_engine_serves(ctx):
            with report.reporting(progress, trace):
                return host_engine.encode_host(image, ctx)
    return encode_many([image], config, progress=progress, trace=trace,
                       device=dev, **overrides)[0]


def _default_slots(ctx: GroupCtx) -> bool:
    return (qt_slots(ctx.cfg, ctx.cs, ctx.ncomps)
            == CS_INFO[ctx.cs][0][:ctx.ncomps])


def _host_engine_serves(ctx: GroupCtx) -> bool:
    """Whether the JAX package routes the configuration to its host
    engine (taken by the port on the CPU only)."""
    return (host_engine.enabled() and host_engine.supported(ctx.cfg, ctx.cs)
            and _default_slots(ctx))


def batchable(ctx: GroupCtx) -> bool:
    """Whether the JAX package batches the configuration (_fast_ctx); the
    others take its per-image route (or the host engine). The arithmetic
    trellis trains the coder on each block row before the next row's
    rates, trellis_q_opt refits each image's tables, and other quant
    slots do not batch there either."""
    cfg = ctx.cfg
    return (not cfg.trellis_q_opt
            and not (cfg.arithmetic and cfg.trellis_quant)
            and _default_slots(ctx))


def encode_many(images, config: Optional[EncoderConfig] = None,
                progress=None, trace=None, device=None,
                **overrides) -> List[bytes]:
    """Encode images, (H, W) gray or (H, W, C) with C = 3 (RGB) or 4
    (CMYK), uint8 (or uint16 with precision=12), to JPEG bytes,
    byte-identical to mozjpeg_tpu.encode_many.
    device: None or "cuda" (the default, the GPU; raises without one) or
    "cpu" (the kernels' plain versions). Same-shape images run in groups
    (encode_group); on the CPU the configurations the JAX package does
    not batch take the host engine where it serves them, as there.
    progress and trace as in encode; the passes of a group's images
    interleave, so only a group of one image reports in a fixed order.
    A traced call (codec/stages.py) records the span "enc.call" with its
    images and pixels, the spans of its groups and stages, each image's
    "enc.entropy_image" on its pool thread (with the native scan search's
    counters, or the scan_* counters of the scans coded one by one) and
    "enc.entropy_wait", the wait for them."""
    dev = _device(device)
    with report.reporting(progress, trace), \
            stages.call("enc.call", images=len(images)) as sp:
        return _encode_many(images, config, dev, overrides, sp)


def _encode_many(images, config, dev, overrides, sp) -> List[bytes]:
    out = [None] * len(images)
    by_shape = {}
    for i, img in enumerate(images):
        by_shape.setdefault(np.asarray(img).shape, []).append(i)
    if sp:
        sp.set(pixels=sum(s[0] * s[1] * len(ix)
                          for s, ix in by_shape.items()))
    chunks, host = [], []
    for idxs in by_shape.values():
        img0 = np.asarray(images[idxs[0]])
        ctx = resolve_group(img0, config, **overrides)
        # images over the batch limit take the JAX package's slow_idx
        # route: the host engine on the CPU where it serves, else one at
        # a time through the per-image route
        big = _over_batch_limit(img0)
        routed = big and _route_rows(img0, config, overrides, dev)
        if routed:
            # the route's conditions hold for every image of the shape
            out[idxs[0]] = routed
            for i in idxs[1:]:
                out[i] = _route_rows(np.asarray(images[i]), config,
                                     overrides, dev)
            continue
        if dev.type == "cpu" and (big or not batchable(ctx)) and \
                _host_engine_serves(ctx):
            host += [(i, ctx) for i in idxs]
            continue
        mp = img0.shape[0] * img0.shape[1] / 1e6
        ge = 1 if big else max(1, min(GROUP, int(BUDGET_MP / max(mp, 1e-6))))
        for k in range(0, len(idxs), ge):
            chunks.append((idxs[k:k + ge], ctx, big or not batchable(ctx)))
    if host:
        # each call threads its own stages over the host's cores; these
        # tasks do not carry the caller's reporter, as in the JAX package
        with ThreadPoolExecutor(max_workers=2) as pool:
            for i, f in [(i, pool.submit(host_engine.encode_host,
                                         np.asarray(images[i]), ctx))
                         for i, ctx in host]:
                out[i] = f.result()
    # a group's images all enter the native search's workers at once;
    # their pool threads mostly wait there
    with ThreadPoolExecutor(max_workers=max(GROUP, os.cpu_count() or 4)) \
            as pool:
        pending = []
        for idxs, ctx, per_image in chunks:
            imgs = [np.asarray(images[i]) for i in idxs]
            pending.append((idxs, per_image,
                            encode_group(imgs, ctx, dev, pool,
                                         per_image=per_image)))
        with stages.span("enc.entropy_wait"):
            for idxs, per_image, futs in pending:
                for i, f in zip(idxs, futs):
                    out[i] = f.result()
                    if not (per_image or isinstance(futs, _Searched)):
                        report.pass_done("entropy")
    return out


def encode_group(images, ctx: GroupCtx, dev, pool, times=None,
                 record=None, per_image: Optional[bool] = None):
    """One same-shape group -> per image futures of the JPEG bytes.
    A configuration that does not batch (see batchable), or per_image=True
    (an image over the batch limit), runs the JAX package's per-image
    route on the whole group: its trellis regathers
    the statistics of later loops with the restart segmentation, the
    arithmetic trellis runs image by image and block row by block row
    (arith_trellis), and trellis_q_opt refits each image's own tables
    (q_opt_sums, q_opt_tables). With `times` (dict) every stage is
    synchronised and timed, and the host entropy is waited for inside
    its stage. With `record` (dict) record["lambda"] gets each
    component's (norm sums, lambda), record["trellis_ac"] the arguments
    of each trellis_ac call and record["tablegen"] the counts of each
    device tablegen call of the trellis. The per-image route reports a
    main and a trellis pass per image, the batched one an entropy pass
    per image (counted here, done as encode_many takes the result). A
    traced call records the span "enc.group" around it."""
    with stages.span("enc.group", images=len(images)):
        cfg, b = ctx.cfg, len(images)
        if per_image is None:
            per_image = not batchable(ctx)
        if per_image:
            report.add_passes(b * (2 if cfg.trellis_quant else 1))
        p1 = _batch_p1(images, ctx, dev, times, batched=not per_image)
        if per_image:
            for _ in range(b):
                report.pass_done("main")
        finals, qtables = _finals(p1, ctx, dev, b, times, record, per_image)
        if per_image and cfg.trellis_quant:
            for _ in range(b):
                report.pass_done("trellis")
        if not per_image and _device_search_serves(ctx, p1[0]):
            try:
                with stage(times, "device_search", dev):
                    outs = scanopt_dev.encode_batch_scans(
                        [im.shape[1] for im in images],
                        [im.shape[0] for im in images], p1[0], finals,
                        ctx.qtables, cfg, ctx.ncomps, b, _frame_slots(ctx),
                        ((marker.icc_chunks(cfg.icc) if cfg.icc else [])
                         + list(ctx.extra_markers)) or None)
                return _Searched(_done(o) for o in outs)
            except scanopt_dev.FallbackNeeded:
                count_host_route("search")
        codec = None if per_image else _dispatch_download(finals, b, cfg)
        return _batch_host(images, p1[0], finals, ctx, pool, dev, times,
                           qtables, entropy_passes=not per_image, codec=codec)


class _Searched(list):
    """The futures of a group whose bytes came from the device scan
    search, which reports its own passes."""


def _done(value) -> Future:
    f = Future()
    f.set_result(value)
    return f


def _device_search_serves(ctx: GroupCtx, geom) -> bool:
    """Whether the group takes the device scan search where the JAX
    package's batched route does: device_scanopt, progressive with the
    scan search and no script, Huffman, and a configuration and
    geometry scanopt_dev.supported covers."""
    cfg = ctx.cfg
    return (cfg.device_scanopt and cfg.progressive and cfg.optimize_scans
            and cfg.scan_script is None and not cfg.arithmetic
            and scanopt_dev.supported(cfg, ctx.cs, ctx.ncomps, geom))


def _finals(p1, ctx: GroupCtx, dev, b: int, times=None, record=None,
            loop_ris: bool = True):
    """The trellis passes of a group after p1 -> (the final (64, B*n)
    planes per component, each image's refit table list under
    trellis_q_opt or None)."""
    cfg = ctx.cfg
    if cfg.trellis_quant and cfg.arithmetic:
        finals = arith_trellis(p1, ctx, b, times)
    else:
        finals = _batch_rest(b, p1, ctx, dev, times, record,
                             loop_ris=loop_ris)
    qtables = None
    if cfg.trellis_quant and cfg.trellis_q_opt:
        with stage(times, "q_opt", dev):
            slots = qt_slots(cfg, ctx.cs, ctx.ncomps)
            ns, nc = q_opt_sums([m[1] for m in p1[1]], finals, b)
            qtables = [q_opt_tables(ns[i], nc[i], ctx.qtables, slots)
                       for i in range(b)]
    return finals, qtables


def _batch_p1(images, ctx: GroupCtx, dev, times=None,
              batched: bool = False):
    """Prep, the upload and p1 of one group -> (geom, merged, smalls,
    norms). With plane_pack the batched route's host-prepped buffers go
    up plane-packed (the JAX run_p1_batch_packed, taken under its
    conditions) and expand on the device, bit for bit."""
    cfg = ctx.cfg
    h, w = images[0].shape[:2]
    geom = geometry(w, h, ctx.samp)
    ris = trellis_ris(cfg, geom[2])
    dctm = cfg.dct_method.value
    if (cfg.host_prep and cfg.smoothing_factor == 0 and ctx.cs == "ycbcr"
            and cfg.precision == 8
            and tuple(ctx.samp[0]) in ((2, 2), (2, 1), (1, 1))):
        # host C++ colour conversion + downsampling halves the upload;
        # mj_prep_ycc downsamples exactly at 2x2, 2x1 and 1x1 only (other
        # ratios would take its 1x1 branch, which picks a sample instead
        # of averaging), so they take the device prep
        packed = batched and cfg.plane_pack
        with stage(times, "prep", dev):
            if packed:
                count_codec_route("plane_pack")
                geom, *up, total = pipeline_t.pack_ycc_batch(images,
                                                             ctx.samp)
                nbytes = sum(a.nbytes for a in up)
                xfer.add_h2d(nbytes)
                with stages.span("enc.upload", bytes=nbytes):
                    up = [torch.from_numpy(a.view(np.int32)).to(dev)
                          for a in up]
            else:
                geom, bufs = pipeline_t.prep_ycc_batch(images, ctx.samp)
                xfer.add_h2d(bufs.nbytes)
                with stages.span("enc.upload", bytes=bufs.nbytes):
                    bufs_t = torch.from_numpy(bufs).to(dev)
        with stage(times, "p1", dev):
            if packed:
                bufs_t = pipeline_t.unpack_ycc_batch(*up, total)
            merged, smalls, norms = pipeline_t.p1_batch_pre(
                bufs_t, tuple(geom[2]), ctx.qtables,
                cfg.overshoot_deringing, dctm, ris,
                qt_slots(cfg, ctx.cs, ctx.ncomps))
    else:
        with stage(times, "prep", dev):
            stack = np.stack(images)
            xfer.add_h2d(stack.nbytes)
            with stages.span("enc.upload", bytes=stack.nbytes):
                imgs_t = pipeline_t.to_samples(stack, dev)
        with stage(times, "p1", dev):
            merged, smalls, norms = pipeline_t.p1_batch(
                imgs_t, geom, ctx.cs, ctx.qtables,
                qt_slots(cfg, ctx.cs, ctx.ncomps),
                cfg.overshoot_deringing, dctm, ris, cfg.smoothing_factor,
                cfg.precision)
    return geom, merged, smalls, norms


def _trellis_comps(cfg, cs, comps):
    """The trellis's lastDC chains across the v block rows of one iMCU row
    (jccoefct.c:417-447), so for grayscale the declared sampling of
    gray_sample sets that granularity, while the pixel geometry stays
    full-rate."""
    if cs == "grayscale" and cfg.gray_sample and cfg.gray_sample[1] > 1:
        return ((comps[0]._replace(v=int(cfg.gray_sample[1])),)
                + tuple(comps[1:]))
    return tuple(comps)


def _host_ac_tables(hists, slots, opt: bool, b: int, dev):
    """Per component (B, 256) int32 AC code lengths on the device, from
    the downloaded (B, ncomps, 256) histograms (or the standard tables
    when Huffman optimization is off)."""
    out = []
    for ci, slot in enumerate(slots):
        tabs = [trellis.trellis_tables_from_hist(
            hists[i, ci] if opt else None, slot, opt)[0] for i in range(b)]
        out.append(torch.as_tensor(np.stack(tabs), device=dev))
    return out


def _batch_rest(b: int, p1, ctx: GroupCtx, dev, times=None, record=None,
                loop_ris: bool = False):
    """The trellis passes of one group -> the final (64, B*n) int16
    planes per component (the quantized ones without trellis). With
    loop_ris the statistics of the loops after the first are segmented
    at the restarts (the JAX per-image route), else not (its batched
    route).

    The rate tables come from the device-tablegen route where the JAX
    package takes it: the batched route's first loop, with optimized
    Huffman tables, YCbCr or grayscale, no use_scans_in_trellis and
    MJ_DEV_FIRST not 0 (its dev_first), builds them from p1's
    histograms on the device (ops/tablegen.py, one launch for every
    component and image), and every later loop from the device's band
    histograms (its dev_tables); the host never syncs on them. Otherwise
    the histograms come down and the native Annex K builds each table."""
    cfg, cs, ncomps = ctx.cfg, ctx.cs, ctx.ncomps
    geom, merged, smalls, norms = p1
    qs = tuple(m[0] for m in merged)
    if not cfg.trellis_quant:
        return qs
    raws = tuple(m[1] for m in merged)
    comps = geom[2]
    tcomps = _trellis_comps(cfg, cs, comps)
    slots = CS_INFO[cs][1][:ncomps]
    opt = cfg.optimize_coding
    nloops = max(1, cfg.trellis_num_loops)
    dev_first = (not loop_ris and opt and not cfg.use_scans_in_trellis
                 and cs in ("ycbcr", "grayscale")
                 and os.environ.get("MJ_DEV_FIRST", "1") != "0")
    cqt = pipeline_t.comp_qtables(ctx.qtables, qt_slots(cfg, cs, ncomps))
    with stage(times, "trellis_tables", dev):
        lams, dc_sis, qtblzz, ncands = [], [], [], []
        for ci in range(ncomps):
            lams.append(trellis.lambda_from_norm_t(
                norms[ci], cfg.lambda_log_scale1, cfg.lambda_log_scale2))
            dc_sis.append(derive_codes(STD_TABLES[(0, slots[ci])])[1]
                          .astype(np.int32))
            qz = np.asarray(cqt[ci]).reshape(64)[consts.JPEG_ZIGZAG] \
                .astype(np.int32)
            qtblzz.append(qz)
            ncands.append(trellis.get_num_dc_candidates(int(qz[0])))
        first_hists = (pipeline_t.download_hists(geom, smalls, b)
                       if opt and not cfg.use_scans_in_trellis
                       and not dev_first else None)
    if record is not None:
        record.setdefault("lambda", []).extend(zip(norms, lams))
    common = dict(batch=b, eob_opt=cfg.trellis_eob_opt,
                  delta_w=float(cfg.trellis_delta_dc_weight), times=times,
                  record=record, precision=cfg.precision)

    def run(cur, ac_sis, bands, dc_on):
        return trellis.trellis_all(tcomps, raws, cur, lams, ac_sis, dc_sis,
                                   qtblzz, ncands, bands=bands, dc_on=dc_on,
                                   **common)

    def tables(hists):
        with stage(times, "trellis_tables", dev):
            return _host_ac_tables(hists, slots, opt, b, dev)

    def dev_tables(hists):
        """Per component (B, 256) histograms on the device -> their rate
        tables, all components in one tablegen call."""
        with stage(times, "trellis_tables", dev):
            h = torch.cat(hists, 0)
            if record is not None:
                record.setdefault("tablegen", []).append(
                    tablegen.trellis_freqs(h))
            si = tablegen.trellis_rate_tables(h)
            return [si[ci * b:(ci + 1) * b] for ci in range(ncomps)]

    def band_hists(cur, ss, se, ris, host=False):
        """The current coefficients' per-component (B, 256) band
        histograms, or with `host` all of them in one download as
        (B, ncomps, 256) int32."""
        with stage(times, "trellis_hists", dev):
            hs = trellis.band_hists(cur, ss, se, b, ris)
            return torch.stack(hs, 1).cpu().numpy() if host else hs

    ris = trellis_ris(cfg, comps)
    if cfg.use_scans_in_trellis:
        # each band's statistics regather from the CURRENT coefficients
        # after the previous band's trellis; the DC trellis runs in band 0
        fs = cfg.trellis_freq_split
        cur = qs
        for _ in range(nloops):
            for bi, (ss, se) in enumerate(((1, fs), (fs + 1, 63))):
                hists = band_hists(cur, ss, se, ris, True) if opt else None
                cur = run(cur, tables(hists), ((ss, se),),
                          cfg.trellis_quant_dc and bi == 0)
        return cur
    ac_sis = (dev_tables(pipeline_t.hists_t(geom, smalls, b)) if dev_first
              else tables(first_hists))
    finals = run(qs, ac_sis, ((1, 63),), cfg.trellis_quant_dc)
    for _ in range(nloops - 1):
        if opt:
            # each loop regathers per-image rate statistics from the
            # previous loop's coefficients (jcmaster.c:1129-1139), with no
            # restart segmentation in the JAX batched route
            ac_sis = dev_tables(band_hists(finals, 1, 63,
                                           ris if loop_ris else None))
        finals = run(finals, ac_sis, ((1, 63),), cfg.trellis_quant_dc)
    return finals


def q_opt_sums(raws, finals, b: int):
    """trellis_q_opt's sums per image: raws and finals per component
    (64, B*n) (int32 unquantized x8, int16 final) -> (ns, nc), each
    (B, ncomps, 64) int64 on the host (one download): sum(src * coef) and
    sum(8 * coef^2) over each image's blocks, exact in int64."""
    sums = []
    for raw, fin in zip(raws, finals):
        src = raw.to(torch.int64).reshape(64, b, -1)
        coef = fin.to(torch.int64).reshape(64, b, -1)
        sums.append(torch.stack([(src * coef).sum(2),
                                 8 * (coef * coef).sum(2)]))
    s = torch.stack(sums).cpu().numpy()              # (ncomps, 2, 64, B)
    return s[:, 0].transpose(2, 0, 1), s[:, 1].transpose(2, 0, 1)


def q_opt_tables(ns, nc, qtables, slots) -> List[np.ndarray]:
    """trellis_q_opt (jcdctmgr.c:1299-1305, jcmaster.c:1014-1027): one
    image's (ncomps, 64) sums -> its table list with each used slot refit
    to the chosen levels, q[p] = round(sum(src * coef) / sum(8 * coef^2))
    clamped to 1..254 at the AC positions p with a nonzero denominator,
    the sums of the components sharing a slot added. The float64
    division of exact int64 sums matches the reference's double sums."""
    out = list(qtables)
    nsl = np.zeros((max(slots) + 1, 64), np.int64)
    ncl = np.zeros_like(nsl)
    for ci, slot in enumerate(slots):
        nsl[slot] += ns[ci]
        ncl[slot] += nc[ci]
    for slot in dict.fromkeys(slots):
        q = np.asarray(out[slot]).copy()
        for p in range(1, 64):
            if ncl[slot, p]:
                v = int(np.float64(nsl[slot, p]) / np.float64(ncl[slot, p])
                        + 0.5)
                j = consts.JPEG_ZIGZAG[p]
                q[j // 8, j % 8] = min(max(v, 1), 254)
        out[slot] = q
    return out


class ArithTrainer:
    """The adaptive coder whose states the arithmetic trellis reads
    (native arith.cpp, emission suppressed): rates() snapshots the -log2
    probabilities of its DC (64, 2) and AC (256, 2) states, train(row)
    codes one block row of chosen coefficients into it. The trellis pass
    is a one-component pseudo-scan, so every `rint` blocks (restarts in
    rows convert with the component's width) a restart resets the AC
    statistics, and the DC ones too unless the frame is progressive, as
    emit_restart does (jcarith.c:383-389); a reset lands after the row's
    rate snapshot."""

    def __init__(self, cfg, rint: int):
        self._lib = native.lib()
        self._ctx = self._lib.mj_arith_ctx_new()
        prog = cfg.progressive
        if cfg.scan_script is not None:
            # a custom script is progressive unless its first scan is
            # full-spectrum
            s0 = cfg.scan_script[0]
            prog = s0[1] != 0 or s0[2] != 63
        self._reset_dc = 0 if prog else 1
        self._rint = self._rtg = rint
        self._nrst = 0
        self._dc = np.empty((64, 2), np.float32)
        self._ac = np.empty((256, 2), np.float32)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._lib.mj_arith_ctx_free(self._ctx)

    def rates(self):
        self._lib.mj_arith_get_rates(self._ctx,
                                     self._dc.ctypes.data_as(native.f32p),
                                     self._ac.ctypes.data_as(native.f32p))
        return self._dc, self._ac

    def train(self, row):
        """row: (bw, 64) int16 blocks in zigzag order."""
        blk = np.ascontiguousarray(row, np.int16)
        bw, off = blk.shape[0], 0
        while off < bw:
            if self._rint and self._rtg == 0:
                self._lib.mj_arith_ctx_restart(self._ctx, self._nrst,
                                               self._reset_dc, 1)
                self._nrst = (self._nrst + 1) & 7
                self._rtg = self._rint
            take = min(bw - off, self._rtg) if self._rint else bw
            self._lib.mj_arith_train_rows(
                self._ctx, blk[off:off + take].ctypes.data_as(native.i16p),
                take, 0, 1, 5)
            off += take
            if self._rint:
                self._rtg -= take


def arith_trellis(p1, ctx: GroupCtx, b: int, times=None):
    """The arithmetic trellis of a group on its device (the JAX package's
    _phase_trellis arithmetic branch), image by image: per visited
    component a fresh coder; per iMCU row the coder's rates go up, the AC
    row trellis runs on the iMCU row's block rows at once (they share
    the snapshot) and the DC row trellis on its rows in pairs (their
    last DC chains through the iMCU row; trellis.arith_dc_imcu_row),
    then the rows come down and train the coder.
    -> the final (64, B*n) int16 planes per component. `times` (dict)
    gets the synchronised seconds of the row trellis on the device
    (trellis_arith_rows) and of the coder on the host with the rows'
    download (trellis_arith_coder)."""
    cfg, cs = ctx.cfg, ctx.cs
    geom, merged, _, norms = p1
    comps = geom[2]
    dev = merged[0][0].device
    tcomps = _trellis_comps(cfg, cs, comps)
    cqt = pipeline_t.comp_qtables(ctx.qtables,
                                  qt_slots(cfg, cs, ctx.ncomps))
    fs = cfg.trellis_freq_split
    band_defs = ([(1, fs), (fs + 1, 63)] if cfg.use_scans_in_trellis
                 else [(1, 63)])
    rint = trellis_ris(cfg, comps)
    finals = [m[0] for m in merged]
    for comp, band in trellis.arith_trellis_comps(
            ctx.ncomps, max(1, cfg.trellis_num_loops),
            cfg.use_scans_in_trellis):
        g = tcomps[comp]
        n = g.bh * g.bw
        ss, se = band_defs[band]
        qz = np.asarray(cqt[comp]).reshape(64)[consts.JPEG_ZIGZAG] \
            .astype(np.int32)
        q0 = int(qz[0])
        ltbl0 = float(np.float32(1.0 / (q0 * q0)))
        nc = trellis.get_num_dc_candidates(q0)
        qz_t = torch.as_tensor(qz, device=dev)
        raw = merged[comp][1]
        cur = finals[comp].clone()
        lam = trellis.lambda_from_norm_t(
            norms[comp], cfg.lambda_log_scale1, cfg.lambda_log_scale2)
        for img in range(b):
            with ArithTrainer(cfg, rint[comp] if rint else 0) as coder:
                for ri in range(-(-g.bh // g.v)):
                    with stage(times, "trellis_arith_coder", dev):
                        rate_dc, rate_ac = coder.rates()
                    r0, r1 = ri * g.v, min((ri + 1) * g.v, g.bh)
                    sl = slice(img * n + r0 * g.bw, img * n + r1 * g.bw)
                    with stage(times, "trellis_arith_rows", dev):
                        rows = trellis.arith_ac_row(raw[:, sl], cur[:, sl],
                                                    qz_t, lam[sl], rate_ac,
                                                    ss, se)
                        if cfg.trellis_quant_dc and band == 0:
                            rows[0] = trellis.arith_dc_imcu_row(
                                raw[0, sl].reshape(r1 - r0, g.bw), q0,
                                rate_dc, nc,
                                (lam[sl] * ltbl0).reshape(r1 - r0, g.bw)) \
                                .reshape(-1).to(torch.int16)
                        cur[:, sl] = rows
                    with stage(times, "trellis_arith_coder", dev):
                        host = rows.t().cpu().numpy()
                        for k in range(r1 - r0):
                            coder.train(host[k * g.bw:(k + 1) * g.bw])
        finals[comp] = cur
    return tuple(finals)


def _batch_host(images, geom, finals, ctx: GroupCtx, pool, dev,
                times=None, qtables=None, entropy_passes: bool = True,
                codec=None):
    """Download (through `codec`, _dispatch_download's), dummy blocks,
    then each image's entropy stage on the pool, each task in a copy of
    the caller's context (its reporter); qtables: each image's own table
    list (trellis_q_opt), else the group's. entropy_passes counts one
    pass per image (the batched route's). A traced call records the
    download's bytes and, on the pool, each image's span with the ns it
    queued."""
    b = len(images)
    with stage(times, "download", dev) as sp:
        before = xfer.snapshot() if sp else None
        per_image = _entropy_planes(geom, finals, b, ctx.cfg.device_entropy,
                                    codec, ctx.cfg.precision)
        if sp:
            sp.set(bytes=xfer.delta(before)[1])
    if entropy_passes:
        report.add_passes(b)
    with stage(times, "host_entropy", dev) as sp:
        futs = [pool.submit(contextvars.copy_context().run, _entropy_task,
                            i, sp.now(), img.shape[1], img.shape[0], geom,
                            planes, ctx._replace(qtables=qtables[i])
                            if qtables else ctx)
                for i, (img, planes) in enumerate(zip(images, per_image))]
        if times is not None:
            for f in futs:
                f.result()
    return futs


def _entropy_task(index: int, submitted: Optional[int], *args) -> bytes:
    """entropy_image(*args) on a pool thread; in a traced call inside the
    span "enc.entropy_image" with the image's index in its group and the
    ns from its submission (stamped at `submitted`) to its start."""
    with stages.span("enc.entropy_image", image=index) as sp:
        if submitted is not None:
            sp.set(queued_ns=sp.start - submitted)
        return entropy_image(*args)


def encode_raw_yuv(planes, width: int, height: int, samp,
                   config: Optional[EncoderConfig] = None, device=None,
                   **overrides) -> bytes:
    """Encode pre-subsampled component planes (jpeg_write_raw_data,
    tj3CompressFromYUV8), byte-identical to the JAX package's
    encode_raw_yuv: no colour conversion or downsampling, but the whole
    mozjpeg pass machinery (deringing, trellis, scan search).
    planes: 1 (gray) or 3 (YCbCr) (ph, pw) uint8 arrays at
    tjPlaneWidth/Height; samp: [(h, v), ...] per component; device as
    in encode. Each plane is padded on the host out to its block grid by
    replicating its last row and column, goes up, and p1, the trellis
    (the per-image route's, the AC kernel on the card) and the download
    run on the device; the host codes the coefficients."""
    dev = _device(device)
    if config is None:
        config = EncoderConfig(**overrides)
    cfg = config.resolved()
    ncomps = len(planes)
    cs = "grayscale" if ncomps == 1 else "ycbcr"
    ctx = GroupCtx(cfg, config.profile, cs, ncomps, [tuple(s) for s in samp],
                   make_qtables(cfg))
    geom = geometry(width, height, ctx.samp)
    comps = geom[2]
    ups = []
    for pl, g in zip(planes, comps):
        pl = np.asarray(pl)
        ph, pw = pl.shape
        buf = np.zeros((g.bh * 8, g.bw * 8), pl.dtype)
        ch, cw = min(ph, g.bh * 8), min(pw, g.bw * 8)
        buf[:ch, :cw] = pl[:ch, :cw]
        if cw < g.bw * 8:
            buf[:ch, cw:] = buf[:ch, cw - 1:cw]
        if ch < g.bh * 8:
            buf[ch:] = buf[ch - 1:ch]
        ups.append(pipeline_t.to_samples(buf[None], dev))
    merged, smalls, norms = pipeline_t._p1_planes(
        ups, comps, pipeline_t.comp_qtables(ctx.qtables, qt_slots(
            cfg, cs, ncomps)), cfg.overshoot_deringing,
        cfg.dct_method.value, trellis_ris(cfg, comps), cfg.precision)
    finals, qtables = _finals((geom, merged, smalls, norms), ctx, dev, 1)
    if qtables:
        ctx = ctx._replace(qtables=qtables[0])
    out = _entropy_planes(geom, finals, 1, cfg.device_entropy)[0]
    return entropy_image(width, height, geom, out, ctx)


class DualPlane(np.ndarray):
    """A host coefficient plane that carries its twin on the device
    (`.dev`, (bh_pad, bw_pad, 64) int16): the host coder reads the
    array, the device bit packers (ops/bitpack.py) the twin, so no scan
    uploads its plane again."""
    dev = None


def _dispatch_download(finals, b: int, cfg):
    """The batched route's coefficient download codec, packed on the
    device as soon as the trellis is done (the tail of the JAX
    _batch_rest): the Huffman transport with coef_transport, else the
    exact sparse pack with sparse_download, else None (dense)."""
    if cfg.coef_transport:
        count_codec_route("transport")
        return "transport", transport.pack_batch(finals, b,
                                                 precision=cfg.precision)
    if cfg.sparse_download:
        count_codec_route("sparse")
        return "sparse", sparsepack.pack_planes_exact(finals, b)
    return None


def _fetch_planes(geom, finals, b: int, codec=None, precision: int = 8):
    """The JAX _batch_fetch's download chain -> per image the real-block
    (bh, bw, 64) int16 planes of each component: the transport; where
    its header flags an overflow, one pack again at the larger capacity
    (scap 32); where that overflows too, the exact sparse pack; where
    that overflows (or with no codec), the dense planes. Which step
    delivers follows from the data, and each pack made is counted in
    codec_routes."""
    comps = geom[2]
    if codec is not None and codec[0] == "transport":
        fetched = transport.fetch(codec[1])
        if fetched is None:
            count_codec_route("transport_scap32")
            fetched = transport.fetch(transport.pack_batch(
                finals, b, scap=32, precision=precision))
        planes = (None if fetched is None else
                  transport.decode_to_planes(*fetched, b, comps, precision))
        if planes is not None:
            return planes
        count_codec_route("sparse")
        codec = "sparse", sparsepack.pack_planes_exact(finals, b)
    if codec is not None:
        header, words, nt, _ = codec[1]
        fetched = sparsepack.fetch_exact(header, words, nt)
        planes = (None if fetched is None else
                  sparsepack.expand_flat_to_planes(*fetched[:3], nt, b,
                                                   comps))
        if planes is not None:
            return planes
    count_codec_route("dense")
    packed = pipeline_t.pack_all_batch(finals, b)
    # the blocking copy, which also waits for the device's queue
    with stages.span("enc.download_copy", bytes=packed.nbytes):
        flat = xfer.to_host(packed)
    xfer.add_d2h(flat.nbytes)
    return pipeline_t.split_flat_batch(geom, flat, b)


def _entropy_planes(geom, finals, b: int, twins: bool = False, codec=None,
                    precision: int = 8):
    """The group's final planes downloaded (_fetch_planes) -> per image
    the padded (bh_pad, bw_pad, 64) int16 planes of the host entropy
    stage, iMCU dummy blocks added on the host; with `twins`
    (device_entropy) each a DualPlane whose twin stays on the device."""
    comps = geom[2]
    out = [[pipeline_t.add_dummy_blocks_host(p, g)
            for p, g in zip(planes, comps)]
           for planes in _fetch_planes(geom, finals, b, codec, precision)]
    if twins:
        dev_planes = pipeline_t.planes_t(finals, geom, b)
        for i, planes in enumerate(out):
            for ci, p in enumerate(planes):
                planes[ci] = p.view(DualPlane)
                planes[ci].dev = dev_planes[ci][i]
    return out


# ---------------------------------------------------------------------------
# Host entropy and marker assembly (the JAX package's _phase_entropy)
# ---------------------------------------------------------------------------

class ScanResult(NamedTuple):
    scan: scans.ScanInfo
    data: bytes
    dc_tables: Dict[int, HuffTable]   # {tbl_idx: table} this scan uses
    ac_tables: Dict[int, HuffTable]
    dc_tbls: Dict[int, int]           # {comp: tbl_idx}
    ac_tbls: Dict[int, int]
    restart: int


# host routes the device engines took on inputs they do not cover: a
# scan emission whose table is absent, a device scan search that needed
# the host search (chip_smoke.py holds both to 0 on its photos)
engine_host_routes = {"emit": 0, "search": 0}
# the transfer routes taken, one count a pack made: the plane-packed
# upload, the transport download, its repack at the larger capacity,
# the exact sparse download and the dense download (_fetch_planes)
codec_routes = {"plane_pack": 0, "transport": 0, "transport_scap32": 0,
                "sparse": 0, "dense": 0}
_ROUTES_LOCK = threading.Lock()


def count_host_route(kind: str):
    with _ROUTES_LOCK:
        engine_host_routes[kind] += 1


def reset_host_routes():
    for k in engine_host_routes:
        engine_host_routes[k] = 0


def count_codec_route(kind: str):
    with _ROUTES_LOCK:
        codec_routes[kind] += 1


def reset_codec_routes():
    for k in codec_routes:
        codec_routes[k] = 0


def _emit_scan_device(sg, dc_tbls, ac_tbls, dc_tables, ac_tables,
                      restart: int):
    """The scan's entropy data from the device's restart-parallel bit
    packers (ops/bitpack.py): sequential full-band scans and every
    progressive scan kind, byte-identical to the serial host coder.
    None where a table the scan needs is absent."""
    scan = sg.scan
    planes = [sg.planes[ci] for ci, _, _ in sg.entries]
    geoms = [(h, v) for _, h, v in sg.entries]
    if scan.Ss == 0 and scan.Se == 63:               # sequential
        dc_codes, ac_codes = [], []
        for ci, _, _ in sg.entries:
            dt = dc_tables.get(dc_tbls.get(ci, 0))
            at = ac_tables.get(ac_tbls.get(ci, 0))
            if dt is None or at is None:
                return None
            dc_codes.append(derive_codes(dt))
            ac_codes.append(derive_codes(at))
        return bitpack.encode_scan_bitpar(planes, geoms, sg.mcus_x,
                                          sg.mcus_y, restart, dc_codes,
                                          ac_codes)
    dc_codes = ac_codes = None
    if scan.Ss == 0 and scan.Ah == 0:                # DC first
        dc_codes = []
        for ci, _, _ in sg.entries:
            dt = dc_tables.get(dc_tbls.get(ci, 0))
            if dt is None:
                return None
            dc_codes.append(derive_codes(dt))
    elif scan.Ss != 0:                               # AC first or refine
        at = ac_tables.get(ac_tbls.get(scan.comps[0], 0))
        if at is None:
            return None
        ac_codes = [derive_codes(at)]
    return bitpack.encode_scan_progressive_device(
        planes, geoms, sg.mcus_x, sg.mcus_y, scan.Ss, scan.Se, scan.Ah,
        scan.Al, restart, dc_tables=dc_codes, ac_tables=ac_codes)


def _device_emit_ok(sg) -> bool:
    """The device packers take every progressive scan and the
    sequential full-band one."""
    scan = sg.scan
    if scan.Ss == 0 and scan.Se == 63:
        return scan.Ah == 0 and scan.Al == 0
    return True


def _emit(sg, dc_tbls, ac_tbls, dc_tables, ac_tables, restart: int,
          device: bool) -> bytes:
    """The scan's data from the device packers when `device` (the host
    coder where they return None, counted), else the host coder."""
    if device and _device_emit_ok(sg):
        data = _emit_scan_device(sg, dc_tbls, ac_tbls, dc_tables,
                                 ac_tables, restart)
        if data is not None:
            return data
        count_host_route("emit")
    return entenc.encode_scan(sg, dc_tbls, ac_tbls, dc_tables, ac_tables,
                              restart)[0]


def _count_scan(sp, sg, data: bytes, gather_ns: int, emit_ns: int):
    """Add one scan's counters to a traced call's open span: ns in its
    statistics pass (scan_gather_ns) and its emission (scan_emit_ns), the
    blocks it codes (scan_blocks) and its entropy-coded bytes
    (scan_bytes)."""
    sp.add(scan_gather_ns=gather_ns, scan_emit_ns=emit_ns,
           scan_blocks=sum(sg.mcus_x * sg.mcus_y * h * v
                           for _, h, v in sg.entries),
           scan_bytes=len(data))


def encode_scan_optimal(sg, dc_tbls, ac_tbls, restart: int,
                        device: bool = False) -> ScanResult:
    """Gather the scan's statistics, build optimal tables, emit it (on
    the device with `device`). In a traced call the open span (the
    image's "enc.entropy_image") sums the scan's counters."""
    scan = sg.scan
    sp = stages.current()
    t0 = sp.now() if sp is not None else 0
    _, dcc, acc = entenc.encode_scan(sg, dc_tbls, ac_tbls, {}, {}, restart,
                                     gather=True)
    gather_ns = sp.now() - t0 if sp is not None else 0
    dc_tables: Dict[int, HuffTable] = {}
    ac_tables: Dict[int, HuffTable] = {}
    for ci in scan.comps:
        if scan.Ss == 0 and scan.Ah == 0:
            t = dc_tbls[ci]
            if t not in dc_tables and dcc[t].any():
                dc_tables[t] = entenc.gen_optimal_table(dcc[t])
        if scan.Se > 0:
            t = ac_tbls[ci]
            if t not in ac_tables and acc[t].any():
                ac_tables[t] = entenc.gen_optimal_table(acc[t])
    t1 = sp.now() if sp is not None else 0
    data = _emit(sg, dc_tbls, ac_tbls, dc_tables, ac_tables, restart,
                 device)
    if sp is not None:
        _count_scan(sp, sg, data, gather_ns, sp.now() - t1)
    return ScanResult(scan, data, dc_tables, ac_tables, dc_tbls, ac_tbls,
                      restart)


def encode_scan_fixed(sg, dc_tbls, ac_tbls, dc_tables, ac_tables,
                      restart: int, device: bool = False) -> ScanResult:
    """Emit the scan with the given (standard) tables. In a traced call
    the open span sums the scan's counters (no statistics pass: 0 ns)."""
    scan = sg.scan
    used_dc = {dc_tbls[ci]: dc_tables[dc_tbls[ci]] for ci in scan.comps
               if scan.Ss == 0 and scan.Ah == 0 and dc_tbls[ci] in dc_tables}
    used_ac = {ac_tbls[ci]: ac_tables[ac_tbls[ci]] for ci in scan.comps
               if scan.Se > 0 and ac_tbls[ci] in ac_tables}
    sp = stages.current()
    t0 = sp.now() if sp is not None else 0
    data = _emit(sg, dc_tbls, ac_tbls, dc_tables, ac_tables, restart,
                 device)
    if sp is not None:
        _count_scan(sp, sg, data, 0, sp.now() - t0)
    return ScanResult(scan, data, used_dc, used_ac, dc_tbls, ac_tbls,
                      restart)


def _frame_header(w, width: int, height: int, geom, qtables, ncomps: int,
                  sof_code: int, multi_dqt: bool, precision: int, cs: str,
                  slots, extra_markers, density, write_jfif: bool,
                  sof_samp):
    """SOI through SOF: JFIF or Adobe APP14, the extra markers, the quant
    tables of the components' slots and the frame header."""
    comps = geom[2]
    comp_ids = CS_INFO[cs][2]
    w.soi()
    # JFIF only for YCbCr and gray; Adobe APP14 flags RGB/CMYK/YCCK
    # (jcmarker.c:649-663, jcparam.c:600-638)
    if cs in ("ycbcr", "grayscale"):
        if write_jfif:
            w.jfif_app0(unit=density[0], xd=density[1], yd=density[2])
    else:
        w.adobe_app14(2 if cs == "ycck" else 0)
    for code, payload in (extra_markers or ()):
        w.segment(code, payload)
    # tables in component order, deduplicated on first use
    # (jcmarker.c write_frame_header walks comp_info)
    used_qt = list(dict.fromkeys(slots[:ncomps]))
    if multi_dqt:
        w.dqt_multi([(i, qtables[i]) for i in used_qt])
    else:
        for i in used_qt:
            w.dqt(i, qtables[i])
    # sof_samp: the declared sampling factors where they differ from the
    # geometry's (grayscale gray_sample, rdswitch.c:610-642)
    sof_samp = sof_samp or [(comps[ci].h, comps[ci].v)
                            for ci in range(ncomps)]
    w.sof(sof_code, precision, height, width,
          [(comp_ids[ci], sof_samp[ci][0], sof_samp[ci][1], slots[ci])
           for ci in range(ncomps)])


def assemble(width: int, height: int, geom, qtables, scan_results,
             progressive: bool, ncomps: int, multi_dqt: bool = True,
             precision: int = 8, cs: str = "ycbcr", extra_markers=None,
             density=(0, 1, 1), write_jfif: bool = True,
             sof_samp=None, slots=None) -> bytes:
    """Write the markers and scans into the JPEG byte stream; slots: the
    components' quant slots (the colorspace's by default)."""
    comp_ids = CS_INFO[cs][2]
    w = marker.MarkerWriter()
    # 8-bit sequential is baseline SOF0, >8-bit SOF1
    sof_code = (marker.SOF2 if progressive
                else (marker.SOF0 if precision == 8 else marker.SOF1))
    _frame_header(w, width, height, geom, qtables, ncomps, sof_code,
                  multi_dqt, precision, cs, slots or CS_INFO[cs][0],
                  extra_markers, density, write_jfif, sof_samp)
    sent_dc: Dict[int, HuffTable] = {}
    sent_ac: Dict[int, HuffTable] = {}
    last_dri = 0
    for sr in scan_results:
        scan = sr.scan
        # per scan component its DC table, then its AC table (jcmarker.c
        # order); the non-FASTEST profile merges them into one DHT
        entries = []
        for ci in scan.comps:
            for cls, t, tbl, sent in (
                    (0, sr.dc_tbls[ci], sr.dc_tables.get(sr.dc_tbls[ci]),
                     sent_dc),
                    (1, sr.ac_tbls[ci], sr.ac_tables.get(sr.ac_tbls[ci]),
                     sent_ac)):
                if tbl is not None and sent.get(t) != tbl:
                    entries.append((cls, t, tbl))
                    sent[t] = tbl
        if multi_dqt:
            w.dht_multi(entries)
        else:
            for c, t, tbl in entries:
                w.dht(c, t, tbl)
        if sr.restart != last_dri:
            w.dri(sr.restart)
            last_dri = sr.restart
        # unused table fields are written as 0 (jcmarker.c:511-518)
        w.sos([(comp_ids[ci],
                sr.dc_tbls[ci] if scan.Ss == 0 and scan.Ah == 0 else 0,
                sr.ac_tbls[ci] if scan.Se else 0)
               for ci in scan.comps], scan.Ss, scan.Se, scan.Ah, scan.Al)
        w.raw(sr.data)
    w.eoi()
    return w.bytes()


def entropy_image(width: int, height: int, geom, planes,
                  ctx: GroupCtx) -> bytes:
    """One image's padded (bh_pad, bw_pad, 64) int16 planes -> its JPEG
    bytes: the scan search (progressive with optimize_scans, gray or
    YCbCr; native unless MJ_NATIVE_SCANSEARCH=0, as in the JAX package,
    its candidates coded on the process's search workers beside those of
    every other search in flight), or the scans of a script emitted one
    by one, a pass each."""
    cfg, cs, ncomps = ctx.cfg, ctx.cs, ctx.ncomps
    extra = ((marker.icc_chunks(cfg.icc) if cfg.icc else [])
             + list(ctx.extra_markers)) or None
    slots = _frame_slots(ctx)
    if cfg.arithmetic:
        return _entropy_arith(width, height, geom, planes, ctx, extra)
    ycbcr = cs == "ycbcr"
    progressive = cfg.progressive
    if cfg.scan_script is not None:
        # a custom script is progressive unless its first scan is
        # full-spectrum (jcmaster.c validate_script)
        script = [scans.ScanInfo(tuple(s[0]), *s[1:])
                  for s in cfg.scan_script]
        progressive = script[0].Ss != 0 or script[0].Se != 63
    elif cfg.progressive:
        if cfg.optimize_scans and (ncomps == 1 or (ncomps == 3 and ycbcr)):
            if os.environ.get("MJ_NATIVE_SCANSEARCH", "1") != "0":
                return scanopt.encode_optimize_scans_native(
                    width, height, geom, planes, ctx.qtables, cfg, ncomps,
                    slots, cfg.precision, extra_markers=extra)
            return scanopt.encode_optimize_scans(
                width, height, geom, planes, ctx.qtables, cfg, ncomps,
                slots, cfg.precision, extra)
        if ctx.profile == Profile.MAX_COMPRESSION or cfg.optimize_scans:
            # the scan search bails for non-YCbCr multi-component images
            # (jcparam.c:753-756) to the simple script
            script = scans.simple_progression_max(
                ncomps, cfg.dc_scan_opt_mode, ycbcr)
        else:
            script = scans.simple_progression_legacy(ncomps, ycbcr)
    else:
        script = scans.baseline_script(ncomps)

    tbl_slots = CS_INFO[cs][1]
    dc_tbls = {ci: tbl_slots[ci] for ci in range(ncomps)}
    ac_tbls = dict(dc_tbls)
    results = []
    report.add_passes(len(script))
    dev = cfg.device_entropy and cfg.precision <= 12
    for scan in script:
        sg = entenc.ScanGeometry(scan, geom, planes)
        r = scan_restart_interval(cfg, scan, geom)
        if cfg.optimize_coding or progressive:
            results.append(encode_scan_optimal(sg, dc_tbls, ac_tbls, r,
                                               dev))
        else:
            std_dc = {s: STD_TABLES[(0, s)] for s in tbl_slots[:ncomps]}
            std_ac = {s: STD_TABLES[(1, s)] for s in tbl_slots[:ncomps]}
            results.append(encode_scan_fixed(sg, dc_tbls, ac_tbls, std_dc,
                                             std_ac, r, dev))
        report.pass_done("scan %d-%d" % (scan.Ss, scan.Se))
    return assemble(width, height, geom, ctx.qtables, results, progressive,
                    ncomps, multi_dqt=ctx.profile != Profile.FASTEST,
                    precision=cfg.precision, cs=cs, extra_markers=extra,
                    density=cfg.density, write_jfif=cfg.write_jfif,
                    sof_samp=_gray_sof_samp(cfg, cs), slots=slots)


def _frame_slots(ctx: GroupCtx) -> tuple:
    """The quant slot per component that the frame header names."""
    return (tuple(ctx.slots) if ctx.slots is not None
            else tuple(qt_slots(ctx.cfg, ctx.cs, ctx.ncomps)))


def _gray_sof_samp(cfg, cs):
    return ([tuple(cfg.gray_sample)]
            if cs == "grayscale" and cfg.gray_sample else None)


def _entropy_arith(width: int, height: int, geom, planes, ctx: GroupCtx,
                   extra) -> bytes:
    """Arithmetic-coded scans (SOF9 or SOF10, a DAC marker before every
    scan) -> the JPEG bytes (the JAX package's _entropy_arith). A
    progressive frame takes the scan search where it runs, else the
    profile's script or a custom one; a sequential frame one scan."""
    cfg, cs, ncomps = ctx.cfg, ctx.cs, ctx.ncomps
    ycbcr = cs == "ycbcr"
    if cfg.progressive:
        if cfg.scan_script is not None:
            script = [scans.ScanInfo(tuple(s[0]), *s[1:])
                      for s in cfg.scan_script]
        elif cfg.optimize_scans and (ncomps == 1 or (ncomps == 3 and ycbcr)):
            # the scan search runs with the arithmetic coder too
            # (jcparam.c:739-742)
            return scanopt.encode_optimize_scans(
                width, height, geom, planes, ctx.qtables, cfg, ncomps,
                _frame_slots(ctx), 8, extra, arith=True)
        elif ctx.profile == Profile.MAX_COMPRESSION:
            script = scans.simple_progression_max(
                ncomps, cfg.dc_scan_opt_mode, ycbcr)
        else:
            script = scans.simple_progression_legacy(ncomps, ycbcr)
    else:
        script = scans.baseline_script(ncomps)
    tbl_slots = CS_INFO[cs][1]
    dc_tbls = {ci: tbl_slots[ci] for ci in range(ncomps)}
    ac_tbls = dict(dc_tbls)
    comp_ids = CS_INFO[cs][2]
    w = marker.MarkerWriter()
    _frame_header(w, width, height, geom, ctx.qtables, ncomps,
                  marker.SOF10 if cfg.progressive else marker.SOF9,
                  ctx.profile != Profile.FASTEST, 8, cs,
                  _frame_slots(ctx), extra, cfg.density,
                  cfg.write_jfif, _gray_sof_samp(cfg, cs))
    last_dri = 0
    for scan in script:
        r = scan_restart_interval(cfg, scan, geom)
        entries = arith.dac_entries(scan, dc_tbls, ac_tbls)
        if entries:
            w.dac(entries)
        if r != last_dri:
            w.dri(r)
            last_dri = r
        w.sos([(comp_ids[ci],
                dc_tbls[ci] if scan.Ss == 0 and scan.Ah == 0 else 0,
                ac_tbls[ci] if scan.Se else 0)
               for ci in scan.comps], scan.Ss, scan.Se, scan.Ah, scan.Al)
        w.raw(arith.encode_scan_arith(scan, geom, planes, dc_tbls, ac_tbls,
                                      r))
    w.eoi()
    return w.bytes()

