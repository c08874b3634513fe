"""Batched encode: prep -> device p1 -> device trellis -> dense download
-> host scan search or scan emission, and marker assembly.

Port of mozjpeg_tpu/codec/encoder.py's batched path (_fast_ctx and what
it runs): encode_many groups the images by shape into batches of up to 8
(fewer for large frames) and runs each group through

  _batch_p1    host prep (native mj_prep_ycc, YCbCr without smoothing) or
               device prep (colour conversion, smoothing, downsampling),
               one upload, p1 on the device;
  _batch_rest  the trellis passes: the AC-first histograms come down, the
               host builds the rate tables, and the device runs lambda,
               the rate LUT, the AC trellis kernel, the EOB-run DP and the
               DC trellis (the JAX package's host-tablegen route, byte-
               identical to its default); use_scans_in_trellis and
               trellis_num_loops regather histograms on the device and
               download them once per pass;
  _batch_host  one dense download, iMCU dummy blocks on the host, then
               per image on a thread pool (which overlaps the next group's
               device work) the native scan search, or the script's scans
               emitted one by one, and the markers.

The slice is the JAX package's whole batched surface at 8 bits: gray,
YCbCr, RGB, CMYK and YCCK; any subsampling; islow, ifast and float DCTs;
smoothing; restart intervals; sequential, progressive, custom and FASTEST
scripts with optimized or standard Huffman tables; every trellis option
but trellis_q_opt; quant tables, ICC and density. What it does not carry
raises NotImplementedError naming the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import consts
from ..entropy import encode as entenc
from ..entropy.huffman import HuffTable, derive_codes
from . import marker, pipeline_t, scanopt, scans, trellis
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


def resolve_group(image, config: Optional[EncoderConfig] = None,
                  **overrides) -> GroupCtx:
    """The context of a group of images shaped like `image` (the JAX
    package's _resolve); raises NotImplementedError for what this slice
    does not carry."""
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
    _check_slice(image, cfg, cs, ncomps)
    sub = tuple(cfg.subsampling)
    if cs == "ycbcr":
        samp = [sub, (1, 1), (1, 1)]
    elif cs == "ycck":
        samp = [sub, (1, 1), (1, 1), sub]   # Y and K full rate
    else:
        samp = [(1, 1)] * ncomps
    return GroupCtx(cfg, config.profile, cs, ncomps, samp, make_qtables(cfg))


def _check_slice(image, cfg, cs, ncomps):
    """Refuse what this slice does not carry, naming the ROADMAP.md item
    (queue 1) that brings it."""
    def no(what, item):
        raise NotImplementedError(
            "mozjpeg_tpu_torch: %s is not ported yet (ROADMAP.md queue 1 "
            "item %s)" % (what, item))

    if image.dtype != np.uint8:
        no("input other than uint8 samples", "4.2")
    if cfg.precision != 8:
        no("12-bit precision", "4.2")
    if cfg.arithmetic:
        no("arithmetic coding", "4.1")
    if cfg.trellis_q_opt:
        no("trellis_q_opt", "4.1")
    if qt_slots(cfg, cs, ncomps) != CS_INFO[cs][0][:ncomps]:
        no("quant slots other than the colorspace's", "4.1")
    if cfg.device_entropy or cfg.device_scanopt:
        no("the device entropy and scan-search engines", "7")
    if cfg.sparse_download or cfg.plane_pack or cfg.coef_transport:
        no("the transfer codecs", "8")
    max_mp = float(os.environ.get("MJ_BATCH_MAX_MP", "48.0"))
    if image.shape[0] * image.shape[1] > max_mp * 1e6:
        no("images over MJ_BATCH_MAX_MP megapixels (row sharding)", "9")


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
    """Encode uint8 images, (H, W) gray or (H, W, C) with C = 3 (RGB) or
    4 (CMYK), to JPEG bytes, byte-identical to mozjpeg_tpu.encode_many.
    device: None or "cuda" (the default, the GPU; raises without one) or
    "cpu" (the kernels' plain versions)."""
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
    p1 = _batch_p1(images, ctx, dev, times)
    finals = _batch_rest(images, p1, ctx, dev, times, record)
    return _batch_host(images, p1[0], finals, ctx, pool, dev, times)


def _batch_p1(images, ctx: GroupCtx, dev, times=None):
    cfg = ctx.cfg
    h, w = images[0].shape[:2]
    geom = geometry(w, h, ctx.samp)
    ris = trellis_ris(cfg, geom[2])
    dctm = cfg.dct_method.value
    if (cfg.host_prep and cfg.smoothing_factor == 0 and ctx.cs == "ycbcr"
            and tuple(ctx.samp[0]) in ((2, 2), (2, 1), (1, 1))):
        # host C++ colour conversion + downsampling halves the upload;
        # mj_prep_ycc downsamples exactly at 2x2, 2x1 and 1x1 only (other
        # ratios would take its 1x1 branch, which picks a sample instead
        # of averaging), so they take the device prep
        with stage(times, "prep", dev):
            geom, bufs = pipeline_t.prep_ycc_batch(images, ctx.samp)
            bufs_t = torch.from_numpy(bufs).to(dev)
        with stage(times, "p1", dev):
            merged, smalls, norms = pipeline_t.p1_batch_pre(
                bufs_t, tuple(geom[2]), ctx.qtables,
                cfg.overshoot_deringing, dctm, ris)
    else:
        with stage(times, "prep", dev):
            imgs_t = torch.from_numpy(np.stack(images)).to(dev)
        with stage(times, "p1", dev):
            merged, smalls, norms = pipeline_t.p1_batch(
                imgs_t, geom, ctx.cs, ctx.qtables,
                qt_slots(cfg, ctx.cs, ctx.ncomps),
                cfg.overshoot_deringing, dctm, ris, cfg.smoothing_factor)
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


def _batch_rest(images, p1, ctx: GroupCtx, dev, times=None, record=None):
    """The trellis passes of one group -> the final (64, B*n) int16
    planes per component (the quantized ones without trellis)."""
    cfg, cs, ncomps = ctx.cfg, ctx.cs, ctx.ncomps
    b = len(images)
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
                       if opt and not cfg.use_scans_in_trellis else None)
    if record is not None:
        record.setdefault("lambda", []).extend(zip(norms, lams))
    common = dict(batch=b, eob_opt=cfg.trellis_eob_opt,
                  delta_w=float(cfg.trellis_delta_dc_weight), times=times,
                  record=record)

    def run(cur, ac_sis, bands, dc_on):
        return trellis.trellis_all(tcomps, raws, cur, lams, ac_sis, dc_sis,
                                   qtblzz, ncands, bands=bands, dc_on=dc_on,
                                   **common)

    def tables(hists):
        with stage(times, "trellis_tables", dev):
            return _host_ac_tables(hists, slots, opt, b, dev)

    def band_hists(cur, ss, se, ris):
        """The current coefficients' band histograms, all components in
        one download -> (B, ncomps, 256) int32."""
        with stage(times, "trellis_hists", dev):
            hs = trellis.band_hists(cur, ss, se, b, ris)
            return torch.stack(hs, 1).cpu().numpy()

    ris = trellis_ris(cfg, comps)
    if cfg.use_scans_in_trellis:
        # each band's statistics regather from the CURRENT coefficients
        # after the previous band's trellis; the DC trellis runs in band 0
        fs = cfg.trellis_freq_split
        cur = qs
        for _ in range(nloops):
            for bi, (ss, se) in enumerate(((1, fs), (fs + 1, 63))):
                hists = band_hists(cur, ss, se, ris) if opt else None
                cur = run(cur, tables(hists), ((ss, se),),
                          cfg.trellis_quant_dc and bi == 0)
        return cur
    ac_sis = tables(first_hists)
    finals = run(qs, ac_sis, ((1, 63),), cfg.trellis_quant_dc)
    for _ in range(nloops - 1):
        if opt:
            # each loop regathers per-image rate statistics from the
            # previous loop's coefficients (jcmaster.c:1129-1139), with no
            # restart segmentation, as the JAX dev_tables route
            ac_sis = tables(band_hists(finals, 1, 63, None))
        finals = run(finals, ac_sis, ((1, 63),), cfg.trellis_quant_dc)
    return finals


def _batch_host(images, geom, finals, ctx: GroupCtx, pool, dev,
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
        futs = [pool.submit(entropy_image, img.shape[1], img.shape[0], geom,
                            planes, ctx, nthreads)
                for img, planes in zip(images, per_image)]
        if times is not None:
            for f in futs:
                f.result()
    return futs


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


def encode_scan_optimal(sg, dc_tbls, ac_tbls, restart: int) -> ScanResult:
    """Gather the scan's statistics, build optimal tables, emit it."""
    scan = sg.scan
    _, dcc, acc = entenc.encode_scan(sg, dc_tbls, ac_tbls, {}, {}, restart,
                                     gather=True)
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
    data, _, _ = entenc.encode_scan(sg, dc_tbls, ac_tbls, dc_tables,
                                    ac_tables, restart)
    return ScanResult(scan, data, dc_tables, ac_tables, dc_tbls, ac_tbls,
                      restart)


def encode_scan_fixed(sg, dc_tbls, ac_tbls, dc_tables, ac_tables,
                      restart: int) -> ScanResult:
    """Emit the scan with the given (standard) tables."""
    scan = sg.scan
    used_dc = {dc_tbls[ci]: dc_tables[dc_tbls[ci]] for ci in scan.comps
               if scan.Ss == 0 and scan.Ah == 0 and dc_tbls[ci] in dc_tables}
    used_ac = {ac_tbls[ci]: ac_tables[ac_tbls[ci]] for ci in scan.comps
               if scan.Se > 0 and ac_tbls[ci] in ac_tables}
    data, _, _ = entenc.encode_scan(sg, dc_tbls, ac_tbls, dc_tables,
                                    ac_tables, restart)
    return ScanResult(scan, data, used_dc, used_ac, dc_tbls, ac_tbls,
                      restart)


def assemble(width: int, height: int, geom, qtables, scan_results,
             progressive: bool, ncomps: int, multi_dqt: bool = True,
             precision: int = 8, cs: str = "ycbcr", extra_markers=None,
             density=(0, 1, 1), write_jfif: bool = True,
             sof_samp=None) -> bytes:
    """Write the markers and scans into the JPEG byte stream (the
    colorspace's own quant slots, the only ones this slice carries)."""
    _, _, comps = geom
    slots, _, comp_ids = CS_INFO[cs]
    w = marker.MarkerWriter()
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
    # 8-bit sequential is baseline SOF0, >8-bit SOF1
    sof_code = (marker.SOF2 if progressive
                else (marker.SOF0 if precision == 8 else marker.SOF1))
    # sof_samp: the declared sampling factors where they differ from the
    # geometry's (grayscale gray_sample, rdswitch.c:610-642)
    sof_samp = sof_samp or [(comps[ci].h, comps[ci].v)
                            for ci in range(ncomps)]
    w.sof(sof_code, precision, height, width,
          [(comp_ids[ci], sof_samp[ci][0], sof_samp[ci][1], slots[ci])
           for ci in range(ncomps)])
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


def entropy_image(width: int, height: int, geom, planes, ctx: GroupCtx,
                  nthreads: int = 1) -> bytes:
    """One image's padded (bh_pad, bw_pad, 64) int16 planes -> its JPEG
    bytes: the native scan search (progressive with optimize_scans, gray
    or YCbCr), or the scans of a script emitted one by one."""
    cfg, cs, ncomps = ctx.cfg, ctx.cs, ctx.ncomps
    extra = marker.icc_chunks(cfg.icc) if cfg.icc else None
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
            return scanopt.encode_optimize_scans_native(
                width, height, geom, planes, ctx.qtables, cfg, ncomps,
                cfg.precision, nthreads, extra)
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
    for scan in script:
        sg = entenc.ScanGeometry(scan, geom, planes)
        r = scan_restart_interval(cfg, scan, geom)
        if cfg.optimize_coding or progressive:
            results.append(encode_scan_optimal(sg, dc_tbls, ac_tbls, r))
        else:
            std_dc = {s: STD_TABLES[(0, s)] for s in tbl_slots[:ncomps]}
            std_ac = {s: STD_TABLES[(1, s)] for s in tbl_slots[:ncomps]}
            results.append(encode_scan_fixed(sg, dc_tbls, ac_tbls, std_dc,
                                             std_ac, r))
    sof_samp = ([tuple(cfg.gray_sample)]
                if cs == "grayscale" and cfg.gray_sample else None)
    return assemble(width, height, geom, ctx.qtables, results, progressive,
                    ncomps, multi_dqt=ctx.profile != Profile.FASTEST,
                    precision=cfg.precision, cs=cs, extra_markers=extra,
                    density=cfg.density, write_jfif=cfg.write_jfif,
                    sof_samp=sof_samp)

