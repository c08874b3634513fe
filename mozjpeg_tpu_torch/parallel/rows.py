"""Single-image scale-out: iMCU-row sharding over a mesh of devices.

Port of mozjpeg_tpu/parallel/rows.py. The reference is a sequential
single-image pipeline; its only intra-image parallelism is the restart
interval (RST markers reset the DC predictor and byte-align the stream).
So one large image's iMCU rows are split over the mesh, each shard of
whole restart segments: every shard runs the pixel pipeline (colour
conversion, downsampling, dering, DCT, quantization, the trellis) on its
band, the symbol histograms are summed over the shards so the optimal
Huffman tables are global, and each shard's restart segments are
bit-packed on its device and stitched on the host with correctly
numbered RSTn markers.

Byte-exact contract: the output equals the single-device encoder's for
the same configuration with restart_in_rows=restart_rows (held in
tests/test_torch_parallel.py).

Each shard reads its band of the host image (the last one shorter)
and pads it as the single-device pipeline pads the whole image
(pipeline_t.prep_planes: jcprepct's two stages, so a vertically
downsampled chroma plane replicates its last real row); the iMCU dummy
blocks of the global geometry, which only the last shard holds, are
written there (layout.add_dummy_blocks).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import consts
from ..codec import marker, pipeline_t, scans, trellis
from ..codec.config import EncoderConfig, Profile, scan_restart_interval
from ..codec.encoder import ScanResult, assemble, make_qtables
from ..codec.pipeline import geometry
from ..entropy import encode as entenc
from ..entropy.huffman import derive_codes
from ..ops import bitpack, layout, symbols
from .batch import Mesh, make_mesh


def _rows_mesh(mesh: Optional[Mesh], mcus_y: int, restart_rows: int = 1,
               mcus_x: int = 1) -> Mesh:
    """A 'rows' mesh whose size divides the image's iMCU row count and
    whose rows per shard are a multiple of restart_rows (segments must
    not cross shards); the other entries stay idle. A single shard is
    always valid, so this never fails: e.g. when restart_rows does not
    divide mcus_y, or when the DRI interval would pass the 16-bit cap
    and segments could not align."""
    mesh = mesh if mesh is not None else make_mesh()
    n = mesh.size
    if restart_rows * mcus_x > 65535:
        n = 1
    while n > 1 and (mcus_y % n or (mcus_y // n) % restart_rows):
        n -= 1
    return mesh.take(n, "rows")


def _shard_prep(image: np.ndarray, s: int, mcus_x: int, rps: int,
                geom_s, dev) -> List[torch.Tensor]:
    """Shard s's band of the host image -> per component (1, bh*8,
    bw_pad*8) planes on dev."""
    ph = rps * 8 * geom_s[0].v
    band = torch.from_numpy(np.ascontiguousarray(
        image[s * ph:(s + 1) * ph][None])).to(dev)
    return pipeline_t.prep_planes(
        band, (mcus_x, rps, geom_s), "grayscale" if image.ndim == 2
        else "ycbcr")


def _block_plane(zz: torch.Tensor, g, real_bh: int, s: int) -> torch.Tensor:
    """Shard s's (64, bh*bw) coefficients of one component -> (bh,
    bw_pad, 64) int16 with the dummy columns and the global geometry's
    bottom dummy rows (real_bh: the image's real block rows; every shard
    holds at least one)."""
    n_real = min(g.bh, real_bh - s * g.bh)
    z = layout.add_dummy_blocks_t(zz[:, :n_real * g.bw], g.bw, n_real,
                                  g.bw_pad, g.bh, g.h, g.v)
    return z.reshape(64, g.bh, g.bw_pad).permute(1, 2, 0) \
        .to(torch.int16).contiguous()


def _seq_hists(planes, comps, mcus_x: int, rps: int, r: int):
    """A shard's sequential-scan (2, 256) AC and DC counts (slot 0 luma,
    1 chroma), DC predictors reset every r MCUs; comps give the
    components' sampling factors."""
    ac = torch.zeros((2, 256), dtype=torch.int32, device=planes[0].device)
    dc = torch.zeros_like(ac)
    for ci, (pl, g) in enumerate(zip(planes, comps)):
        slot = 0 if ci == 0 else 1
        ac[slot] += symbols.ac_histogram(pl.reshape(-1, 64))
        dc[slot] += symbols.dc_histogram_restart(pl, g.h, g.v, mcus_x, rps,
                                                 r)
    return ac, dc


def make_row_sharded_p1(mesh: Mesh, width: int, height: int,
                        samp: List[Tuple[int, int]], restart_rows: int):
    """The sharded pixel -> coefficient step: step(image, qluma, qchroma)
    with the host image -> ({local shard: per comp (bh_s, bw_pad, 64)
    int16 planes on its device}, global (2, 256) AC and DC histograms,
    int64). The sum over the shards makes one optimal Huffman table set
    cover the whole image (the distributed analog of jchuff.c:100-101).
    -> (step, (mcus_x, mcus_y, geom), rows per shard)."""
    ndev = mesh.size
    mcus_x, mcus_y, geom = geometry(width, height, samp)
    if mcus_y % ndev:
        raise ValueError("iMCU rows %d %% devices %d != 0" % (mcus_y, ndev))
    rps = mcus_y // ndev
    _, _, geom_s = geometry(width, rps * 8 * geom[0].v, samp)
    r = min(restart_rows * mcus_x, 65535)

    def step(image, qluma, qchroma):
        planes, ac, dc = {}, {}, {}
        for s in mesh.local():
            ps = _shard_prep(image, s, mcus_x, rps, geom_s, mesh.devices[s])
            planes[s] = [
                _block_plane(pipeline_t.quantize_comp(
                    p, g, qluma if ci == 0 else qchroma, False)[0], g,
                    geom[ci].bh, s)
                for ci, (p, g) in enumerate(zip(ps, geom_s))]
            ac[s], dc[s] = _seq_hists(planes[s], geom_s, mcus_x, rps, r)
        return planes, mesh.psum(ac, (2, 256)), mesh.psum(dc, (2, 256))

    return step, (mcus_x, mcus_y, geom), rps


def _optimal_table(counts):
    f = np.zeros(257, np.int64)
    f[:256] = np.asarray(counts)
    return entenc.gen_optimal_table(f)


def _samp_of(image, subsampling):
    if image.ndim == 2:
        return [(1, 1)], 1
    if tuple(subsampling) not in ((2, 2), (2, 1), (1, 1)):
        raise NotImplementedError(
            "row-sharded encode supports 4:2:0/4:2:2/4:4:4, got %r"
            % (subsampling,))
    return [subsampling, (1, 1), (1, 1)], 3


def _join(parts: Dict[int, bytes], nshards: int) -> bytes:
    """The shards' parts in shard order (all of them local)."""
    return b"".join(parts[s] for s in sorted(parts))


def _sequential(w: int, h: int, geom, qt, ncomp: int, planes, ac_g, dc_g,
                ndev: int, rps: int, restart_rows: int, multi_dqt: bool,
                collect_bytes=_join) -> bytes:
    """The sequential scan of the sharded planes with the global optimal
    tables: each shard's restart segments packed on its device
    (ops/bitpack.encode_scan_bitpar), stitched by collect_bytes(parts,
    ndev), and the markers."""
    mcus_x, _, comps = geom
    ac_g, dc_g = ac_g.cpu().numpy(), dc_g.cpu().numpy()
    nt = min(ncomp, 2)
    dc_tables = {t: _optimal_table(dc_g[t]) for t in range(nt)}
    ac_tables = {t: _optimal_table(ac_g[t]) for t in range(nt)}
    tbls = {ci: (0 if ci == 0 else 1) for ci in range(ncomp)}
    codes = [derive_codes(dc_tables[tbls[ci]]) for ci in range(ncomp)]
    acodes = [derive_codes(ac_tables[tbls[ci]]) for ci in range(ncomp)]
    r = min(restart_rows * mcus_x, 65535)
    segs_per_shard = (rps * mcus_x) // r
    parts = {s: bitpack.encode_scan_bitpar(
        planes[s], [(g.h, g.v) for g in comps], mcus_x, rps, r, codes,
        acodes, rst_offset=s * segs_per_shard, trailing_rst=(s != ndev - 1))
        for s in sorted(planes)}
    sr = ScanResult(scans.baseline_script(ncomp)[0],
                    collect_bytes(parts, ndev),
                    dc_tables, ac_tables, tbls, dict(tbls), r)
    return assemble(w, h, geom, qt, [sr], False, ncomp,
                    multi_dqt=multi_dqt,
                    cs="grayscale" if ncomp == 1 else "ycbcr")


def _baseline_front(image, quality, mesh, restart_rows, subsampling):
    """The baseline encoders' config, rows mesh and sharded p1 ->
    (ndev, rps, geom, qt, ncomp, planes, ac_g, dc_g)."""
    if restart_rows < 1:
        raise ValueError("restart_rows must be >= 1 (shard independence)")
    h, w = image.shape[:2]
    samp, ncomp = _samp_of(image, subsampling)
    mcus_x0, mcus_y0, _ = geometry(w, h, samp)
    mesh = _rows_mesh(mesh, mcus_y0, restart_rows, mcus_x0)
    step, geom, rps = make_row_sharded_p1(mesh, w, h, samp, restart_rows)
    cfg = EncoderConfig(quality=quality, profile=Profile.FASTEST,
                        progressive=False, optimize_coding=True,
                        optimize_scans=False, trellis_quant=False,
                        overshoot_deringing=False, subsampling=subsampling,
                        restart_in_rows=restart_rows).resolved()
    qt = make_qtables(cfg)
    planes, ac_g, dc_g = step(image, qt[0], qt[1 if len(qt) > 1 else 0])
    return mesh.size, rps, geom, qt, ncomp, planes, ac_g, dc_g


def encode_row_sharded(image: np.ndarray, quality: float = 75.0,
                       mesh: Optional[Mesh] = None, restart_rows: int = 1,
                       subsampling: Tuple[int, int] = (2, 2)) -> bytes:
    """Encode ONE image with its iMCU rows sharded over the mesh (default:
    every visible card).

    Sequential baseline scan with globally optimal Huffman tables and
    restart_rows MCU rows per restart interval (the segment boundary that
    makes shards independent). subsampling: (2,2)/(2,1)/(1,1), or a 2-D
    image for grayscale. Returns the complete JPEG."""
    h, w = image.shape[:2]
    (ndev, rps, geom, qt, ncomp, planes, ac_g,
     dc_g) = _baseline_front(image, quality, mesh, restart_rows, subsampling)
    return _sequential(w, h, geom, qt, ncomp, planes, ac_g, dc_g, ndev, rps,
                       restart_rows, False)


# ---------------------------------------------------------------------------
# Row-sharded TRELLIS encode: the full mozjpeg rate-distortion path across
# the mesh, in stages with host table-building between them:
#   A. pixels -> per shard (q, raw, lambda) coefficient-major + summed
#      AC-first histograms (the trellis pseudo-scan statistics,
#      jcmaster.c:451-468)
#   B. per shard the trellis (AC kernel + DC trellis) with the GLOBAL
#      rate tables, then block-major planes with the dummy blocks
#   C. per scan: summed statistics, restart-segment device bit packing
#      per shard, host stitching
# Shard boundaries are iMCU rows: the AC DP is per block, the DC trellis
# chains only within an iMCU row, and the trellis statistics segments are
# single component rows (restart_in_rows), so no state crosses shards and
# the output is byte-exact against the single-device encoder.
# ---------------------------------------------------------------------------

def _shard_p1_trellis(mesh: Mesh, image, geom, geom_s, cfg, rps: int, q81):
    """Stage A: each local shard's band -> per comp (q_zz (64, n) int16,
    raw_zz (64, n) int32, lambda (n,) f32) on its device, and per comp
    the AC-first histograms summed over the shards. The global dummy
    rows live in the last shard only and must not count, so its last
    statistics segment (which may hold real rows too) is replaced by the
    histogram of its real prefix, as the single-device gather sees a
    partial final segment."""
    mcus_x, _, comps = geom
    ndev = mesh.size
    rr = cfg.restart_in_rows
    ris = tuple(min(rr * g.bw, 65535) for g in comps)
    nfake = [g.bh * ndev - c.bh for g, c in zip(geom_s, comps)]
    if any(nf > 0 and rr * g.bw > 65535 for nf, g in zip(nfake, geom_s)):
        raise NotImplementedError(
            "sharded trellis stats need row-aligned restart segments "
            "(interval exceeds the 16-bit cap)")
    outs = {}
    hists = [{} for _ in comps]
    for s in mesh.local():
        planes = _shard_prep(image, s, mcus_x, rps, geom_s, mesh.devices[s])
        outs[s] = []
        for ci, (p, g) in enumerate(zip(planes, geom_s)):
            q_zz, raw_zz, norm, hist = pipeline_t.p1_comp(
                p, g, q81[ci], cfg.overshoot_deringing, 1, "islow", ris[ci])
            hist = hist[0]
            if nfake[ci] > 0 and s == ndev - 1:
                tail_rows = (g.bh - 1) % rr + 1
                tail = q_zz[:, -tail_rows * g.bw:]
                hist = hist - symbols.ac_first_histogram_t(tail)
                if tail_rows > nfake[ci]:
                    hist = hist + symbols.ac_first_histogram_t(
                        tail[:, :(tail_rows - nfake[ci]) * g.bw])
            hists[ci][s] = hist
            lam = trellis.lambda_from_norm_t(norm, cfg.lambda_log_scale1,
                                             cfg.lambda_log_scale2)
            outs[s].append((q_zz.to(torch.int16), raw_zz, lam))
    return outs, [mesh.psum(hh, (256,)) for hh in hists]


def _shard_trellis_run(mesh: Mesh, outs, hists, geom_s, comps, cfg, qt):
    """Stage B: the rate tables from the global histograms (host), then
    per local shard the trellis (codec/trellis.trellis_all: the AC
    kernel once per component, the DC trellis) -> {shard: per comp (bh_s,
    bw_pad, 64) int16 planes with the dummy blocks}."""
    ac_sis, dc_sis, qtblzz, ncands = [], [], [], []
    for ci, hist in enumerate(hists):
        slot = 0 if ci == 0 else 1
        ac_si, dc_si = trellis.trellis_tables_from_hist(
            hist.cpu().numpy(), slot, cfg.optimize_coding)
        ac_sis.append(ac_si)
        dc_sis.append(dc_si)
        qz = np.asarray(qt[min(slot, len(qt) - 1)]).reshape(64)[
            consts.JPEG_ZIGZAG].astype(np.int32)
        qtblzz.append(qz)
        ncands.append(trellis.get_num_dc_candidates(int(qz[0])))
    planes = {}
    for s in sorted(outs):
        dev = mesh.devices[s]
        cur = [o[0] for o in outs[s]]
        raws = [o[1] for o in outs[s]]
        lams = [o[2] for o in outs[s]]
        ac_t = [torch.as_tensor(a[None], device=dev) for a in ac_sis]
        for _ in range(max(1, cfg.trellis_num_loops)):
            cur = trellis.trellis_all(
                geom_s, raws, cur, lams, ac_t, dc_sis, qtblzz, ncands, 1,
                dc_on=cfg.trellis_quant_dc, eob_opt=cfg.trellis_eob_opt,
                delta_w=float(cfg.trellis_delta_dc_weight),
                precision=cfg.precision)
        planes[s] = [_block_plane(c, g, comps[ci].bh, s)
                     for ci, (c, g) in enumerate(zip(cur, geom_s))]
    return planes


def _trellis_front(image, quality, mesh, restart_rows, subsampling,
                   progressive):
    """The front half of the sharded trellis encoders: config, qtables,
    the rows mesh, stage A, the global rate tables and stage B -> (cfg,
    qt, ncomp, mesh, rps, geom, {local shard: per comp planes})."""
    if restart_rows < 1:
        raise ValueError("restart_rows must be >= 1 (shard independence)")
    h, w = image.shape[:2]
    samp, ncomp = _samp_of(image, subsampling)
    mcus_x, mcus_y, comps = geometry(w, h, samp)
    mesh = _rows_mesh(mesh, mcus_y, restart_rows, mcus_x)
    cfg = EncoderConfig(quality=quality, progressive=progressive,
                        optimize_scans=False, trellis_quant=True,
                        overshoot_deringing=True, optimize_coding=True,
                        subsampling=subsampling,
                        restart_in_rows=restart_rows).resolved()
    qt = make_qtables(cfg)
    rps = mcus_y // mesh.size
    if mesh.size > 1 and rps % restart_rows:
        raise ValueError("rows per shard %d %% restart_rows %d != 0"
                         % (rps, restart_rows))
    _, _, geom_s = geometry(w, rps * 8 * comps[0].v, samp)
    q81 = [qt[0 if ci == 0 else min(1, len(qt) - 1)] for ci in range(ncomp)]
    outs, hists = _shard_p1_trellis(mesh, image, (mcus_x, mcus_y, comps),
                                    geom_s, cfg, rps, q81)
    planes = _shard_trellis_run(mesh, outs, hists, geom_s, comps, cfg, qt)
    return cfg, qt, ncomp, mesh, rps, (mcus_x, mcus_y, comps), planes


def _trellis_sequential(image, quality, mesh, restart_rows, subsampling,
                        collect_bytes=_join) -> bytes:
    """The sequential trellis encode over the front's planes (shared by
    the one- and the multi-process encoders)."""
    h, w = image.shape[:2]
    (cfg, qt, ncomp, mesh, rps, geom,
     planes) = _trellis_front(image, quality, mesh, restart_rows,
                              subsampling, progressive=False)
    mcus_x, _, comps = geom
    r = min(restart_rows * mcus_x, 65535)
    ac, dc = {}, {}
    for s in planes:
        ac[s], dc[s] = _seq_hists(planes[s], comps, mcus_x, rps, r)
    return _sequential(w, h, geom, qt, ncomp, planes,
                       mesh.psum(ac, (2, 256)), mesh.psum(dc, (2, 256)),
                       mesh.size, rps, restart_rows, True, collect_bytes)


def encode_row_sharded_trellis(image: np.ndarray, quality: float = 75.0,
                               mesh: Optional[Mesh] = None,
                               restart_rows: int = 1,
                               subsampling: Tuple[int, int] = (2, 2)
                               ) -> bytes:
    """Full mozjpeg-quality trellis encode of ONE image, iMCU rows sharded
    over the mesh: overshoot deringing, AC+DC trellis quantization with
    globally summed rate statistics, optimal Huffman tables from global
    histograms, restart-parallel device bit packing. Sequential baseline
    scan output; byte-exact against the single-device encoder with the
    same config."""
    return _trellis_sequential(image, quality, mesh, restart_rows,
                               subsampling)


def encode_row_sharded_progressive(image: np.ndarray, quality: float = 75.0,
                                   mesh: Optional[Mesh] = None,
                                   restart_rows: int = 1,
                                   subsampling: Tuple[int, int] = (2, 2)
                                   ) -> bytes:
    """Progressive mozjpeg encode (simple_progression 9-scan script +
    AC/DC trellis + deringing + per-scan optimal tables) of ONE image,
    iMCU rows sharded over the mesh. Every scan's statistics sum over the
    shards and every scan's restart segments bit-pack on each shard's
    device. Byte-exact against the single-device encoder with the same
    config (= mozjpeg -fastcrush with -restart N rows)."""
    h, w = image.shape[:2]
    (cfg, qt, ncomp, mesh, rps, geom,
     planes) = _trellis_front(image, quality, mesh, restart_rows,
                              subsampling, progressive=True)
    codec = _ShardScanCodec(cfg, ncomp, mesh.size, rps, geom, planes)
    return _progressive_rows(cfg, qt, ncomp, geom, codec, w, h)


def _progressive_rows(cfg, qt, ncomp, geom, codec, w, h,
                      collect_bytes=_join) -> bytes:
    """Fixed-script progressive emission over row shards (shared by the
    one- and the multi-process encoders)."""
    script = scans.simple_progression_max(ncomp, cfg.dc_scan_opt_mode, True)
    results = []
    for scan in script:
        r_scan = scan_restart_interval(cfg, scan, geom)
        dch, ach = codec.gather(scan, r_scan)
        dc_tables = {t: _optimal_table(hh) for t, hh in dch.items()
                     if hh.any()}
        ac_tables = {t: _optimal_table(hh) for t, hh in ach.items()
                     if hh.any()}
        dc_codes, ac_codes = codec.codes(scan, dc_tables, ac_tables)
        parts, _ = codec.emit(scan, r_scan, dc_codes, ac_codes)
        results.append(ScanResult(scan, collect_bytes(parts, codec.ndev),
                                  dc_tables,
                                  ac_tables, codec.dc_tbls, codec.ac_tbls,
                                  r_scan))
    return assemble(w, h, geom, qt, results, True, ncomp, multi_dqt=True,
                    cs="grayscale" if ncomp == 1 else "ycbcr")


class _ShardScanCodec:
    """Per-scan statistics and emission over a (possibly partial) set of
    row shards, with a reduction hook so the one-process path (every
    shard local, identity) and the multi-process path (local shards
    only, an all_reduce) share one implementation.

    local_shards: {global shard index: per comp (bh_s, bw_pad, 64) int16
    planes on the shard's device}; reduce_sum(a) returns the elementwise
    sum of the int64 host array `a` over every process. Each shard holds
    whole restart segments, at whose boundaries every scan's EOB runs and
    DC predictors reset, so each shard's counts are its exact share of
    the sequential gather's."""

    def __init__(self, cfg, ncomp: int, ndev: int, rps: int, geom,
                 local_shards, reduce_sum=None):
        self.cfg = cfg
        self.ncomp = ncomp
        self.ndev = ndev
        self.rps = rps
        self.geom = geom
        self.shards = local_shards
        self.reduce = reduce_sum if reduce_sum is not None else (
            lambda a: a)
        self.dc_tbls = {ci: (0 if ci == 0 else 1) for ci in range(ncomp)}
        self.ac_tbls = dict(self.dc_tbls)

    def _real_rows(self, ci: int, s: int) -> int:
        g = self.geom[2][ci]
        sh_rows = self.rps * g.v       # block rows per shard for comp ci
        return max(0, min(sh_rows, g.bh - s * sh_rows))

    def gather(self, scan, r_scan):
        """-> (dc hists {slot: (256,)}, ac hists {slot: (256,)}) int64,
        summed over every shard."""
        mcus_x, _, comps = self.geom
        if scan.Ss == 0 and scan.Ah == 0:      # DC first (interleaved)
            acc = np.zeros((2, 256), np.int64)
            for ci in scan.comps:
                g = comps[ci]
                for pls in self.shards.values():
                    acc[self.dc_tbls[ci]] += symbols.dc_histogram_restart(
                        pls[ci], g.h, g.v, mcus_x, self.rps, r_scan,
                        Al=scan.Al).cpu().numpy()
            acc = self.reduce(acc)
            return {t: acc[t] for t in (0, 1)}, {}
        if scan.Ss == 0:
            return {}, {}                      # DC refine: no stats
        ci = scan.comps[0]
        g = comps[ci]
        kind = bitpack.AcFirst if scan.Ah == 0 else bitpack.AcRefine
        hist = np.zeros(256, np.int64)
        for s, pls in self.shards.items():
            real_rows = self._real_rows(ci, s)
            if real_rows <= 0:
                continue
            n = real_rows * g.bw
            r = r_scan or n
            band = bitpack.Band(pls[ci], real_rows, g.bw, scan.Ss, scan.Se,
                                -(-n // r) * r)
            hist += kind(band, scan.Al, r).hist().sum(0).cpu().numpy()
        return {}, {self.ac_tbls[ci]: self.reduce(hist)}

    def codes(self, scan, dc_tables, ac_tables):
        """The scan's (ehufco, ehufsi) per component for the packers."""
        dc_codes = ([derive_codes(dc_tables[self.dc_tbls[ci]])
                     for ci in scan.comps] if dc_tables else None)
        ac_codes = ([derive_codes(ac_tables[self.ac_tbls[scan.comps[0]]])]
                    if ac_tables else None)
        return dc_codes, ac_codes

    def _seg_layout(self, scan, r_scan):
        """Per shard (nseg, rst_offset, last?) in global shard order."""
        mcus_x, _, comps = self.geom
        out = {}
        rst_off = 0
        last_s = -1
        for s in range(self.ndev):
            if scan.Ss == 0:
                nseg = (-(-(mcus_x * self.rps) // r_scan)
                        if r_scan else 1)
            else:
                real_rows = self._real_rows(scan.comps[0], s)
                if real_rows <= 0:
                    continue
                g = comps[scan.comps[0]]
                nseg = (-(-(g.bw * real_rows) // r_scan)
                        if r_scan else 1)
            last_s = s
            out[s] = [nseg, rst_off, False]
            rst_off += nseg
        if last_s >= 0:
            out[last_s][2] = True
        return out

    def emit(self, scan, r_scan, dc_codes, ac_codes):
        """-> ({global shard: entropy bytes}, local length sum)."""
        mcus_x, _, comps = self.geom
        layout_ = self._seg_layout(scan, r_scan)
        parts = {}
        for s, pls in sorted(self.shards.items()):
            if s not in layout_:
                continue
            nseg, rst_off, last = layout_[s]
            if scan.Ss == 0:
                pl = [pls[ci] for ci in scan.comps]
                gs = [(comps[ci].h, comps[ci].v) for ci in scan.comps]
                smx, smy = mcus_x, self.rps
            else:
                ci = scan.comps[0]
                g = comps[ci]
                real_rows = self._real_rows(ci, s)
                pl = [pls[ci][:real_rows, :g.bw]]
                gs = [(1, 1)]
                smx, smy = g.bw, real_rows
            parts[s] = bitpack.encode_scan_progressive_device(
                pl, gs, smx, smy, scan.Ss, scan.Se, scan.Ah, scan.Al,
                r_scan, dc_tables=dc_codes, ac_tables=ac_codes,
                rst_offset=rst_off, trailing_rst=not last)
        return parts, sum(len(p) for p in parts.values())


def _scanopt_rows(cfg, qt, ncomp, ndev, rps, geom, codec, w, h,
                  sum_scalar=None, collect_bytes=_join) -> bytes:
    """Row-sharded jpegrescan search (jcmaster.c:773-962 select_scans):
    candidate sizes are global sums of the shards' entropy lengths
    (restart alignment makes the shards' parts exact byte slices), the
    greedy selection replays identically in every process, and the
    winning scans are stitched from the shard parts in display order.
    The one- and the multi-process encoders share this body; the hooks
    sum scalars / collect winner bytes across processes."""
    from ..codec.scanopt import SearchLayout, _run_selection, display_order

    sum_scalar = sum_scalar or (lambda v: v)
    mcus_x, mcus_y, comps = geom
    script = scans.search_progression(ncomp, cfg.dc_scan_opt_mode)
    slayout = SearchLayout(ncomp)
    comp_ids = [1, 2, 3][:ncomp]

    fh = marker.MarkerWriter()
    fh.dqt_multi([(i, qt[i]) for i in range(min(ncomp, 2))])
    fh.sof(marker.SOF2, cfg.precision, h, w,
           [(comp_ids[ci], comps[ci].h, comps[ci].v,
             0 if ci == 0 else 1) for ci in range(ncomp)])
    frame_header = fh.bytes()

    bufs = {}
    dri_state = [0]

    def get_size(sn, scan):
        r = scan_restart_interval(cfg, scan, geom)
        dch, ach = codec.gather(scan, r)
        dc_tables = {t: _optimal_table(hh) for t, hh in dch.items()
                     if hh.any()}
        ac_tables = {t: _optimal_table(hh) for t, hh in ach.items()
                     if hh.any()}
        hdr = marker.MarkerWriter()
        if sn == 0:
            hdr.raw(frame_header)
        entries = []
        seen = set()
        for ci in scan.comps:
            if scan.Ss == 0 and scan.Ah == 0:
                t = codec.dc_tbls[ci]
                if t in dc_tables and ("d", t) not in seen:
                    entries.append((0, t, dc_tables[t]))
                    seen.add(("d", t))
            if scan.Se > 0:
                t = codec.ac_tbls[ci]
                if t in ac_tables and ("a", t) not in seen:
                    entries.append((1, t, ac_tables[t]))
                    seen.add(("a", t))
        hdr.dht_multi(entries)
        if r != dri_state[0]:
            hdr.dri(r)
            dri_state[0] = r
        hdr.sos([(comp_ids[ci],
                  codec.dc_tbls[ci] if scan.Ss == 0 and scan.Ah == 0
                  else 0,
                  codec.ac_tbls[ci] if scan.Se else 0)
                 for ci in scan.comps], scan.Ss, scan.Se, scan.Ah,
                scan.Al)
        parts, local_len = codec.emit(
            scan, r, *codec.codes(scan, dc_tables, ac_tables))
        bufs[sn] = (hdr.bytes(), parts)
        return (len(hdr.bytes()) - (len(frame_header) if sn == 0 else 0)
                + int(sum_scalar(local_len)))

    res = _run_selection(slayout, script, get_size)
    order = display_order(slayout, res, cfg.dc_scan_opt_mode)

    out = marker.MarkerWriter()
    out.soi()
    if cfg.write_jfif:
        out.jfif_app0(unit=cfg.density[0], xd=cfg.density[1],
                      yd=cfg.density[2])
    for idx in order:
        hdr, parts = bufs[idx]
        out.raw(hdr)
        out.raw(collect_bytes(parts, ndev))
    out.eoi()
    return out.bytes()


def encode_row_sharded_scanopt(image: np.ndarray, quality: float = 75.0,
                               mesh: Optional[Mesh] = None,
                               restart_rows: int = 1,
                               subsampling: Tuple[int, int] = (2, 2)
                               ) -> bytes:
    """FULL mozjpeg-default encode (progressive + AC/DC trellis +
    deringing + jpegrescan optimize_scans) of ONE image with its iMCU
    rows sharded over the mesh. Byte-exact against the single-device
    encoder with the same config (= cjpeg default with -restart N)."""
    h, w = image.shape[:2]
    (cfg, qt, ncomp, mesh, rps, geom,
     planes) = _trellis_front(image, quality, mesh, restart_rows,
                              subsampling, progressive=True)
    codec = _ShardScanCodec(cfg, ncomp, mesh.size, rps, geom, planes)
    return _scanopt_rows(cfg, qt, ncomp, mesh.size, rps, geom, codec, w, h)
