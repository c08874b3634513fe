"""jpegrescan-style scan optimization (optimize_scans).

Port of mozjpeg_tpu/codec/scanopt.py. With Huffman coding the whole
candidate sweep, greedy selection and stitching run in C++
(native/scansearch.cpp mj_scan_search, GIL released, the candidates
coded on the process's one set of native workers, native.search_workers,
which every search in flight shares), each candidate scan with its own
restart interval; Python writes the frame header around the stitched
scans (encode_optimize_scans_native). With
the arithmetic coder, which the native search does not carry, or with
MJ_NATIVE_SCANSEARCH=0, the same search runs in Python
(encode_optimize_scans): each candidate scan is coded from the resident
coefficient planes, the greedy state machine picks the winners in the
reference's trial order with its early exits (_run_selection), and the
winners are stitched in display order (mozjpeg jcmaster.c:773-962
select_scans, jcparam.c:734-852, and jcparam.c:739-742 for the search
under -arithmetic). The search runs for grayscale and YCbCr frames only
(jcparam.c:753-756).

Progress and trace (codec/report.py) as in the JAX package: the native
search is one pass, the Python search one pass per candidate scan, and
both trace each stitched scan's SCAN line. In a traced call
(codec/stages.py) the native search's counters (native.SEARCH_STATS:
candidates read, ns gathering, building tables, emitting, stitching,
candidates coded ahead and those never read) go to the open span.

Both frame headers name the components' quant slots (the
configuration's, or the source's for a transcode) and write their tables in component
order. The JAX package writes slots 0 and 1 there whatever -qslots says,
so for a non-default qslots with the search its bytes differ from the
port's (ROADMAP.md, Faults).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import native
from ..entropy import encode as entenc
from . import arith, marker, report, scans, stages
from .config import CS_INFO, scan_restart_interval
from .scans import ScanInfo

AL_MAX_LUMA = scans.AL_MAX_LUMA                  # 3
AL_MAX_CHROMA = scans.AL_MAX_CHROMA              # 2
NUM_FREQ_SPLITS = len(scans.FREQUENCY_SPLITS)    # 5


def encode_optimize_scans_native(width: int, height: int, geom, planes,
                                 qtables, cfg, ncomps: int, slots,
                                 precision: int = 8, workers=None,
                                 extra_markers=None) -> bytes:
    """planes: per component (bh_pad, bw_pad, 64) int16 zigzag blocks;
    slots: the components' quant slots in the frame header; workers: a
    native.SearchWorkers to code the candidates on, the process's own set
    if None; extra_markers: [(marker code, payload)] written after the
    JFIF header (the ICC chunks, a transcode's copied markers)."""
    mcus_x, mcus_y, comps = geom
    script = scans.search_progression(ncomps, cfg.dc_scan_opt_mode)
    restarts = np.asarray([scan_restart_interval(cfg, s, geom)
                           for s in script], np.int32)

    arr = (native.SearchComp * ncomps)()
    keep = []
    for ci in range(ncomps):
        p = np.ascontiguousarray(planes[ci], dtype=np.int16)
        keep.append(p)
        g = comps[ci]
        arr[ci].coef = p.ctypes.data
        arr[ci].bw = g.bw
        arr[ci].bh = g.bh
        arr[ci].bw_pad = g.bw_pad
        arr[ci].bh_pad = g.bh_pad
        arr[ci].stride = p.shape[1]
        arr[ci].h = g.h
        arr[ci].v = g.v

    total_blocks = sum(g.bw_pad * g.bh_pad for g in comps[:ncomps])
    cap = total_blocks * 384 + (1 << 20)
    out = np.empty(cap, np.uint8)
    meta = np.zeros(1 + 8 * 40, np.int32)
    # a traced call's open span gets the search's counters
    sp = stages.current()
    stats = (np.zeros(len(native.SEARCH_STATS), np.int64) if sp is not None
             else None)
    workers = workers or native.search_workers()
    if not workers.handle:
        raise ValueError("native scan search: the workers are closed")
    n = native.lib().mj_scan_search(
        arr, ncomps, mcus_x, mcus_y, cfg.dc_scan_opt_mode,
        restarts.ctypes.data_as(native.i32p), out.ctypes.data_as(native.u8p),
        cap, meta.ctypes.data_as(native.i32p), workers.handle,
        None if stats is None else stats.ctypes.data_as(native.i64p))
    del keep
    if n < 0:
        raise RuntimeError("native scan search: output buffer overflow")
    if sp is not None:
        sp.set(**dict(zip(native.SEARCH_STATS, stats.tolist())))

    w = marker.MarkerWriter()
    _file_header(w, cfg, extra_markers)
    _frame_header(w, marker.SOF2, width, height, geom, qtables, cfg, ncomps,
                  slots, precision)
    report.add_passes(1)
    for i in range(int(meta[0])):
        # the stitched scans: component count, first component, Ss, Se,
        # Ah, Al
        nc0, c0, ss, se, ah, al = (int(v) for v in meta[2 + 8 * i:
                                                        8 + 8 * i])
        comps_ = (tuple(range(nc0)) if c0 == 0 and nc0 > 1
                  else ((1, 2) if nc0 == 2 else (c0,)))
        report.trace_scan(comps_, ss, se, ah, al)
    report.pass_done("scan search (native)")
    w.raw(out[:n].tobytes())
    w.eoi()
    return w.bytes()


def _file_header(w, cfg, extra_markers):
    w.soi()
    if cfg.write_jfif:
        w.jfif_app0(unit=cfg.density[0], xd=cfg.density[1],
                    yd=cfg.density[2])
    for code, payload in (extra_markers or ()):
        w.segment(code, payload)


def _frame_header(w, sof_code, width, height, geom, qtables, cfg,
                  ncomps: int, slots, precision: int = 8):
    """DQT (one marker, the tables in component order) and SOF, with the
    declared gray sampling (rdswitch.c:610-642)."""
    comps = geom[2]
    cs = "grayscale" if ncomps == 1 else "ycbcr"
    comp_ids = CS_INFO[cs][2]
    sof_samp = [(comps[ci].h, comps[ci].v) for ci in range(ncomps)]
    if ncomps == 1 and cfg.gray_sample:
        sof_samp[0] = tuple(cfg.gray_sample)
    w.dqt_multi([(i, qtables[i]) for i in dict.fromkeys(slots)])
    w.sof(sof_code, precision, height, width,
          [(comp_ids[ci], sof_samp[ci][0], sof_samp[ci][1], slots[ci])
           for ci in range(ncomps)])


# ---------------------------------------------------------------------------
# The search in Python (the arithmetic coder, or MJ_NATIVE_SCANSEARCH=0)
# ---------------------------------------------------------------------------

def _scan_buffer(scan: ScanInfo, geom, planes, dc_tbls, ac_tbls,
                 restart: int, frame_header, emit_dri: bool,
                 device: bool = False) -> bytes:
    """One Huffman candidate scan: [frame header] + DHT + [DRI] + SOS +
    data, with the scan's own optimal tables; emitted by the device's bit
    packers with `device` (device_entropy)."""
    from .encoder import encode_scan_optimal
    sr = encode_scan_optimal(entenc.ScanGeometry(scan, geom, planes),
                             dc_tbls, ac_tbls, restart, device)
    w = marker.MarkerWriter()
    if frame_header:
        w.raw(frame_header)
    entries, seen = [], set()
    for ci in scan.comps:
        if scan.Ss == 0 and scan.Ah == 0:
            t = sr.dc_tbls[ci]
            if t in sr.dc_tables and ("d", t) not in seen:
                entries.append((0, t, sr.dc_tables[t]))
                seen.add(("d", t))
        if scan.Se > 0:
            t = sr.ac_tbls[ci]
            if t in sr.ac_tables and ("a", t) not in seen:
                entries.append((1, t, sr.ac_tables[t]))
                seen.add(("a", t))
    w.dht_multi(entries)
    if emit_dri:
        w.dri(restart)
    comp_ids = CS_INFO["ycbcr"][2]
    w.sos([(comp_ids[ci],
            sr.dc_tbls[ci] if scan.Ss == 0 and scan.Ah == 0 else 0,
            sr.ac_tbls[ci] if scan.Se else 0)
           for ci in scan.comps], scan.Ss, scan.Se, scan.Ah, scan.Al)
    w.raw(sr.data)
    return w.bytes()


def _scan_buffer_arith(scan: ScanInfo, geom, planes, dc_tbls, ac_tbls,
                       restart: int, frame_header, emit_dri: bool) -> bytes:
    """One arithmetic candidate scan: [frame header] + DAC + [DRI] + SOS
    + data (jcmarker.c:404-446 emit_dac writes the scan's tables every
    scan)."""
    w = marker.MarkerWriter()
    if frame_header:
        w.raw(frame_header)
    entries = arith.dac_entries(scan, dc_tbls, ac_tbls)
    if entries:
        w.dac(entries)
    if emit_dri:
        w.dri(restart)
    comp_ids = CS_INFO["ycbcr"][2]
    w.sos([(comp_ids[ci],
            dc_tbls[ci] if scan.Ss == 0 and scan.Ah == 0 else 0,
            ac_tbls[ci] if scan.Se else 0)
           for ci in scan.comps], scan.Ss, scan.Se, scan.Ah, scan.Al)
    w.raw(arith.encode_scan_arith(scan, geom, planes, dc_tbls, ac_tbls,
                                  restart))
    return w.bytes()


class SearchLayout:
    """Index arithmetic of the 64-scan (YCbCr) / 23-scan (gray) search
    script (select_scans, jcmaster.c:773-962)."""

    def __init__(self, ncomps: int):
        self.ncomps = ncomps
        self.num_scans_luma_dc = 1
        self.num_scans_luma = (self.num_scans_luma_dc
                               + (3 * AL_MAX_LUMA + 2)
                               + (2 * NUM_FREQ_SPLITS + 1))      # 23
        self.num_scans_chroma_dc = 3 if ncomps == 3 else 0
        self.luma_split_start = (self.num_scans_luma_dc
                                 + 3 * AL_MAX_LUMA + 2)          # 12
        self.chroma_split_start = (self.num_scans_luma
                                   + self.num_scans_chroma_dc
                                   + (6 * AL_MAX_CHROMA + 4))    # 42
        self.num_scans = self.num_scans_luma if ncomps == 1 else 64

    def scan_al(self, sn: int, scan, best_al_luma: int,
                best_al_chroma: int):
        """The Al candidate sn is emitted with: frequency-split scans
        inherit the winning successive-approximation depth
        (jcmaster.c:482-494)."""
        if self.luma_split_start <= sn < self.num_scans_luma:
            return ScanInfo(scan.comps, scan.Ss, scan.Se, scan.Ah,
                            best_al_luma)
        if self.ncomps == 3 and self.chroma_split_start <= sn:
            return ScanInfo(scan.comps, scan.Ss, scan.Se, scan.Ah,
                            best_al_chroma)
        return scan


class SearchResult:
    __slots__ = ("sizes", "used_scans", "best_Al_luma", "best_Al_chroma",
                 "best_split_luma", "best_split_chroma",
                 "interleave_chroma_dc")


def _run_selection(layout: SearchLayout, script, get_size) -> SearchResult:
    """The greedy selection state machine: candidates are visited in the
    reference's trial order, early exits included; get_size(sn, scan)
    returns the candidate's whole buffer size (DAC [+ DRI] + SOS + data,
    the frame header excluded)."""
    L = layout
    num_scans = L.num_scans
    luma_split_start = L.luma_split_start
    num_scans_luma = L.num_scans_luma
    num_scans_chroma_dc = L.num_scans_chroma_dc
    chroma_split_start = L.chroma_split_start

    sizes: Dict[int, int] = {}
    used_scans: Dict[int, ScanInfo] = {}
    best_al_luma = best_al_chroma = 0
    best_cost = 0
    best_split_luma = best_split_chroma = 0
    interleave_chroma_dc = False

    sn = 0
    while sn < num_scans:
        scan = L.scan_al(sn, script[sn], best_al_luma, best_al_chroma)
        sizes[sn] = get_size(sn, scan)
        used_scans[sn] = scan
        nxt = sn + 1
        if 1 < nxt <= luma_split_start:
            if (nxt - 1) % 3 == 2:
                al = (nxt - 1) // 3
                cost = sizes[nxt - 2] + sizes[nxt - 1] \
                    + sum(sizes[3 + 3 * i] for i in range(al))
                if al == 0 or cost < best_cost:
                    best_cost = cost
                    best_al_luma = al
                else:
                    sn = luma_split_start - 1    # next: the split start
        elif luma_split_start < nxt <= num_scans_luma:
            if nxt == luma_split_start + 1:
                best_split_luma = 0
                best_cost = sizes[nxt - 1]
            elif (nxt - luma_split_start) % 2 == 1:
                idx = (nxt - luma_split_start) >> 1
                cost = sizes[nxt - 2] + sizes[nxt - 1]
                if cost < best_cost:
                    best_cost = cost
                    best_split_luma = idx
                if ((idx == 2 and best_split_luma == 0)
                        or (idx == 3 and best_split_luma != 2)
                        or (idx == 4 and best_split_luma != 4)):
                    sn = num_scans_luma - 1
        elif num_scans > num_scans_luma:
            base = num_scans_luma
            if nxt == num_scans_luma + num_scans_chroma_dc:
                interleave_chroma_dc = (sizes[base] <= sizes[base + 1]
                                        + sizes[base + 2])
            elif (num_scans_luma + num_scans_chroma_dc < nxt
                  <= chroma_split_start):
                base = num_scans_luma + num_scans_chroma_dc
                if (nxt - base) % 6 == 4:
                    al = (nxt - base) // 6
                    cost = (sizes[nxt - 4] + sizes[nxt - 3]
                            + sizes[nxt - 2] + sizes[nxt - 1]
                            + sum(sizes[base + 4 + 6 * i]
                                  + sizes[base + 5 + 6 * i]
                                  for i in range(al)))
                    if al == 0 or cost < best_cost:
                        best_cost = cost
                        best_al_chroma = al
                    else:
                        sn = chroma_split_start - 1
            elif chroma_split_start < nxt <= num_scans:
                if nxt == chroma_split_start + 2:
                    best_split_chroma = 0
                    best_cost = sizes[nxt - 2] + sizes[nxt - 1]
                elif (nxt - chroma_split_start) % 4 == 2:
                    idx = (nxt - chroma_split_start) >> 2
                    cost = (sizes[nxt - 4] + sizes[nxt - 3]
                            + sizes[nxt - 2] + sizes[nxt - 1])
                    if cost < best_cost:
                        best_cost = cost
                        best_split_chroma = idx
                    if ((idx == 2 and best_split_chroma == 0)
                            or (idx == 3 and best_split_chroma != 2)
                            or (idx == 4 and best_split_chroma != 4)):
                        sn = num_scans - 1
        sn += 1

    r = SearchResult()
    r.sizes = sizes
    r.used_scans = used_scans
    r.best_Al_luma = best_al_luma
    r.best_Al_chroma = best_al_chroma
    r.best_split_luma = best_split_luma
    r.best_split_chroma = best_split_chroma
    r.interleave_chroma_dc = interleave_chroma_dc
    return r


def display_order(layout: SearchLayout, r: SearchResult,
                  dc_scan_opt_mode: int) -> List[int]:
    """The winners' stitching order (copy_buffer, jcmaster.c:898-961)."""
    L = layout
    ncomps = L.ncomps
    min_al = min(r.best_Al_luma, r.best_Al_chroma)
    cbase = L.num_scans_luma + L.num_scans_chroma_dc
    order: List[int] = [0]
    if ncomps == 3 and dc_scan_opt_mode != 0:
        base = L.num_scans_luma
        if r.interleave_chroma_dc and dc_scan_opt_mode != 1:
            order.append(base)
        else:
            order += [base + 1, base + 2]
    if r.best_split_luma == 0:
        order.append(L.luma_split_start)
    else:
        order += [L.luma_split_start + 2 * (r.best_split_luma - 1) + 1,
                  L.luma_split_start + 2 * (r.best_split_luma - 1) + 2]
    for al in range(r.best_Al_luma - 1, min_al - 1, -1):
        order.append(3 + 3 * al)
    if ncomps == 3:
        if r.best_split_chroma == 0:
            order += [L.chroma_split_start, L.chroma_split_start + 1]
        else:
            b = L.chroma_split_start + 4 * (r.best_split_chroma - 1)
            order += [b + 2, b + 3, b + 4, b + 5]
        for al in range(r.best_Al_chroma - 1, min_al - 1, -1):
            order += [cbase + 6 * al + 4, cbase + 6 * al + 5]
    for al in range(min_al - 1, -1, -1):
        order.append(3 + 3 * al)
        if ncomps == 3:
            order += [cbase + 6 * al + 4, cbase + 6 * al + 5]
    return order


def encode_optimize_scans(width: int, height: int, geom, planes, qtables,
                          cfg, ncomps: int, slots, precision: int = 8,
                          extra_markers=None, arith: bool = False) -> bytes:
    """The scan search in Python -> the whole JPEG, Huffman-coded (SOF2)
    or arithmetic-coded (SOF10). Each candidate's buffer is kept as
    encoded, with a DRI where the restart interval changes along the
    trial order (jcmaster.c:672-683, jcmarker.c:778-780), and the winners
    are stitched verbatim; scan 0's buffer carries the frame header."""
    script = scans.search_progression(ncomps, cfg.dc_scan_opt_mode)
    dc_tbls = {ci: (0 if ci == 0 else 1) for ci in range(ncomps)}
    ac_tbls = dict(dc_tbls)
    layout = SearchLayout(ncomps)
    fh = marker.MarkerWriter()
    _frame_header(fh, marker.SOF10 if arith else marker.SOF2, width, height,
                  geom, qtables, cfg, ncomps, slots, precision)
    frame_header = fh.bytes()
    bufs: Dict[int, bytes] = {}
    dri = [0]
    mk = _scan_buffer_arith if arith else _scan_buffer
    report.add_passes(layout.num_scans)

    extra = ({} if arith else
             {"device": cfg.device_entropy and precision <= 12})

    def get_size(sn, scan):
        r = scan_restart_interval(cfg, scan, geom)
        bufs[sn] = mk(scan, geom, planes, dc_tbls, ac_tbls, r,
                      frame_header if sn == 0 else None,
                      emit_dri=r != dri[0], **extra)
        dri[0] = r
        report.pass_done("candidate scan %d/%d" % (sn + 1, layout.num_scans))
        return len(bufs[sn]) - (len(frame_header) if sn == 0 else 0)

    res = _run_selection(layout, script, get_size)
    w = marker.MarkerWriter()
    _file_header(w, cfg, extra_markers)
    for idx in display_order(layout, res, cfg.dc_scan_opt_mode):
        # the scan trace at the reference's copy_buffer point
        # (jcmaster.c:747-754), with the Al the scan was emitted with
        s = res.used_scans[idx]
        report.trace_scan(s.comps, s.Ss, s.Se, s.Ah, s.Al)
        w.raw(bufs[idx])
    w.eoi()
    return w.bytes()
