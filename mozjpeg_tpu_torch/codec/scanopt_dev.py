"""The jpegrescan scan search (optimize_scans) on the device.

Port of mozjpeg_tpu/codec/scanopt_dev.py. Instead of the reference's 64
trial encodes (jcmaster.c:773-962) on the host, for a group of
same-geometry images:

  sizes pass: for every candidate (component, Ss, Se, Ah, Al) variant,
    the 64 search scans expanded over every successive-approximation
    depth the frequency-split scans can inherit (jcmaster.c:482-494):
    gather-mode histograms, then ONE tablegen call (ops/tablegen.py) for
    every table of the group, then each candidate packed with its tables
    (ops/bitpack.py, the group's images as one call's restart segments,
    a chunk of blocks at a time, so that memory stays bounded whatever
    the image's size) and its exact finished size measured (incl. 0xFF
    stuffing); sizes, bit counts and tables come down in one download;
  host: the host search's greedy selection (scanopt._run_selection,
    display_order: the same code), fed from the sizes;
  winners: the winning scans' words, kept on the device since the sizes
    pass, come down in one download; the host stitches the markers and
    does the O(bytes) stuffing (bitpack.finish_segments).

The coefficients never leave the device. Covers what the JAX package's
covers (supported): 8-bit Huffman progressive, no restarts, YCbCr or
grayscale, MCU-aligned planes; the encoder takes the host search
otherwise, and where a candidate's table cannot be built (FallbackNeeded,
counted by the encoder).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..entropy.huffman import HuffTable
from ..ops import bitpack, tablegen
from ..ops import scanopt_kernels as sk
from ..ops.symbols import dc_hist
from . import marker, report, scans
from .scanopt import (SearchLayout, _file_header, _frame_header,
                      _run_selection, display_order)
from .scans import ScanInfo

class CandidateSet:
    """The search script expanded into its candidate variants and the
    index layout of their tables: AC firsts (component-major), AC
    refines, then the DC scans' per-slot tables."""

    def __init__(self, ncomps: int, dc_mode: int):
        self.ncomps = ncomps
        self.layout = SearchLayout(ncomps)
        self.script = scans.search_progression(ncomps, dc_mode)
        L = self.layout
        # per component its (Ss, Se, Al) list; (sn, Al) -> (comp, index)
        self.first_params: List[List[Tuple[int, int, int]]] = \
            [[] for _ in range(ncomps)]
        self.first_idx: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.ref_params: List[List[Tuple[int, int, int]]] = \
            [[] for _ in range(ncomps)]
        self.ref_idx: Dict[int, Tuple[int, int]] = {}
        self.dc_scans: List[Tuple[int, ScanInfo]] = []
        for sn, scan in enumerate(self.script):
            ci = scan.comps[0]
            if scan.Ss == 0:
                self.dc_scans.append((sn, scan))
                continue
            if scan.Ah != 0:
                self.ref_idx[sn] = (ci, len(self.ref_params[ci]))
                self.ref_params[ci].append((scan.Ss, scan.Se, scan.Al))
                continue
            if (L.luma_split_start <= sn < L.num_scans_luma
                    or (ncomps == 3 and L.chroma_split_start <= sn)):
                almax = (scans.AL_MAX_LUMA if ci == 0
                         else scans.AL_MAX_CHROMA)
                als = range(almax + 1)
            else:
                als = (scan.Al,)
            for Al in als:
                self.first_idx[(sn, Al)] = (ci, len(self.first_params[ci]))
                self.first_params[ci].append((scan.Ss, scan.Se, Al))
        self.n_first = [len(p) for p in self.first_params]
        self.n_ref = [len(p) for p in self.ref_params]
        self.dc_tables: List[Tuple[int, int]] = []   # (dc scan pos, slot)
        for pos, (_, scan) in enumerate(self.dc_scans):
            for slot in _slots(scan):
                self.dc_tables.append((pos, slot))

    def first_table_index(self, ci: int, li: int) -> int:
        return sum(self.n_first[:ci]) + li

    def ref_table_index(self, ci: int, li: int) -> int:
        return sum(self.n_first) + sum(self.n_ref[:ci]) + li

    def dc_table_index(self, pos: int, slot: int) -> int:
        return (sum(self.n_first) + sum(self.n_ref)
                + self.dc_tables.index((pos, slot)))


def _slots(scan) -> list:
    """The Huffman slots of a scan's components, in first use."""
    return list(dict.fromkeys(0 if ci == 0 else 1 for ci in scan.comps))


@functools.lru_cache(maxsize=8)
def get_candidates(ncomps: int, dc_mode: int) -> CandidateSet:
    return CandidateSet(ncomps, dc_mode)


def supported(cfg, cs: str, ncomps: int, geom=None) -> bool:
    """The device search covers the default profile: 8-bit Huffman
    progressive, no restart interval, YCbCr or grayscale, and (given the
    geometry) planes without iMCU dummy blocks."""
    if cfg.precision != 8 or cfg.arithmetic:
        return False
    if cfg.restart_in_rows or cfg.restart_interval:
        return False
    if ncomps not in (1, 3) or (ncomps == 3 and cs != "ycbcr"):
        return False
    if geom is not None and any(g.bw != g.bw_pad or g.bh != g.bh_pad
                                for g in geom[2]):
        return False
    return True


class FallbackNeeded(Exception):
    """A candidate's table could not be built; take the host search."""


def _stacked(finals, comps, b: int):
    """Per component (64, B*n) -> (B*bh, bw, 64): the images stacked as
    block rows, so that each image is one restart segment."""
    return [q.reshape(64, b * g.bh, g.bw).permute(1, 2, 0)
            for q, g in zip(finals, comps)]


def _dc_deltas(plane, g, b: int, mcus_x: int, mcus_y: int,
               interleaved: bool) -> torch.Tensor:
    """(B*bh, bw, 64) -> (B, m) DC differences in the scan's order: MCU
    order in an interleaved scan, raster over the blocks in a
    single-component one (jcmaster.c:533 per_scan_setup)."""
    dc = plane[:, :, 0].to(torch.int64).reshape(b, g.bh, g.bw)
    if interleaved and (g.h, g.v) != (1, 1):
        dc = dc.reshape(b, mcus_y, g.v, mcus_x, g.h).permute(0, 1, 3, 2, 4)
    seq = dc.reshape(b, -1)
    return bitpack._dc_deltas(seq)


class _Pass:
    """One group's candidates on the device: their histograms, tables,
    packed words and finished sizes."""

    def __init__(self, cand: CandidateSet, finals, geom, b: int):
        self.cand, self.b = cand, b
        self.mcus_x, self.mcus_y, self.comps = geom
        self.planes = _stacked(finals, self.comps, b)
        self.firsts = {}        # (ci, li) -> AC-first scan, its EOB runs
        self.sched = {}         # (ci, li) -> AC-refine flush schedule
        self.words = {}         # candidate key -> (B, nwords) int32 words

    def band(self, ci: int, Ss: int, Se: int) -> bitpack.Band:
        g = self.comps[ci]
        return bitpack.Band(self.planes[ci], self.b * g.bh, g.bw, Ss, Se,
                            self.b * g.bh * g.bw)

    def n(self, ci: int) -> int:
        return self.comps[ci].bh * self.comps[ci].bw

    def histograms(self) -> torch.Tensor:
        """(T * B, 256) gather-mode counts, in table order."""
        cand, out = self.cand, []
        for ci, params in enumerate(cand.first_params):
            for li, (Ss, Se, Al) in enumerate(params):
                first = bitpack.AcFirst(self.band(ci, Ss, Se), Al, self.n(ci))
                self.firsts[(ci, li)] = first
                out.append(first.hist())
        for ci, params in enumerate(cand.ref_params):
            for li, (Ss, Se, Al) in enumerate(params):
                ref = bitpack.AcRefine(self.band(ci, Ss, Se), Al, self.n(ci))
                self.sched[(ci, li)] = ref.sched
                out.append(ref.hist())
        for pos, slot in cand.dc_tables:
            scan = cand.dc_scans[pos][1]
            h = 0
            for ci in scan.comps:
                if (0 if ci == 0 else 1) == slot:
                    h = h + dc_hist(_dc_deltas(
                        self.planes[ci], self.comps[ci], self.b,
                        self.mcus_x, self.mcus_y, len(scan.comps) > 1))
            out.append(h)
        return torch.cat(out)

    def tables(self, t: int, co_all, si_all):
        return co_all[t * self.b:(t + 1) * self.b], \
            si_all[t * self.b:(t + 1) * self.b]

    def pack(self, co_all, si_all):
        """Pack every candidate with its tables -> (sizes, bits) int64
        lists in sidecar order (firsts, refines, DC scans), each (B,);
        the words stay in self.words."""
        cand, sizes, bits = self.cand, [], []

        def keep(key, words, nb):
            self.words[key] = words.to(torch.int32)
            sizes.append(sk.stuffed_size(words, nb))
            bits.append(nb)

        for ci, params in enumerate(cand.first_params):
            for li in range(len(params)):
                co, si = self.tables(cand.first_table_index(ci, li),
                                     co_all, si_all)
                keep(("first", ci, li),
                     *self.firsts.pop((ci, li)).pack(co, si))
        for ci, params in enumerate(cand.ref_params):
            for li, (Ss, Se, Al) in enumerate(params):
                co, si = self.tables(cand.ref_table_index(ci, li),
                                     co_all, si_all)
                keep(("ref", ci, li), *bitpack.AcRefine(
                    self.band(ci, Ss, Se), Al, self.n(ci),
                    self.sched[(ci, li)]).pack(co, si))
        for pos, (_, scan) in enumerate(cand.dc_scans):
            tabs = [self.tables(cand.dc_table_index(
                pos, 0 if ci == 0 else 1), co_all, si_all)
                for ci in scan.comps]
            planes = [self.planes[ci] for ci in scan.comps]
            if len(scan.comps) > 1:
                geoms = [(self.comps[ci].h, self.comps[ci].v)
                         for ci in scan.comps]
                mx, my = self.mcus_x, self.mcus_y
            else:
                geoms = [(1, 1)]
                mx, my = self.comps[scan.comps[0]].bw, \
                    self.comps[scan.comps[0]].bh
            keep(("dc", pos), *bitpack._pack_dc_first(
                planes, tabs, geoms, mx, my * self.b, mx * my, 0))
        return sizes, bits


class _Sidecar:
    """The sizes pass's one download, parsed."""

    def __init__(self, cand: CandidateSet, flat: np.ndarray, b: int):
        self.b = b
        nf, nr, nd = sum(cand.n_first), sum(cand.n_ref), len(cand.dc_scans)
        ncand = nf + nr + nd
        sizes = flat[:ncand * b].reshape(ncand, b)
        bits = flat[ncand * b:2 * ncand * b].reshape(ncand, b)
        t = flat[2 * ncand * b:].reshape(-1, 16 + 256 + 1)
        self.tbits, self.tvals, self.tok = t[:, :16], t[:, 16:272], t[:, 272]
        self.sizes, self.bits = {}, {}
        k = 0
        for kind, counts in (("first", cand.n_first), ("ref", cand.n_ref)):
            for ci, cnt in enumerate(counts):
                for li in range(cnt):
                    self.sizes[(kind, ci, li)] = sizes[k]
                    self.bits[(kind, ci, li)] = bits[k]
                    k += 1
        for pos in range(nd):
            self.sizes[("dc", pos)] = sizes[k]
            self.bits[("dc", pos)] = bits[k]
            k += 1

    def table(self, t: int, img: int) -> HuffTable:
        row = t * self.b + img
        bits = np.zeros(17, np.uint8)
        bits[1:] = self.tbits[row]
        return HuffTable(bits, self.tvals[row][:int(bits.sum())]
                         .astype(np.uint8))

    def ok(self, t: int, img: int) -> bool:
        return bool(self.tok[t * self.b + img])

    def nvals(self, t: int, img: int) -> int:
        return int(self.tbits[t * self.b + img].sum())


def sizes_pass(cand: CandidateSet, finals, geom, b: int):
    """Histograms, one tablegen call for every table, the packs and
    their sizes -> (the pass, its words on the device; the sidecar, from
    one download)."""
    run = _Pass(cand, finals, geom, b)
    hists = run.histograms().to(torch.int32)
    tbits, tvals, tok = tablegen.gen_optimal_tables(
        torch.nn.functional.pad(hists, (0, 1)))
    co_all, si_all = tablegen.derive_codes(tbits, tvals)
    sizes, bits = run.pack(co_all, si_all)
    side = torch.cat([torch.stack(sizes).reshape(-1),
                      torch.stack(bits).reshape(-1),
                      torch.cat([tbits[:, 1:17].long(), tvals.long(),
                                 tok[:, None].long()], 1).reshape(-1)])
    return run, _Sidecar(cand, side.cpu().numpy(), b)


def _key_table(cand: CandidateSet, sn: int, scan):
    """(candidate key, its table index, or a list of (slot, index) for a
    DC scan) of search scan sn at the scan's Al."""
    if scan.Ss == 0:
        pos = next(p for p, (s, _) in enumerate(cand.dc_scans) if s == sn)
        return ("dc", pos), [(sl, cand.dc_table_index(pos, sl))
                             for sl in _slots(scan)]
    if scan.Ah != 0:
        ci, li = cand.ref_idx[sn]
        return ("ref", ci, li), cand.ref_table_index(ci, li)
    ci, li = cand.first_idx[(sn, scan.Al)]
    return ("first", ci, li), cand.first_table_index(ci, li)


def encode_batch_scans(widths, heights, geom, finals, qtables, cfg,
                       ncomps: int, b: int, slots=None,
                       extra_markers=None) -> List[bytes]:
    """The device scan search for a group of b same-geometry images ->
    each image's whole JPEG. finals: per component the (64, B*n) int16
    final coefficients on the device; slots: the frame's quant slots
    (the colorspace's by default); extra_markers: [(code, payload)]
    written after the JFIF header (the ICC chunks). Raises
    FallbackNeeded where a candidate's table cannot be built."""
    mcus_x, mcus_y, comps = geom
    cand = get_candidates(ncomps, cfg.dc_scan_opt_mode)
    slots = tuple(slots) if slots else (0, 1, 1)[:ncomps]
    report.add_passes(b)

    run, sc = sizes_pass(cand, finals, geom, b)

    sos_len = {k: 8 + 2 * k for k in (1, 2, 3)}
    chosen = []
    for i in range(b):
        def get_size(sn, scan, _i=i):
            key, t = _key_table(cand, sn, scan)
            if key[0] == "dc":
                dht = 4 + sum(17 + sc.nvals(ti, _i) for _, ti in t)
            else:
                if not sc.ok(t, _i):
                    raise FallbackNeeded()
                dht = 4 + 17 + sc.nvals(t, _i)
            return dht + sos_len[len(scan.comps)] + int(sc.sizes[key][_i])

        res = _run_selection(cand.layout, cand.script, get_size)
        chosen.append((res, display_order(cand.layout, res,
                                          cfg.dc_scan_opt_mode)))
        report.pass_done("scan search")

    # the winners' words, trimmed to their bits, in one download
    parts, spans = [], []
    for i, (res, order) in enumerate(chosen):
        for idx in order:
            key, _ = _key_table(cand, idx, res.used_scans[idx])
            nb = int(sc.bits[key][i])
            nw = -(-nb // 32)
            parts.append(run.words[key][i, :nw])
            spans.append((nw, nb))
    flat = torch.cat(parts).cpu().numpy().astype(np.int64) & bitpack.M32

    outs, off, k = [], 0, 0
    comp_ids = (1, 2, 3)
    for i, (res, order) in enumerate(chosen):
        w = marker.MarkerWriter()
        _file_header(w, cfg, extra_markers)
        _frame_header(w, marker.SOF2, widths[i], heights[i], geom, qtables,
                      cfg, ncomps, slots, cfg.precision)
        for idx in order:
            scan = res.used_scans[idx]
            report.trace_scan(scan.comps, scan.Ss, scan.Se, scan.Ah, scan.Al)
            _, t = _key_table(cand, idx, scan)
            if scan.Ss == 0:
                w.dht_multi([(0, sl, sc.table(ti, i)) for sl, ti in t])
                sos = [(comp_ids[ci], 0 if ci == 0 else 1, 0)
                       for ci in scan.comps]
            else:
                sl = 0 if scan.comps[0] == 0 else 1
                w.dht_multi([(1, sl, sc.table(t, i))])
                sos = [(comp_ids[scan.comps[0]], 0, sl)]
            w.sos(sos, scan.Ss, scan.Se, scan.Ah, scan.Al)
            nw, nb = spans[k]
            w.raw(bitpack.finish_segments(flat[off:off + nw][None],
                                          np.asarray([nb]), False))
            off += nw
            k += 1
        w.eoi()
        outs.append(w.bytes())
    return outs
