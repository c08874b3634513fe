"""JPEG marker segment writer and parser.

Port of mozjpeg_tpu/codec/marker.py. The writer (the part the encode path
uses): SOI, JFIF APP0, Adobe APP14, ICC APP2 chunks, DQT (one
marker per table, or all in one as mozjpeg's non-FASTEST profile does,
jcmarker.c:190-246), SOF, DHT (likewise single or merged), DAC, DRI, SOS
and EOI, with field layouts as mozjpeg jcmarker.c writes them. The parser
(the decode path) follows mozjpeg jdmarker.c for the markers a
conformant decoder needs, plus the Adobe APP14 transform that names the
colourspace, the JFIF APP0 density and the ICC profile of the APP2
chunks (djpeg's BMP density and -icc); every APPn and COM segment is
kept in ParsedJpeg.markers for jpegtran -copy.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..consts import JPEG_ZIGZAG
from ..entropy.huffman import HuffTable

# marker codes
SOI, EOI, SOS, DQT, DHT, DRI = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD
SOF0, SOF1, SOF2, SOF9, SOF10 = 0xC0, 0xC1, 0xC2, 0xC9, 0xCA
SOF3, SOF11 = 0xC3, 0xCB  # lossless
DAC = 0xCC
APP0, APP2, APP14 = 0xE0, 0xE2, 0xEE
RST0 = 0xD0


class MarkerWriter:
    def __init__(self):
        self.buf = bytearray()

    def bytes(self) -> bytes:
        return bytes(self.buf)

    def raw(self, data: bytes):
        self.buf += data

    def marker(self, code: int):
        self.buf += bytes([0xFF, code])

    def segment(self, code: int, payload: bytes):
        self.marker(code)
        self.buf += struct.pack(">H", len(payload) + 2)
        self.buf += payload

    def soi(self):
        self.marker(SOI)

    def eoi(self):
        self.marker(EOI)

    def jfif_app0(self, major=1, minor=1, unit=0, xd=1, yd=1):
        self.segment(APP0, b"JFIF\x00" + bytes([major, minor, unit])
                     + struct.pack(">HH", xd, yd) + b"\x00\x00")

    def adobe_app14(self, transform: int):
        """Adobe APP14 (jcmarker.c emit_adobe_app14): version 100, flags
        0, the colour transform (0 none, 1 YCbCr, 2 YCCK)."""
        self.segment(APP14, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                   transform))

    @staticmethod
    def _dqt_payload(index: int, qtbl_natural) -> bytes:
        q = np.asarray(qtbl_natural).reshape(64)[JPEG_ZIGZAG]
        prec = 1 if int(q.max()) > 255 else 0
        payload = bytes([(prec << 4) | index])
        if prec:
            return payload + b"".join(struct.pack(">H", int(v)) for v in q)
        return payload + bytes(int(v) for v in q)

    def dqt(self, index: int, qtbl_natural: np.ndarray):
        """One table (natural order in, zigzag out) in its own DQT marker
        (the FASTEST profile)."""
        self.segment(DQT, self._dqt_payload(index, qtbl_natural))

    def dqt_multi(self, tables: List[Tuple[int, np.ndarray]]):
        """All tables in one DQT marker (jcmarker.c:190-246
        emit_multi_dqt, the non-FASTEST profile)."""
        self.segment(DQT, b"".join(self._dqt_payload(i, t)
                                   for i, t in tables))

    def sof(self, code: int, precision: int, height: int, width: int,
            comps: List[Tuple[int, int, int, int]]):
        """comps: (component_id, h, v, quant_tbl_no)."""
        payload = struct.pack(">BHHB", precision, height, width, len(comps))
        for cid, h, v, q in comps:
            payload += bytes([cid, (h << 4) | v, q])
        self.segment(code, payload)

    @staticmethod
    def _dht_payload(cls: int, index: int, tbl: HuffTable) -> bytes:
        return bytes([(cls << 4) | index]) + bytes(tbl.bits[1:17]) \
            + bytes(tbl.vals[:int(tbl.bits[1:17].sum())])

    def dht(self, cls: int, index: int, tbl: HuffTable):
        self.segment(DHT, self._dht_payload(cls, index, tbl))

    def dht_multi(self, entries):
        """One DHT marker holding several tables, entries [(cls, idx,
        tbl)] (jcmarker.c emit_multi_dht). A scan that uses no table (a
        progressive DC refinement) still gets a bare FFC4 0002 marker."""
        self.segment(DHT, b"".join(self._dht_payload(c, i, t)
                                   for c, i, t in entries))

    def dac(self, entries):
        """Arithmetic conditioning, entries [(cls, idx, value)]: value is
        (U << 4) | L for DC, Kx for AC (jcmarker.c emit_dac)."""
        self.segment(DAC, b"".join(bytes([(c << 4) | i, v])
                                   for c, i, v in entries))

    def dri(self, interval: int):
        self.segment(DRI, struct.pack(">H", interval))

    def sos(self, comps: List[Tuple[int, int, int]], Ss: int, Se: int,
            Ah: int, Al: int):
        """comps: (component_id, dc_tbl, ac_tbl)."""
        payload = bytes([len(comps)])
        for cid, dc, ac in comps:
            payload += bytes([cid, (dc << 4) | ac])
        payload += bytes([Ss, Se, (Ah << 4) | Al])
        self.segment(SOS, payload)


ICC_MARKER_PAYLOAD = 65533 - 14  # profile bytes per APP2 chunk


def icc_chunks(profile: bytes):
    """APP2 ICC_PROFILE chunking (jcicc.c jpeg_write_icc_profile) ->
    [(marker code, payload), ...]."""
    n = (len(profile) + ICC_MARKER_PAYLOAD - 1) // ICC_MARKER_PAYLOAD
    return [(APP2, b"ICC_PROFILE\x00" + bytes([i + 1, n])
             + profile[i * ICC_MARKER_PAYLOAD:(i + 1) * ICC_MARKER_PAYLOAD])
            for i in range(n)]


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrameComponent:
    cid: int
    h: int
    v: int
    quant_tbl: int
    # filled at scan time
    dc_tbl: int = 0
    ac_tbl: int = 0


@dataclasses.dataclass
class ScanHeader:
    comp_indices: List[int]
    Ss: int
    Se: int
    Ah: int
    Al: int
    data_start: int   # offset of entropy-coded data
    data_end: int     # offset one past (start of next marker)
    dc_tbls: Dict[int, int] = dataclasses.field(default_factory=dict)
    ac_tbls: Dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ParsedJpeg:
    width: int = 0
    height: int = 0
    precision: int = 8
    progressive: bool = False
    arithmetic: bool = False
    lossless: bool = False
    components: List[FrameComponent] = dataclasses.field(default_factory=list)
    qtables: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # (cls, index) -> HuffTable, snapshotted per scan
    scans: List[ScanHeader] = dataclasses.field(default_factory=list)
    scan_htables: List[Dict[Tuple[int, int], HuffTable]] = \
        dataclasses.field(default_factory=list)
    scan_restart: List[int] = dataclasses.field(default_factory=list)
    scan_qtables: List[Dict[int, np.ndarray]] = \
        dataclasses.field(default_factory=list)
    restart_interval: int = 0
    adobe_transform: Optional[int] = None
    density: tuple = (0, 1, 1)           # JFIF (unit, X, Y)
    icc_profile: Optional[bytes] = None  # the APP2 chunks, joined
    # the APPn and COM segments in stream order (jpegtran -copy)
    markers: List[Tuple[int, bytes]] = dataclasses.field(default_factory=list)
    # DAC arithmetic conditioning (cls, idx) -> value, snapshotted per scan
    arith_cond: Dict[Tuple[int, int], int] = \
        dataclasses.field(default_factory=dict)
    scan_arith_cond: List[Dict[Tuple[int, int], int]] = \
        dataclasses.field(default_factory=list)
    # filled by decode_coefficients (progression status for block
    # smoothing of partial progressive streams, jdphuff.c:126-144)
    coef_bits: Optional[np.ndarray] = None
    coef_bits_prev: Optional[np.ndarray] = None
    last_good_imcu_row: int = 0
    warnings: int = 0            # corrupt-data warning count (jerror)

    @property
    def max_h(self):
        return max(c.h for c in self.components)

    @property
    def max_v(self):
        return max(c.v for c in self.components)


def validate_decodable(jp: "ParsedJpeg"):
    """Structural checks the reference enforces before decoding starts
    (jdmarker.c get_sof/get_sos, jdinput.c initial_setup): a frame header,
    at least one scan, sane dimensions and sampling factors, and a quant
    table for every component. Raises ValueError like every other
    malformed-stream rejection."""
    if not jp.components:
        raise ValueError("no SOF marker before SOS/EOI")
    if not jp.scans:
        raise ValueError("no SOS marker found")
    if jp.width <= 0 or jp.height <= 0:
        raise ValueError("empty JPEG image (DNL not supported)")
    if jp.precision not in (8, 12, 16):
        raise ValueError("unsupported data precision %d" % jp.precision)
    if len(jp.components) > 10:                  # MAX_COMPONENTS
        raise ValueError("too many components: %d" % len(jp.components))
    for c in jp.components:
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
            raise ValueError("bogus sampling factors %dx%d" % (c.h, c.v))
        if jp.lossless:
            continue                             # lossless has no DQT
        qt = jp.scan_qtables[0].get(c.quant_tbl,
                                    jp.qtables.get(c.quant_tbl))
        if qt is None:
            raise ValueError("quantization table 0x%02x was not defined"
                             % c.quant_tbl)
    cids = [c.cid for c in jp.components]
    if len(set(cids)) != len(cids):
        raise ValueError("duplicate component IDs in frame header")
    for sc in jp.scans:
        ss, se, ah, al = sc.Ss, sc.Se, sc.Ah, sc.Al
        if jp.lossless:
            # Ss = predictor 1..7, Al = point transform (jdlossls.c)
            if not (1 <= ss <= 7) or se != 0 or ah != 0 \
                    or al >= jp.precision:
                raise ValueError("invalid lossless scan parameters")
        elif jp.progressive:
            # per_scan_setup / jdphuff.c:96-124 progression checks
            if ss > 63 or se > 63 or ah > 13 or al > 13 \
                    or (ss == 0 and se != 0) \
                    or (ss != 0 and (se < ss or len(sc.comp_indices) != 1)):
                raise ValueError("invalid progression parameters "
                                 "Ss=%d Se=%d Ah=%d Al=%d" % (ss, se, ah, al))
        else:
            if ss != 0 or se != 63 or ah != 0 or al != 0:
                raise ValueError("invalid sequential scan parameters")


def _find_next_marker(data: bytes, pos: int) -> int:
    """Scan forward to the next real marker (FF xx, xx not 0/FF pad)."""
    n = len(data)
    while pos < n - 1:
        if data[pos] == 0xFF:
            b = data[pos + 1]
            if b == 0x00:
                pos += 2
                continue
            if b == 0xFF:
                pos += 1
                continue
            return pos
        pos += 1
    return n


def parse(data: bytes) -> ParsedJpeg:
    """Parse all markers + record per-scan entropy-data extents.

    Malformed field reads (a segment whose declared contents overrun its
    actual payload) surface as ValueError, the reference's ERREXIT on
    bogus marker lengths (jdmarker.c JERR_BAD_LENGTH)."""
    try:
        return _parse(data)
    except (IndexError, struct.error) as e:
        raise ValueError("corrupt JPEG: truncated marker segment") from e


def _parse(data: bytes) -> ParsedJpeg:
    jp = ParsedJpeg()
    htables: Dict[Tuple[int, int], HuffTable] = {}
    icc_parts: Dict[int, bytes] = {}
    icc_total = 0
    n = len(data)
    if n < 2 or data[0] != 0xFF or data[1] != SOI:
        raise ValueError("not a JPEG (no SOI)")
    pos = 2
    while pos < n - 1:
        if data[pos] != 0xFF:
            pos = _find_next_marker(data, pos)
            continue
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m == EOI:
            break
        if RST0 <= m <= RST0 + 7 or m == SOI or m == 0x01:
            pos += 2
            continue
        if pos + 4 > n:
            break
        ln = (data[pos + 2] << 8) | data[pos + 3]
        seg = data[pos + 4:pos + 2 + ln]
        if m == DQT:
            i = 0
            while i < len(seg):
                pq = seg[i] >> 4
                tq = seg[i] & 15
                if pq > 1 or tq > 3:             # JERR_DQT_INDEX
                    raise ValueError("bogus DQT index %d" % seg[i])
                i += 1
                if pq:
                    q = np.frombuffer(seg[i:i + 128], dtype=">u2").astype(
                        np.uint16)
                    i += 128
                else:
                    q = np.frombuffer(seg[i:i + 64], dtype=np.uint8).astype(
                        np.uint16)
                    i += 64
                nat = np.zeros(64, dtype=np.uint16)
                nat[JPEG_ZIGZAG] = q
                jp.qtables[tq] = nat.reshape(8, 8)
        elif m == DHT:
            i = 0
            while i < len(seg):
                tc = seg[i] >> 4
                th = seg[i] & 15
                if tc > 1 or th > 3:             # JERR_DHT_INDEX
                    raise ValueError("bogus DHT index %d" % seg[i])
                i += 1
                bits = np.zeros(17, dtype=np.uint8)
                bits[1:17] = np.frombuffer(seg[i:i + 16], dtype=np.uint8)
                i += 16
                cnt = int(bits.sum())
                vals = np.frombuffer(seg[i:i + cnt], dtype=np.uint8).copy()
                i += cnt
                htables[(tc, th)] = HuffTable(bits, vals)
        elif m in (SOF0, SOF1, SOF2, SOF9, SOF10, SOF3, SOF11):
            jp.progressive = m in (SOF2, SOF10)
            jp.arithmetic = m in (SOF9, SOF10, SOF11)
            jp.lossless = m in (SOF3, SOF11)
            jp.precision = seg[0]
            jp.height = (seg[1] << 8) | seg[2]
            jp.width = (seg[3] << 8) | seg[4]
            nc = seg[5]
            for c in range(nc):
                o = 6 + c * 3
                jp.components.append(FrameComponent(
                    cid=seg[o], h=seg[o + 1] >> 4, v=seg[o + 1] & 15,
                    quant_tbl=seg[o + 2]))
        elif m == DAC:
            # arithmetic conditioning (jdmarker.c get_dac); the values are
            # range-checked per scan by arith.decode_coefficients_arith
            i = 0
            while i + 1 < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                if tc > 1 or th > 3:
                    raise ValueError("bogus DAC index %d" % seg[i])
                jp.arith_cond[(tc, th)] = seg[i + 1]
                i += 2
        elif m == DRI:
            jp.restart_interval = (seg[0] << 8) | seg[1]
        elif m == SOS:
            ns = seg[0]
            if not 1 <= ns <= 4:                 # MAX_COMPS_IN_SCAN
                raise ValueError("bogus component count %d in SOS" % ns)
            comp_indices = []
            dc_tbls: Dict[int, int] = {}
            ac_tbls: Dict[int, int] = {}
            for c in range(ns):
                cid = seg[1 + c * 2]
                tt = seg[2 + c * 2]
                # JERR_BAD_COMPONENT_ID (jdmarker.c get_sos): the scan
                # names a component the frame header never declared
                idx = next((i for i, fc in enumerate(jp.components)
                            if fc.cid == cid), None)
                if idx is None:
                    raise ValueError(
                        "Invalid component ID %d in SOS parameters" % cid)
                if (tt >> 4) > 3 or (tt & 15) > 3:
                    raise ValueError("bogus Huffman table index in SOS")
                jp.components[idx].dc_tbl = tt >> 4
                jp.components[idx].ac_tbl = tt & 15
                dc_tbls[idx] = tt >> 4
                ac_tbls[idx] = tt & 15
                comp_indices.append(idx)
            o = 1 + ns * 2
            Ss, Se = seg[o], seg[o + 1]
            Ah, Al = seg[o + 2] >> 4, seg[o + 2] & 15
            data_start = pos + 2 + ln
            data_end = _find_next_marker(data, data_start)
            # skip RST markers inside scan data
            while (data_end < n - 1
                   and RST0 <= data[data_end + 1] <= RST0 + 7):
                data_end = _find_next_marker(data, data_end + 2)
            jp.scans.append(ScanHeader(comp_indices, Ss, Se, Ah, Al,
                                       data_start, data_end,
                                       dc_tbls, ac_tbls))
            jp.scan_htables.append(dict(htables))
            jp.scan_restart.append(jp.restart_interval)
            jp.scan_arith_cond.append(dict(jp.arith_cond))
            jp.scan_qtables.append({k: v.copy()
                                    for k, v in jp.qtables.items()})
            pos = data_end
            continue
        else:
            if m == APP0 and seg[:5] == b"JFIF\x00" and len(seg) >= 12:
                jp.density = (seg[7], (seg[8] << 8) | seg[9],
                              (seg[10] << 8) | seg[11])
            elif m == APP14 and seg[:5] == b"Adobe":
                jp.adobe_transform = seg[11] if len(seg) > 11 else 0
            elif m == APP2 and seg[:12] == b"ICC_PROFILE\x00":
                # a profile chunk too short for its index and count bytes
                # is a truncated segment (IndexError), as for the JAX
                # parser
                icc_parts[seg[12]] = bytes(seg[14:])
                icc_total = seg[13]
            # every other segment (APPn, COM) is kept for jpegtran -copy
            jp.markers.append((m, bytes(seg)))
        pos += 2 + ln
    if icc_total and len(icc_parts) == icc_total:
        jp.icc_profile = b"".join(icc_parts[i]
                                  for i in range(1, icc_total + 1))
    return jp
