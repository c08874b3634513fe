"""Plain JPEG reader: the markers of a stream and the quantized
coefficients inside it, the benchmark's view of what the port's encoder
writes.

Written from the JPEG standard (ITU-T T.81) and libjpeg's decoders:
Huffman sequential and progressive scans (jdhuff.c, jdphuff.c). It
handles the streams the benchmark's configurations produce (8-bit, 1 or
3 components sampled 1x1 or 2x2, no restart markers) and refuses others.
Huffman decoding runs in Python over a table of every 16-bit window of
the scan's bits.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


def _zigzag() -> np.ndarray:
    """ZIGZAG[k] = natural (row * 8 + col) index of the k-th coefficient."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1],
                                   rc[1] if (rc[0] + rc[1]) % 2 == 0
                                   else rc[0]))
    return np.array([r * 8 + c for r, c in order], dtype=np.int64)


ZIGZAG = _zigzag()


class Component(NamedTuple):
    cid: int
    h: int
    v: int
    tq: int


class Scan(NamedTuple):
    comps: tuple          # component indices
    ss: int
    se: int
    ah: int
    al: int
    dc_tables: tuple      # per scan component: its 16-bit LUT or None
    ac_tables: tuple
    data: bytes           # entropy-coded bytes, stuffing removed
    raw: bytes            # the scan as written: the markers after the
                          # previous scan (or the frame header), its SOS
                          # and its stuffed data


class Frame(NamedTuple):
    width: int
    height: int
    precision: int
    progressive: bool
    comps: tuple
    qtables: dict         # tq -> (64,) int64 in zigzag order
    scans: tuple
    markers: tuple        # the marker codes in file order


class JpegError(ValueError):
    """The stream is not one this reference decodes."""


def _lut(bits, vals):
    """A 65536-entry list: for every 16-bit window, (code length << 8) |
    symbol, or 0 where no code starts the window."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if k >= len(vals):
                raise JpegError("DHT: more codes than symbols")
            lo = code << (16 - length)
            span = 1 << (16 - length)
            if lo + span > 65536:
                raise JpegError("DHT: code space overflow")
            lut[lo:lo + span] = [(length << 8) | vals[k]] * span
            code += 1
            k += 1
        code <<= 1
    return lut


def _entropy_segment(data: bytes, pos: int):
    """(unstuffed bytes, offset of the marker that ends them)."""
    end = pos
    n = len(data)
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= n:
            raise JpegError("scan data runs past the end of the stream")
        nxt = data[end + 1]
        if nxt == 0:
            end += 2
            continue
        if 0xD0 <= nxt <= 0xD7:
            raise JpegError("restart markers are not handled")
        break
    return data[pos:end].replace(b"\xff\x00", b"\xff"), end


def parse(data: bytes) -> Frame:
    """Markers of a JPEG stream -> Frame."""
    if data[:2] != b"\xff\xd8":
        raise JpegError("no SOI")
    pos = 2
    qt, dht = {}, {}
    last = None          # where the bytes of the next scan start
    frame = None
    scans, markers = [], []
    while True:
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise JpegError("bad marker at %d" % pos)
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        markers.append(m)
        if m == 0xD9:
            break
        if pos + 4 > len(data):
            raise JpegError("truncated marker segment")
        seg_len = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + seg_len]
        pos += 2 + seg_len
        if m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                raw = np.frombuffer(seg[i + 1:i + 1 + size],
                                    dtype=">u2" if pq else np.uint8)
                qt[tq] = raw.astype(np.int64)
                i += 1 + size
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = list(seg[i + 1:i + 17])
                nv = sum(bits)
                vals = list(seg[i + 17:i + 17 + nv])
                dht[(tc, th)] = _lut(bits, vals)
                i += 17 + nv
        elif m in (0xC0, 0xC1, 0xC2):
            precision = seg[0]
            height = int.from_bytes(seg[1:3], "big")
            width = int.from_bytes(seg[3:5], "big")
            comps = tuple(Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4,
                                    seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                          for k in range(seg[5]))
            frame = (width, height, precision, m == 0xC2, comps)
            last = pos
        elif m == 0xDD:
            if int.from_bytes(seg[:2], "big"):
                raise JpegError("restart intervals are not handled")
        elif m == 0xDA:
            if frame is None:
                raise JpegError("SOS before SOF")
            ns = seg[0]
            ids = [c.cid for c in frame[4]]
            sc, dcs, acs = [], [], []
            for k in range(ns):
                cid, tt = seg[1 + 2 * k], seg[2 + 2 * k]
                if cid not in ids:
                    raise JpegError("scan names an unknown component")
                sc.append(ids.index(cid))
                dcs.append(dht.get((0, tt >> 4)))
                acs.append(dht.get((1, tt & 15)))
            ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            body, end = _entropy_segment(data, pos)
            scans.append(Scan(tuple(sc), ss, se, a >> 4, a & 15, tuple(dcs),
                              tuple(acs), body, data[last:end]))
            pos = last = end
        elif 0xC3 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise JpegError("SOF%d is not handled" % (m - 0xC0))
    if frame is None:
        raise JpegError("no frame header")
    width, height, precision, progressive, comps = frame
    return Frame(width, height, precision, progressive, comps, qt,
                 tuple(scans), tuple(markers))


def real_grid(fr: Frame, ci: int):
    """(rows, cols) of component ci's real blocks (non-interleaved scans
    cover these, T.81 A.2.2)."""
    c = fr.comps[ci]
    maxh = max(k.h for k in fr.comps)
    maxv = max(k.v for k in fr.comps)
    cw = -(-fr.width * c.h // maxh)
    ch = -(-fr.height * c.v // maxv)
    return -(-ch // 8), -(-cw // 8)


class _Bits:
    """A scan's bits: win[p] is the 16 bits from bit p on (1-padded)."""

    def __init__(self, body: bytes):
        b = np.frombuffer(body + b"\xff" * 4, dtype=np.uint8)
        u = ((b[:-3].astype(np.uint32) << 24) | (b[1:-2].astype(np.uint32)
                                                 << 16)
             | (b[2:-1].astype(np.uint32) << 8) | b[3:])
        n = len(body) + 1
        w = np.empty(n * 8, dtype=np.uint16)
        for r in range(8):
            w[r::8] = (u[:n] >> (16 - r)) & 0xFFFF
        self.win = memoryview(w)
        self.nbits = len(body) * 8


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


class _Decoder:
    """Coefficients of a frame, scan by scan, in flat Python lists of
    (blocks * 64) zigzag values per component."""

    def __init__(self, fr: Frame):
        self.fr = fr
        self.maxh = max(c.h for c in fr.comps)
        self.maxv = max(c.v for c in fr.comps)
        self.mcux = -(-fr.width // (8 * self.maxh))
        self.mcuy = -(-fr.height // (8 * self.maxv))
        # padded block grid of each component (MCU-aligned)
        self.grid = [(self.mcuy * c.v, self.mcux * c.h) for c in fr.comps]
        self.coef = [[0] * (bh * bw * 64) for bh, bw in self.grid]

    def comp_blocks(self, ci):
        return real_grid(self.fr, ci)

    def run(self):
        fr = self.fr
        for sc in fr.scans:
            bits = _Bits(sc.data)
            if not fr.progressive:
                p = self.sequential(sc, bits)
            elif sc.ss == 0:
                if sc.se != 0:
                    raise JpegError("progressive DC scan with AC")
                p = self.dc_scan(sc, bits)
            elif len(sc.comps) != 1:
                raise JpegError("interleaved AC scan")
            elif sc.ah == 0:
                p = self.ac_first(sc, bits)
            else:
                p = self.ac_refine(sc, bits)
            if p > bits.nbits:
                raise JpegError("scan ran past its data")
        return [np.asarray(cl, dtype=np.int32).reshape(bh, bw, 64)
                for cl, (bh, bw) in zip(self.coef, self.grid)]

    def _blocks(self, sc):
        """Block offsets (into the flat list) of each component, in the
        scan's order: per MCU for interleaved scans, else raster."""
        if len(sc.comps) == 1:
            ci = sc.comps[0]
            rows, cols = self.comp_blocks(ci)
            gw = self.grid[ci][1]
            return [(0, (r * gw + c) * 64) for r in range(rows)
                    for c in range(cols)]
        out = []
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                for k, ci in enumerate(sc.comps):
                    c = self.fr.comps[ci]
                    gw = self.grid[ci][1]
                    for y in range(c.v):
                        for x in range(c.h):
                            out.append((k, ((my * c.v + y) * gw
                                            + mx * c.h + x) * 64))
        return out

    def sequential(self, sc, bits):
        win = bits.win
        p = 0
        last = [0] * len(sc.comps)
        for k, off in self._blocks(sc):
            ci = sc.comps[k]
            cl = self.coef[ci]
            dlut, alut = sc.dc_tables[k], sc.ac_tables[k]
            e = dlut[win[p]]
            if not e:
                raise JpegError("bad DC code")
            p += e >> 8
            s = e & 255
            diff = 0
            if s:
                diff = _extend(win[p] >> (16 - s), s)
                p += s
            last[k] += diff
            cl[off] = last[k]
            i = 1
            while i < 64:
                e = alut[win[p]]
                if not e:
                    raise JpegError("bad AC code")
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    i += r
                    if i > 63:
                        raise JpegError("AC index past 63")
                    cl[off + i] = _extend(win[p] >> (16 - s), s)
                    p += s
                    i += 1
                elif r == 15:
                    i += 16
                else:
                    break
        return p

    def dc_scan(self, sc, bits):
        win = bits.win
        p = 0
        al = sc.al
        if sc.ah:
            for k, off in self._blocks(sc):
                if win[p] & 0x8000:
                    self.coef[sc.comps[k]][off] |= 1 << al
                p += 1
            return p
        last = [0] * len(sc.comps)
        for k, off in self._blocks(sc):
            e = sc.dc_tables[k][win[p]]
            if not e:
                raise JpegError("bad DC code")
            p += e >> 8
            s = e & 255
            if s:
                last[k] += _extend(win[p] >> (16 - s), s)
                p += s
            self.coef[sc.comps[k]][off] = last[k] << al
        return p

    def ac_first(self, sc, bits):
        win = bits.win
        lut = sc.ac_tables[0]
        cl = self.coef[sc.comps[0]]
        ss, se, al = sc.ss, sc.se, sc.al
        p = 0
        eobrun = 0
        for _, off in self._blocks(sc):
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                e = lut[win[p]]
                if not e:
                    raise JpegError("bad AC code")
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    if k > se:
                        raise JpegError("AC index past the band")
                    cl[off + k] = _extend(win[p] >> (16 - s), s) << al
                    p += s
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += win[p] >> (16 - r)
                        p += r
                    eobrun -= 1
                    break
                k += 1
        return p

    def ac_refine(self, sc, bits):
        win = bits.win
        lut = sc.ac_tables[0]
        cl = self.coef[sc.comps[0]]
        ss, se = sc.ss, sc.se
        p1 = 1 << sc.al
        m1 = -p1
        p = 0
        eobrun = 0
        for _, off in self._blocks(sc):
            k = ss
            if not eobrun:
                while k <= se:
                    e = lut[win[p]]
                    if not e:
                        raise JpegError("bad AC code")
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        if s != 1:
                            raise JpegError("refinement size is not 1")
                        s = p1 if win[p] & 0x8000 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += win[p] >> (16 - r)
                            p += r
                        break
                    while k <= se:
                        v = cl[off + k]
                        if v:
                            if win[p] & 0x8000 and not v & p1:
                                cl[off + k] = v + (p1 if v >= 0 else m1)
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        if k > se:
                            raise JpegError("refinement past the band")
                        cl[off + k] = s
                    k += 1
            if eobrun:
                while k <= se:
                    v = cl[off + k]
                    if v:
                        if win[p] & 0x8000 and not v & p1:
                            cl[off + k] = v + (p1 if v >= 0 else m1)
                        p += 1
                    k += 1
                eobrun -= 1
        return p


def coefficients(fr: Frame) -> List[np.ndarray]:
    """The quantized coefficients of every component: (bh, bw, 64) int32
    in zigzag order over the MCU-padded block grid."""
    if fr.precision != 8:
        raise JpegError("only 8-bit samples are handled")
    return _Decoder(fr).run()


# ---------------------------------------------------------------------------
# islow IDCT (jidctint.c), CONST_BITS 13, PASS1_BITS 2
# ---------------------------------------------------------------------------
