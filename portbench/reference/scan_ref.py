"""Plain reference of mozjpeg's progressive Huffman coding with the scan
search (optimize_scans) and optimized tables (optimize_coding).

Given a frame's quantized coefficients (read back from the stream by
jpeg_read), it codes every candidate scan of mozjpeg's search list
(jcparam.c jpeg_search_progression: 64 candidates for YCbCr) with that
scan's own optimal Huffman tables (jchuff.c jpeg_gen_optimal_table over
the scan's symbol counts), runs the selection in its trial order with
its early exits (jcmaster.c select_scans) and stitches the winners in
display order (jcmaster.c copy_buffer). Each scan's bytes are what the
encoder writes for it: DHT, SOS and the entropy-coded data with its
0xFF stuffing and 1-bit padding. The symbols follow jcphuff.c
(encode_mcu_DC_first, encode_mcu_AC_first, encode_mcu_AC_refine with
its correction-bit buffer of MAX_CORR_BITS), without restart markers.

The symbols of a scan are built with numpy over all blocks at once as
"emissions" in stream order: a Huffman symbol (or none) followed by
some raw bits.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

FREQUENCY_SPLITS = (2, 8, 5, 12, 18)
AL_MAX_LUMA = 3
AL_MAX_CHROMA = 2
EOBRUN_MAX = 0x7FFF
BE_MAX = 1000 - 64 + 1          # MAX_CORR_BITS - DCTSIZE2 + 1
COMP_IDS = (1, 2, 3)


class ScanSpec(NamedTuple):
    comps: Tuple[int, ...]
    ss: int
    se: int
    ah: int
    al: int


def search_candidates(ncomps: int) -> List[ScanSpec]:
    """jpeg_search_progression's candidate list, dc_scan_opt_mode 0."""
    def one(ci, ss, se, ah, al):
        return ScanSpec((ci,), ss, se, ah, al)
    s = [ScanSpec(tuple(range(ncomps)), 0, 0, 0, 0),
         one(0, 1, 8, 0, 0), one(0, 9, 63, 0, 0)]
    for al in range(AL_MAX_LUMA):
        s += [one(0, 1, 63, al + 1, al), one(0, 1, 8, 0, al + 1),
              one(0, 9, 63, 0, al + 1)]
    s.append(one(0, 1, 63, 0, 0))
    for f in FREQUENCY_SPLITS:
        s += [one(0, 1, f, 0, 0), one(0, f + 1, 63, 0, 0)]
    if ncomps == 3:
        s += [ScanSpec((1, 2), 0, 0, 0, 0), one(1, 0, 0, 0, 0),
              one(2, 0, 0, 0, 0), one(1, 1, 8, 0, 0), one(1, 9, 63, 0, 0),
              one(2, 1, 8, 0, 0), one(2, 9, 63, 0, 0)]
        for al in range(AL_MAX_CHROMA):
            s += [one(1, 1, 63, al + 1, al), one(2, 1, 63, al + 1, al),
                  one(1, 1, 8, 0, al + 1), one(1, 9, 63, 0, al + 1),
                  one(2, 1, 8, 0, al + 1), one(2, 9, 63, 0, al + 1)]
        s += [one(1, 1, 63, 0, 0), one(2, 1, 63, 0, 0)]
        for f in FREQUENCY_SPLITS:
            s += [one(1, 1, f, 0, 0), one(1, f + 1, 63, 0, 0),
                  one(2, 1, f, 0, 0), one(2, f + 1, 63, 0, 0)]
    return s


# ---------------------------------------------------------------------------
# Optimal Huffman tables (jchuff.c jpeg_gen_optimal_table)
# ---------------------------------------------------------------------------

def gen_optimal_table(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """counts (256,) symbol counts -> (bits (17,), vals): libjpeg's
    merge of the two least frequent symbols (ties to the larger symbol),
    with a pseudo-symbol 256 of count 1, lengths limited to 16."""
    freq = np.zeros(257, np.int64)
    freq[:256] = counts
    freq[256] = 1
    codesize = np.zeros(257, np.int64)
    others = np.full(257, -1, np.int64)
    idx = np.arange(257)
    while True:
        live = freq > 0
        if live.sum() < 2:
            break
        v1 = freq[live].min()
        c1 = int(idx[live & (freq == v1)].max())
        live2 = live & (idx != c1)
        v2 = freq[live2].min()
        c2 = int(idx[live2 & (freq == v2)].max())
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = int(others[c1])
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = int(others[c2])
            codesize[c2] += 1
    bits = np.zeros(33, np.int64)
    for cs in codesize[codesize > 0]:
        bits[cs] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [s for ln in range(1, 33) for s in range(256) if codesize[s] == ln]
    return bits[:17].astype(np.uint8), np.array(vals, np.uint8)


def code_table(bits, vals) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical codes (jchuff.c jpeg_make_c_derived_tbl) -> (code
    (256,), length (256,)), length 0 for symbols without a code."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for ln in range(1, 17):
        for _ in range(int(bits[ln])):
            code[vals[k]] = c
            length[vals[k]] = ln
            c += 1
            k += 1
        c <<= 1
    return code, length


# ---------------------------------------------------------------------------
# Emissions: in stream order, a Huffman symbol (-1 for none) of a table
# slot, then xlen raw bits of xval. Each is placed by an integer key:
# block * BLK + a place inside the block.
# ---------------------------------------------------------------------------

BLK = 1 << 16
PRE = 0            # the pending EOB run, flushed before a block's symbols
POINTS = 2048      # + 512 * position: the ZRLs and the symbol there
POST = 40000       # a run flushed after the block's own count


class Emissions(NamedTuple):
    key: np.ndarray
    sym: np.ndarray
    tbl: np.ndarray
    xval: np.ndarray
    xlen: np.ndarray


def _em(key, sym, tbl, xval, xlen) -> Emissions:
    n = len(key)
    return Emissions(*(np.broadcast_to(np.asarray(a, np.int64), (n,))
                       for a in (key, sym, tbl, xval, xlen)))


def _ordered(parts: List[Emissions]) -> Emissions:
    cat = [np.concatenate([getattr(p, f) for p in parts])
           for f in Emissions._fields]
    order = np.argsort(cat[0], kind="stable")
    return Emissions(*(a[order] for a in cat))


def nbits(v: np.ndarray) -> np.ndarray:
    """Bit length of non-negative integers."""
    v = np.asarray(v, np.int64)
    out = np.zeros(v.shape, np.int64)
    for sh in (16, 8, 4, 2, 1):
        big = v >= (1 << sh)
        out += big * sh
        v = np.where(big, v >> sh, v)
    return out + (v > 0)


def _eob_runs(event: np.ndarray, inc: np.ndarray, be: np.ndarray, tbl: int,
              tail_b: np.ndarray, tail_bit: np.ndarray) -> List[Emissions]:
    """The EOB runs of a progressive AC scan and the correction bits they
    carry. Each block with `inc` counts one in the run; a block with
    `event` flushes the pending run before its first symbol; a run is
    also flushed after the count that makes it 0x7FFF or takes the
    buffered bits (be per block) past BE_MAX, and at the scan's end.
    tail_b / tail_bit: the buffered bits, block-major in order."""
    n = len(event)
    ev = np.nonzero(event)[0]
    starts = np.concatenate([[0], ev + 1 - inc[ev]])
    ends = np.concatenate([ev, [n]])
    cum = np.concatenate([[0], np.cumsum(be)])
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    big = ((ends - starts >= EOBRUN_MAX)
           | (cum[ends] - cum[starts] > BE_MAX))
    lo = [starts[~big]]
    hi = [ends[~big]]
    fkey = [ends[~big] * BLK + PRE]
    for s, e in zip(starts[big], ends[big]):
        s, e = int(s), int(e)
        while s < e:
            # the first block after which the run must be flushed
            by_bits = int(np.searchsorted(cum[s + 1:e + 1] - cum[s], BE_MAX,
                                          side="right")) + s
            j = min(by_bits, s + EOBRUN_MAX - 1)
            if j >= e:
                lo.append([s])
                hi.append([e])
                fkey.append([e * BLK + PRE])
                break
            lo.append([s])
            hi.append([j + 1])
            fkey.append([j * BLK + POST])
            s = j + 1
    lo, hi, fkey = (np.concatenate(a).astype(np.int64)
                    for a in (lo, hi, fkey))
    order = np.argsort(lo, kind="stable")
    lo, hi, fkey = lo[order], hi[order], fkey[order]
    runs = hi - lo
    nb = nbits(runs) - 1
    out = [_em(fkey, nb << 4, tbl, runs - (1 << nb), nb)]
    if len(tail_b):
        f = np.searchsorted(lo, tail_b, side="right") - 1
        first = np.searchsorted(tail_b, lo)
        rank = np.arange(len(tail_b)) - first[f]
        out.append(_em(fkey[f] + 1 + rank, -1, tbl, tail_bit, 1))
    return out


def dc_first(dc: np.ndarray, owner: np.ndarray, tbls, al: int
             ) -> Emissions:
    """dc (n,) DC values in scan order, owner (n,) the scan component of
    each -> the emissions of a DC first scan (differences per
    component, from 0)."""
    val = np.asarray(dc, np.int64) >> al
    diff = np.empty_like(val)
    for k in range(len(tbls)):
        m = owner == k
        diff[m] = np.diff(val[m], prepend=0)
    nb = nbits(np.abs(diff))
    x = np.where(diff < 0, diff - 1, diff) & ((1 << nb) - 1)
    return _em(np.arange(len(val)) * BLK, nb,
               np.asarray(tbls, np.int64)[owner], x, nb)


def ac_first(zz: np.ndarray, ss: int, se: int, al: int, tbl: int
             ) -> Emissions:
    """zz (n, 64) zigzag blocks in scan order -> emissions."""
    c = zz[:, ss:se + 1].astype(np.int64)
    t = np.abs(c) >> al
    nz = t != 0
    b, k = np.nonzero(nz)                      # block-major, k ascending
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, -1, np.concatenate([[-1], k[:-1]]))
    run = k - prev - 1
    tv = t[b, k]
    nb = nbits(tv)
    x = np.where(c[b, k] < 0, ((1 << nb) - 1) - tv, tv)
    pt = b * BLK + POINTS + k * 512
    zi, zj = np.nonzero((run >> 4)[:, None] > np.arange(4)[None, :])
    parts = [_em(pt + 8, ((run & 15) << 4) | nb, tbl, x, nb),
             _em(pt[zi] + zj, 0xF0, tbl, 0, 0)]
    parts += _eob_runs(nz.any(1), ~nz[:, -1], np.zeros(len(c), np.int64),
                       tbl, np.zeros(0, np.int64), np.zeros(0, np.int64))
    return _ordered(parts)


def ac_refine(zz: np.ndarray, ss: int, se: int, al: int, tbl: int
              ) -> Emissions:
    """zz (n, 64) zigzag blocks in scan order -> emissions of the
    refinement of bit al (Ah = al + 1)."""
    c = zz[:, ss:se + 1].astype(np.int64)
    n, width = c.shape
    t = np.abs(c) >> al
    pos = np.arange(width)[None, :]
    new = t == 1
    corr = t > 1
    zero = t == 0
    eob = np.where(new.any(1), width - 1 - np.argmax(new[:, ::-1], 1), -1)
    # zeros since the last newly-nonzero coefficient before each position
    lastnew = np.maximum.accumulate(np.where(new, pos, -1), axis=1)
    lnb = np.concatenate([np.full((n, 1), -1), lastnew[:, :-1]], 1)
    zx = np.concatenate([np.zeros((n, 1), np.int64),
                         np.cumsum(zero, 1)], 1)     # zeros in [0, k)
    z = zx[:, :-1] - np.take_along_axis(zx, lnb + 1, 1)
    # nonzero coefficients up to the EOB: ZRLs may be emitted there
    b, k = np.nonzero((new | corr) & (pos <= eob[:, None]))
    zk = z[b, k]
    isnew = new[b, k]
    restart = np.ones(len(b), bool)            # first after a new coef
    restart[1:] = (b[1:] != b[:-1]) | isnew[:-1]
    zprev = np.where(restart, 0, np.concatenate([[0], zk[:-1]]))
    nzrl = (zk >> 4) - (zprev >> 4)
    ispt = isnew | (nzrl > 0)                  # emission points
    pk = b * 64 + k
    ptkey = b * BLK + POINTS + k * 512
    # correction bits up to the EOB ride after the next point past them:
    # its first ZRL, or its symbol where it has none
    cb, ck = np.nonzero(corr & (pos < eob[:, None]))
    pidx = np.nonzero(ispt)[0]
    nxt = pidx[np.searchsorted(pk[pidx], cb * 64 + ck, side="right")]
    ckey = ptkey[nxt] + np.where(nzrl[nxt] > 0, 1, 385) + ck
    zi, zj = np.nonzero(nzrl[:, None] > np.arange(4)[None, :])
    si = np.nonzero(isnew)[0]
    parts = [
        _em(ptkey[zi] + zj * 128, 0xF0, tbl, 0, 0),
        _em(ptkey[si] + 384, ((zk[si] & 15) << 4) | 1, tbl,
            (c[b[si], k[si]] >= 0).astype(np.int64), 1),
        _em(ckey, -1, tbl, t[cb, ck] & 1, 1)]
    tb, tk = np.nonzero(corr & (pos > eob[:, None]))
    parts += _eob_runs(eob >= 0, eob < width - 1,
                       np.bincount(tb, minlength=n), tbl, tb,
                       t[tb, tk] & 1)
    return _ordered(parts)


# ---------------------------------------------------------------------------
# Bytes
# ---------------------------------------------------------------------------

def pack(em: Emissions, codes: Dict[int, Tuple[np.ndarray, np.ndarray]]
         ) -> bytes:
    """Emissions with each table slot's (code, length) -> the scan's
    entropy-coded bytes, padded with 1 bits and 0xFF-stuffed."""
    has = em.sym >= 0
    sym = np.where(has, em.sym, 0)
    clen = np.zeros(len(sym), np.int64)
    code = np.zeros(len(sym), np.int64)
    for slot, (co, ln) in codes.items():
        m = has & (em.tbl == slot)
        clen[m] = ln[sym[m]]
        code[m] = co[sym[m]]
    if np.any(has & (clen == 0)):
        raise ValueError("a symbol without a code")
    length = clen + em.xlen
    value = (code << em.xlen) | em.xval
    total = int(length.sum())
    rep = np.repeat(np.arange(len(length)), length)
    start = np.cumsum(length) - length
    shift = (start + length - 1)[rep] - np.arange(total)
    bits = ((value[rep] >> shift) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


class Frame(NamedTuple):
    """What the scans need of a frame: each component's zigzag blocks over
    the MCU-padded grid (bh_pad, bw_pad, 64), its real block grid
    (rows, cols) and sampling (h, v), and the MCU grid."""
    coefs: list
    real: list
    samp: list
    mcux: int
    mcuy: int


def _scan_blocks(fr: Frame, comps) -> Tuple[np.ndarray, np.ndarray]:
    """(component, flat padded block index) of each block of a scan in
    its order: MCU by MCU for several components, else raster over the
    component's real blocks."""
    if len(comps) == 1:
        ci = comps[0]
        rows, cols = fr.real[ci]
        bw = fr.coefs[ci].shape[1]
        r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        return np.zeros(rows * cols, np.int64), (r * bw + c).reshape(-1)
    my, mx = np.meshgrid(np.arange(fr.mcuy), np.arange(fr.mcux),
                         indexing="ij")
    per_mcu, owner = [], []
    for k, ci in enumerate(comps):
        h, v = fr.samp[ci]
        bw = fr.coefs[ci].shape[1]
        for y in range(v):
            for x in range(h):
                per_mcu.append(((my * v + y) * bw + mx * h + x).reshape(-1))
                owner.append(k)
    idx = np.stack(per_mcu, 1).reshape(-1)
    own = np.tile(np.asarray(owner, np.int64), fr.mcux * fr.mcuy)
    return own, idx


def scan_bytes(fr: Frame, sc: ScanSpec) -> bytes:
    """One candidate scan as the encoder writes it: DHT (the scan's own
    optimal tables), SOS and the entropy-coded data."""
    slot = [0 if ci == 0 else 1 for ci in sc.comps]
    own, idx = _scan_blocks(fr, sc.comps)
    if sc.ss == 0:
        if sc.ah:
            raise ValueError("no DC refinement among the candidates")
        dc = np.empty(len(idx), np.int64)
        for k, ci in enumerate(sc.comps):
            m = own == k
            dc[m] = fr.coefs[ci].reshape(-1, 64)[idx[m], 0]
        em = dc_first(dc, own, slot, sc.al)
        cls = 0
    else:
        zz = fr.coefs[sc.comps[0]].reshape(-1, 64)[idx]
        fn = ac_refine if sc.ah else ac_first
        em = fn(zz, sc.ss, sc.se, sc.al, slot[0])
        cls = 1
    has = em.sym >= 0
    dht, codes = b"", {}
    for s in dict.fromkeys(slot):
        m = has & (em.tbl == s)
        if not m.any():
            continue
        bits, vals = gen_optimal_table(np.bincount(em.sym[m], minlength=256))
        codes[s] = code_table(bits, vals)
        dht += bytes([(cls << 4) | s]) + bytes(bits[1:17]) + bytes(vals)
    sos = bytes([len(sc.comps)])
    for ci, s in zip(sc.comps, slot):
        sos += bytes([COMP_IDS[ci], (s << 4) if cls == 0 else s])
    sos += bytes([sc.ss, sc.se, (sc.ah << 4) | sc.al])
    return _segment(0xC4, dht) + _segment(0xDA, sos) + pack(em, codes)


# ---------------------------------------------------------------------------
# The search (jcmaster.c select_scans, copy_buffer)
# ---------------------------------------------------------------------------

def search(fr: Frame) -> List[Tuple[ScanSpec, bytes]]:
    """The scans mozjpeg's search writes for these coefficients, in file
    order, each with its bytes."""
    ncomps = len(fr.coefs)
    cands = search_candidates(ncomps)
    n_luma = 1 + (3 * AL_MAX_LUMA + 2) + (2 * len(FREQUENCY_SPLITS) + 1)
    luma_split = 1 + 3 * AL_MAX_LUMA + 2
    n_chroma_dc = 3 if ncomps == 3 else 0
    chroma_split = n_luma + n_chroma_dc + 6 * AL_MAX_CHROMA + 4
    num = n_luma if ncomps == 1 else len(cands)
    size: Dict[int, int] = {}
    used: Dict[int, Tuple[ScanSpec, bytes]] = {}
    al_l = al_c = split_l = split_c = 0
    best = 0
    sn = 0
    while sn < num:
        sc = cands[sn]
        if luma_split <= sn < n_luma:
            sc = sc._replace(al=al_l)
        elif ncomps == 3 and sn >= chroma_split:
            sc = sc._replace(al=al_c)
        data = scan_bytes(fr, sc)
        size[sn] = len(data)
        used[sn] = (sc, data)
        nxt = sn + 1
        if 1 < nxt <= luma_split:
            if (nxt - 1) % 3 == 2:
                al = (nxt - 1) // 3
                cost = size[nxt - 2] + size[nxt - 1] + sum(
                    size[3 + 3 * i] for i in range(al))
                if al == 0 or cost < best:
                    best, al_l = cost, al
                else:
                    sn = luma_split - 1
        elif luma_split < nxt <= n_luma:
            if nxt == luma_split + 1:
                split_l, best = 0, size[nxt - 1]
            elif (nxt - luma_split) % 2 == 1:
                idx = (nxt - luma_split) >> 1
                cost = size[nxt - 2] + size[nxt - 1]
                if cost < best:
                    best, split_l = cost, idx
                if ((idx == 2 and split_l == 0)
                        or (idx == 3 and split_l != 2)
                        or (idx == 4 and split_l != 4)):
                    sn = n_luma - 1
        elif num > n_luma:
            base = n_luma + n_chroma_dc
            if n_luma + n_chroma_dc < nxt <= chroma_split:
                if (nxt - base) % 6 == 4:
                    al = (nxt - base) // 6
                    cost = sum(size[nxt - 4 + i] for i in range(4)) + sum(
                        size[base + 4 + 6 * i] + size[base + 5 + 6 * i]
                        for i in range(al))
                    if al == 0 or cost < best:
                        best, al_c = cost, al
                    else:
                        sn = chroma_split - 1
            elif chroma_split < nxt <= num:
                if nxt == chroma_split + 2:
                    split_c, best = 0, size[nxt - 2] + size[nxt - 1]
                elif (nxt - chroma_split) % 4 == 2:
                    idx = (nxt - chroma_split) >> 2
                    cost = sum(size[nxt - 4 + i] for i in range(4))
                    if cost < best:
                        best, split_c = cost, idx
                    if ((idx == 2 and split_c == 0)
                            or (idx == 3 and split_c != 2)
                            or (idx == 4 and split_c != 4)):
                        sn = num - 1
        sn += 1
    return [used[i] for i in display_order(ncomps, al_l, al_c, split_l,
                                            split_c)]


def display_order(ncomps: int, al_l: int, al_c: int, split_l: int,
                  split_c: int) -> List[int]:
    """The winners' candidate indices in file order (copy_buffer,
    dc_scan_opt_mode 0: the one interleaved DC scan)."""
    n_luma = 1 + (3 * AL_MAX_LUMA + 2) + (2 * len(FREQUENCY_SPLITS) + 1)
    luma_split = 1 + 3 * AL_MAX_LUMA + 2
    cbase = n_luma + (3 if ncomps == 3 else 0)
    chroma_split = cbase + 6 * AL_MAX_CHROMA + 4
    min_al = min(al_l, al_c) if ncomps == 3 else 0
    order = [0]
    if split_l == 0:
        order.append(luma_split)
    else:
        order += [luma_split + 2 * split_l - 1, luma_split + 2 * split_l]
    order += [3 + 3 * al for al in range(al_l - 1, min_al - 1, -1)]
    if ncomps == 3:
        if split_c == 0:
            order += [chroma_split, chroma_split + 1]
        else:
            b = chroma_split + 4 * (split_c - 1)
            order += [b + 2, b + 3, b + 4, b + 5]
        for al in range(al_c - 1, min_al - 1, -1):
            order += [cbase + 6 * al + 4, cbase + 6 * al + 5]
    for al in range(min_al - 1, -1, -1):
        order.append(3 + 3 * al)
        if ncomps == 3:
            order += [cbase + 6 * al + 4, cbase + 6 * al + 5]
    return order


def possible_scripts(ncomps: int) -> set:
    """Every scan list the search can write, as tuples of (components,
    Ss, Se, Ah, Al)."""
    cands = search_candidates(ncomps)
    n_luma = 1 + (3 * AL_MAX_LUMA + 2) + (2 * len(FREQUENCY_SPLITS) + 1)
    luma_split = 1 + 3 * AL_MAX_LUMA + 2
    chroma_split = n_luma + 3 + 6 * AL_MAX_CHROMA + 4
    out = set()
    for al_l in range(AL_MAX_LUMA + 1):
        for al_c in range(AL_MAX_CHROMA + 1 if ncomps == 3 else 1):
            for split_l in range(len(FREQUENCY_SPLITS) + 1):
                for split_c in range(len(FREQUENCY_SPLITS) + 1
                                     if ncomps == 3 else 1):
                    script = []
                    for i in display_order(ncomps, al_l, al_c, split_l,
                                           split_c):
                        sc = cands[i]
                        if luma_split <= i < n_luma:
                            sc = sc._replace(al=al_l)
                        elif ncomps == 3 and i >= chroma_split:
                            sc = sc._replace(al=al_c)
                        script.append(tuple(sc))
                    out.add(tuple(script))
    return out
