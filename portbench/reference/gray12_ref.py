"""Plain reference of what mozjpeg's encoder must write for a 12-bit
grayscale image as DICOM's lossy 12-bit JPEG (JPEG Extended, process 4):
cjpeg -precision 12 with its defaults and progressive off.

The check reads the stream back (jpeg_read's parser and Huffman decoder,
which serve at any precision) and recomputes, from the source samples,
the raw coefficients the encoder quantizes: the level shift by
CENTERJSAMPLE 2048, overshoot deringing (mozjpeg jcdctmgr.c
preprocess_deringing) of the runs of samples at or above its maxsample,
255 - CENTERJSAMPLE, taken as the 8-bit literal 127 (centered) at every
precision as the code reads (jcdctmgr.c:419; a 12-bit cjpeg build would
settle it), and the accurate integer FDCT (jfdctint.c) at 12 bits:
CONST_BITS 13, PASS1_BITS 1. At 12 bits that threshold takes every
sample above 2174 for clipped white, and the headroom cap (127 * 64 -
the block's sum) / count goes negative in most blocks it touches. It
then holds the stream to four things:

  - every quantized coefficient is one the 12-bit trellis may choose
    (jcdctmgr.c quantize_trellis): for an AC coefficient of raw value x
    (8x scaled) and quantizer q, qval = min((|x| + 4q) // 8q, 16383), and
    the trellis keeps 0, qval or 2^k - 1 for k below qval's bit length
    (at most 14), with x's sign; the DC keeps qval + d for |d| <= nc // 2
    clamped to +-16383, nc = min(9, (2 + 60 // q) | 1);
  - on a sample of blocks and block rows drawn from a seed, the
    coefficients are the trellis's own choice: the AC trellis with 14-bit
    lengths (the rate of a run/size symbol from the optimal table of the
    plainly rounded coefficients) and the DC trellis with the standard DC
    table's lengths, whose categories 12 to 15 have no code and cost
    their bits alone, as ehufsi's zeros do in C;
  - the one scan is the sequential coding of the stream's coefficients
    (jchuff.c encode_one_block: the DC difference, each nonzero AC after
    its ZRLs, an EOB after the last nonzero below 63) with the optimal
    DC and AC tables of its own statistics, in one DHT segment before
    the SOS (mozjpeg's emit_multi_dht), byte for byte;
  - the frame is SOF1 at precision 12 with one component sampled 1x1 and
    quant table 3 (jcparam.c, N. Robidoux's) at the configuration's
    quality.

The trellis's squares of coefficients and of their distances to a
candidate are int products, which wrap at 2^31 (a strong 12-bit edge
passes 46,341); the block norm that sets lambda sums float squares. The
limits kmax and maxq are arguments, so that the same check run with the
8-bit limits (kmax 10, maxq 1023) tells the two trellises apart.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

from . import encode_ref, jpeg_read, scan_ref, trellis_ref

PRECISION = 12
CENTER = 1 << (PRECISION - 1)              # CENTERJSAMPLE
MAXS = 127                                 # 255 - CENTERJSAMPLE as kept
KMAX = 14                                  # MAX_COEF_BITS at 12 bits
MAXQ = (1 << KMAX) - 1
SOF1 = 0xC1
COMP_ID = 1
_MARKER = re.compile(rb"\xff[^\x00]|\xff$")   # in entropy-coded data

f32 = np.float32


def _wrap32(x):
    """x (int64) as C's int: two's complement wrap at 2^31."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# ---------------------------------------------------------------------------
# Samples -> raw coefficients
# ---------------------------------------------------------------------------

def blocks(pl: np.ndarray) -> np.ndarray:
    """(bh * 8, bw * 8) plane -> (bh, bw, 64) natural-order blocks."""
    return encode_ref.blocks(pl)


def dering(blk: np.ndarray, q0: int, maxs: int = MAXS) -> np.ndarray:
    """preprocess_deringing over (N, 64) natural-order centred samples
    (int64): in each block with some but not all samples at or above
    maxs, every run of them along the zigzag walk becomes a Catmull-Rom
    overshoot curve, ceil'd and capped at maxs + min(31, 2 q0, headroom),
    in float32 arithmetic as the C code rounds it."""
    out = blk.copy()
    zz = blk[:, jpeg_read.ZIGZAG]
    hit = zz >= maxs
    cnt = hit.sum(1)
    act = np.nonzero((cnt > 0) & (cnt < 64))[0]
    if act.size == 0:
        return out
    zz, hit, cnt = zz[act], hit[act], cnt[act]
    num = maxs * 64 - zz.sum(1)
    head = np.sign(num) * (np.abs(num) // cnt)          # C's truncation
    maxover = maxs + np.minimum(min(31, 2 * int(q0)), head)
    new = zz.copy()
    fmax = f32(maxs)
    for bi in range(zz.shape[0]):
        row, m = zz[bi], hit[bi]
        n = 0
        while n < 64:
            if not m[n]:
                n += 1
                continue
            start = n
            while n < 64 and m[n]:
                n += 1
            end = n
            f1 = int(row[start - 1 if start >= 1 else 0])
            f2 = int(row[start - 2 if start >= 2 else 0])
            l1 = int(row[end if end < 63 else 63])
            l2 = int(row[end + 1 if end < 62 else 63])
            fslope = max(f1 - f2, maxs - f1)
            lslope = max(l1 - l2, maxs - l1)
            if start == 0:
                fslope = lslope
            if end == 64:
                lslope = fslope
            length = end - start
            step = f32(1.0) / f32(length + 1)
            pos = step
            tan1 = f32(fslope * length)
            tan2 = f32(-lslope * length)
            for i in range(start, end):
                t2 = pos * pos
                t3 = t2 * pos
                c1 = (f32(2.0) * t3 - f32(3.0) * t2) + f32(1.0)
                c2 = (f32(-2.0) * t3) + f32(3.0) * t2
                c3 = (t3 - f32(2.0) * t2) + pos
                c4 = t3 - t2
                val = ((fmax * c1 + tan1 * c3) + fmax * c2) + tan2 * c4
                new[bi, i] = min(int(np.ceil(val)), int(maxover[bi]))
                pos = f32(pos + step)
    res = np.empty_like(new)
    res[:, jpeg_read.ZIGZAG] = new
    out[act] = res
    return out


class F:
    """jfdctint.c's FIX() constants, CONST_BITS 13."""


for _name, _x in (("0_298", 0.298631336), ("0_390", 0.390180644),
                  ("0_541", 0.541196100), ("0_765", 0.765366865),
                  ("0_899", 0.899976223), ("1_175", 1.175875602),
                  ("1_501", 1.501321110), ("1_847", 1.847759065),
                  ("1_961", 1.961570560), ("2_053", 2.053119869),
                  ("2_562", 2.562915447), ("3_072", 3.072711026)):
    setattr(F, "F_" + _name, int(_x * (1 << 13) + 0.5))

CONST_BITS = 13


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, first: bool, pass1_bits: int):
    """One jfdctint.c pass over axis -1 of int64 d (..., 8)."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    if first:
        sh = CONST_BITS - pass1_bits
        o0, o4 = (t10 + t11) << pass1_bits, (t10 - t11) << pass1_bits
    else:
        sh = CONST_BITS + pass1_bits
        o0 = _descale(t10 + t11, pass1_bits)
        o4 = _descale(t10 - t11, pass1_bits)
    z1 = (t12 + t13) * F.F_0_541
    o2 = _descale(z1 + t13 * F.F_0_765, sh)
    o6 = _descale(z1 - t12 * F.F_1_847, sh)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * F.F_1_175
    t4 = t4 * F.F_0_298
    t5 = t5 * F.F_2_053
    t6 = t6 * F.F_3_072
    t7 = t7 * F.F_1_501
    z1 = z1 * -F.F_0_899
    z2 = z2 * -F.F_2_562
    z3 = z3 * -F.F_1_961 + z5
    z4 = z4 * -F.F_0_390 + z5
    o7 = _descale(t4 + z1 + z3, sh)
    o5 = _descale(t5 + z2 + z4, sh)
    o3 = _descale(t6 + z2 + z3, sh)
    o1 = _descale(t7 + z1 + z4, sh)
    return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], -1)


def fdct_islow(blk: np.ndarray, pass1_bits: int = 1) -> np.ndarray:
    """(..., 64) natural-order centred samples -> (..., 64) natural-order
    coefficients, 8x scaled as jpeg_fdct_islow leaves them (PASS1_BITS 1
    at 12 bits, 2 at 8)."""
    b = blk.astype(np.int64).reshape(blk.shape[:-1] + (8, 8))
    rows = _fdct_1d(b, True, pass1_bits)
    cols = _fdct_1d(np.swapaxes(rows, -1, -2), False, pass1_bits)
    return np.swapaxes(cols, -1, -2).reshape(blk.shape)


def raw_coefficients(plane: np.ndarray, q0: int, deringing: bool,
                     maxs: int = MAXS):
    """A (H, W) 12-bit plane of whole blocks -> (bh, bw, 64) natural raw
    coefficients as the trellis receives them; maxs deringing's centered
    threshold."""
    blk = blocks(plane.astype(np.int64) - CENTER)
    bh, bw = blk.shape[:2]
    flat = blk.reshape(-1, 64)
    if deringing:
        flat = dering(flat, q0, maxs)
    return fdct_islow(flat, 1).reshape(bh, bw, 64)


def plain_quantized(raw: np.ndarray, q: np.ndarray,
                    deringing: bool) -> np.ndarray:
    """Round-half-away quantization of raw (..., 64) by q (64,) in the
    same order, with the post-dering clamp to +-(2^(p+2) - 1)
    (jcdctmgr.c): the coefficients whose statistics give the trellis its
    AC rates."""
    x = np.abs(raw)
    out = np.sign(raw) * ((x + 4 * q) // (8 * q))
    if deringing:
        lim = (1 << (PRECISION + 2)) - 1
        out = np.clip(out, -lim, lim)
    return out


# ---------------------------------------------------------------------------
# The trellis (jcdctmgr.c quantize_trellis), with its limits as arguments
# ---------------------------------------------------------------------------

def rate_table(si: np.ndarray, kmax: int = KMAX):
    """-> (rate[r, k] f32 for a run r in 0..62 before a coefficient of
    k+1 bits, k < kmax, BIG where it has no code; the EOB length)."""
    r = np.arange(63)[:, None]
    k = np.arange(kmax)[None, :]
    cl = si[16 * (r & 15) + k + 1]
    zrl = si[0xF0]
    ok = (cl > 0) & ((r < 16) | (zrl > 0))
    rate = (cl.astype(f32) + (k + 1).astype(f32)) + \
        (r >> 4).astype(f32) * f32(zrl)
    return np.where(ok, rate, trellis_ref.BIG).astype(f32), f32(si[0])


def trellis_ac(raw_zz: np.ndarray, q_zz: np.ndarray, lam: np.ndarray,
               rate: np.ndarray, eobl, kmax: int = KMAX,
               maxq: int = MAXQ) -> np.ndarray:
    """raw_zz (n, 64) zigzag raw coefficients, q_zz (64,), lam (n,) ->
    (n, 63) the trellis's AC coefficients (zigzag 1..63): a Viterbi over
    position i, the previous kept nonzero j and the candidate's bit length
    k < min(kmax, nbits(qval)), in float32 in the order mozjpeg adds,
    ties to the first candidate."""
    big = trellis_ref.BIG
    n = len(raw_zz)
    x = np.abs(raw_zz).astype(np.int64)
    q8 = q_zz.astype(np.int64) << 3
    ltbl = trellis_ref.weights(q_zz)
    qval = np.minimum((x + (q8 >> 1)) // q8, maxq)
    zterm = (_wrap32(x * x).astype(f32) * lam[:, None]) * ltbl[None, :]
    zterm[:, 0] = 0
    azd = np.empty_like(zterm)
    run = zterm[:, 0]
    azd[:, 0] = run
    for i in range(1, 64):
        run = run + zterm[:, i]
        azd[:, i] = run
    nc = scan_ref.nbits(qval)
    pos = np.arange(64)
    nonzero = qval != 0
    nonzero[:, 0] = False
    jvalid = nonzero.copy()
    jvalid[:, 0] = True
    acc = np.full((n, 64), big, f32)
    acc[:, 0] = 0
    rs = np.zeros((n, 64), np.int64)
    bv = np.zeros((n, 64), np.int64)
    kv = np.arange(kmax)
    rows = np.arange(n)
    for i in range(1, 64):
        qv, nci = qval[:, i], nc[:, i]
        cand = np.where(kv[None, :] == (nci - 1)[:, None], qv[:, None],
                        (2 << kv)[None, :] - 1)                  # (n, K)
        delta = _wrap32(cand * q8[i] - x[:, i:i + 1])
        cdist = (_wrap32(delta * delta).astype(f32) * lam[:, None]) \
            * ltbl[i]
        r = i - 1 - pos
        rt = np.where((r >= 0)[:, None], rate[np.clip(r, 0, 62)], big)
        tail = (azd[:, i - 1:i] - azd) + acc
        cost = (rt[None] + cdist[:, None, :]) + tail[:, :, None]
        valid = ((jvalid & (pos < i)[None])[:, :, None]
                 & ((kv[None] < nci[:, None]) & (qv != 0)[:, None])[:, None]
                 & (rt < big)[None])
        cost = np.where(valid, cost, big)
        kidx = cost.argmin(2)
        bestc = np.take_along_axis(cost, kidx[..., None], 2)[..., 0]
        upd = bestc < big
        bestcand = np.where(upd, np.take_along_axis(cand, kidx, 1), 0)
        jidx = bestc.argmin(1)
        acc[:, i] = np.where(qv != 0, bestc[rows, jidx], big)
        rs[:, i] = jidx
        bv[:, i] = bestcand[rows, jidx]
    azd_se = azd[:, 63]
    end_wo = (acc + azd_se[:, None]) - azd
    end_cost = end_wo + np.where(pos < 63, eobl, f32(0))[None]
    end_cost = np.where(nonzero, end_cost, big)
    end_cost[:, 0] = azd_se + eobl
    last = end_cost.argmin(1)
    out = np.zeros((n, 64), np.int64)
    cur = last
    for _ in range(63):
        on = cur >= 1
        keep = on & nonzero[rows, cur]
        val = np.where(raw_zz[rows, cur] < 0, -bv[rows, cur], bv[rows, cur])
        out[rows[keep], cur[keep]] = val[keep]
        cur = np.where(on, rs[rows, cur], 0)
    return out[:, 1:]


def trellis_dc_rows(raw_dc: np.ndarray, last0: np.ndarray, q0: int,
                    si: np.ndarray, lam_dc: np.ndarray, nc: int,
                    maxq: int = MAXQ) -> np.ndarray:
    """Independent block rows: raw_dc (R, L) raw DCs, last0 (R,) the DC
    each row starts from, lam_dc (R, L) f32 lambda / q0^2 -> (R, L) the
    trellis's DCs (candidates qval - nc//2 .. qval + nc//2 clamped to
    +-maxq; the rate of a difference d is nbits(|d|) + si[nbits(|d|)])."""
    R, L = raw_dc.shape
    q8 = q0 * 8
    sign = np.where(raw_dc < 0, -1, 1)
    x = np.abs(raw_dc).astype(np.int64)
    qval = (x + q8 // 2) // q8
    ks = np.arange(nc)
    mag = np.clip(qval[..., None] - nc // 2 + ks, -maxq, maxq)
    delta = _wrap32(mag * q8 - x[..., None])
    dist = _wrap32(delta * delta).astype(f32) * lam_dc[..., None]
    cand = mag * sign[..., None]

    def trans(d):
        b = scan_ref.nbits(np.abs(d))
        return (b + si[b]).astype(f32)

    acc = trans(cand[:, 0, :] - last0[:, None]) + dist[:, 0, :]
    bts = np.zeros((L, R, nc), np.int64)
    rows = np.arange(R)
    for t in range(1, L):
        step = (trans(cand[:, t, None, :] - cand[:, t - 1, :, None])
                + dist[:, t, None, :])
        cost = step + acc[:, :, None]
        bt = cost.argmin(1)
        bts[t] = bt
        acc = np.take_along_axis(cost, bt[:, None], 1)[:, 0]
    cur = acc.argmin(1)
    out = np.empty((R, L), np.int64)
    for t in range(L - 1, -1, -1):
        out[:, t] = cand[rows, t, cur]
        if t:
            cur = bts[t][rows, cur]
    return out


def outside_candidates(raw: np.ndarray, got: np.ndarray, qt: np.ndarray,
                       maxq: int = MAXQ) -> int:
    """How many of the written coefficients (natural order, same shape as
    raw) the trellis could not have chosen."""
    q = qt.astype(np.int64)
    x = np.abs(raw)
    sign = np.where(raw < 0, -1, 1)
    qval = np.minimum((x + 4 * q) // (8 * q), maxq)
    got = got.astype(np.int64)
    ac, dc = got[..., 1:], got[..., 0]
    qv = qval[..., 1:]
    mag = np.abs(ac)
    nc = scan_ref.nbits(qv)
    mask_form = ((mag & (mag + 1)) == 0) & (scan_ref.nbits(mag) < nc)
    ok = (mag == 0) | (mag == qv) | mask_form
    ok &= (ac == 0) | (np.sign(ac) == sign[..., 1:])
    q0 = int(q[0])
    half = trellis_ref.num_dc_candidates(q0) // 2
    m = dc * sign[..., 0]
    lo = np.clip(qval[..., 0] - half, -maxq, maxq)
    hi = np.clip(qval[..., 0] + half, -maxq, maxq)
    okdc = (m >= lo) & (m <= hi)
    return int((~ok).sum() + (~okdc).sum())


def bad_trellis(raw: np.ndarray, got: np.ndarray, qt: np.ndarray,
                deringing: bool, rng, n_blocks: int, n_rows: int,
                kmax: int = KMAX, maxq: int = MAXQ) -> int:
    """The sampled blocks whose AC coefficients, and the sampled block
    rows whose DCs, differ from the trellis's: n_blocks blocks and n_rows
    rows drawn by rng. raw, got: (rows, cols, 64) natural order."""
    rows, cols = raw.shape[:2]
    q_zz = qt[jpeg_read.ZIGZAG]
    raw_zz = raw[..., jpeg_read.ZIGZAG].reshape(-1, 64)
    plain = plain_quantized(raw_zz, q_zz, deringing)
    rate, eobl = rate_table(trellis_ref.ac_lengths(plain), kmax)
    lam = trellis_ref.lambdas(raw.reshape(-1, 64))
    pick = rng.choice(len(raw_zz), min(n_blocks, len(raw_zz)),
                      replace=False)
    ac = trellis_ac(raw_zz[pick], q_zz, lam[pick], rate, eobl, kmax, maxq)
    got_zz = got[..., jpeg_read.ZIGZAG].reshape(-1, 64)
    bad = int(np.any(ac != got_zz[pick, 1:], 1).sum())
    r = np.sort(rng.choice(rows, min(n_rows, rows), replace=False))
    q0 = int(q_zz[0])
    lam_dc = lam.reshape(rows, cols)[r] * trellis_ref.weights(q_zz)[0]
    dc = trellis_dc_rows(raw[r, :, 0], np.zeros(len(r), np.int64), q0,
                         trellis_ref.std_dc_lengths(0), lam_dc,
                         trellis_ref.num_dc_candidates(q0), maxq)
    return bad + int(np.any(dc != got[r, :, 0], 1).sum())


# ---------------------------------------------------------------------------
# The sequential scan (jchuff.c) with its own optimal tables
# ---------------------------------------------------------------------------

DC_SLOT, AC_SLOT = 0, 1      # emission table keys of the one component


def _emissions(key, sym, tbl, xval, xlen) -> scan_ref.Emissions:
    n = len(key)
    return scan_ref.Emissions(*(np.broadcast_to(np.asarray(a, np.int64),
                                                (n,)).copy()
                                for a in (key, sym, tbl, xval, xlen)))


def sequential_emissions(zz: np.ndarray) -> scan_ref.Emissions:
    """zz (n, 64) zigzag blocks in raster order -> the emissions of one
    sequential scan of them: per block the DC difference's category and
    bits, then per nonzero AC a ZRL for every 16 zeros before it and its
    run/size symbol and bits, then EOB where the block ends in zeros."""
    c = zz.astype(np.int64)
    n = len(c)
    blk = scan_ref.BLK
    dc = c[:, 0]
    diff = np.diff(dc, prepend=0)
    nb = scan_ref.nbits(np.abs(diff))
    x = np.where(diff < 0, diff - 1, diff) & ((1 << nb) - 1)
    parts = [_emissions(np.arange(n) * blk, nb, DC_SLOT, x, nb)]
    ac = c[:, 1:]
    b, k = np.nonzero(ac)                       # block-major, k ascending
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, -1, np.concatenate([[-1], k[:-1]]))
    run = k - prev - 1
    v = ac[b, k]
    nb = scan_ref.nbits(np.abs(v))
    x = np.where(v < 0, v - 1, v) & ((1 << nb) - 1)
    pt = b * blk + scan_ref.POINTS + k * 512
    zi, zj = np.nonzero((run >> 4)[:, None] > np.arange(4)[None, :])
    parts += [_emissions(pt + 8, ((run & 15) << 4) | nb, AC_SLOT, x, nb),
              _emissions(pt[zi] + zj, 0xF0, AC_SLOT, 0, 0)]
    eob = np.nonzero(ac[:, -1] == 0)[0]
    parts.append(_emissions(eob * blk + scan_ref.POST, 0x00, AC_SLOT, 0, 0))
    cat = [np.concatenate([getattr(p, f) for p in parts])
           for f in scan_ref.Emissions._fields]
    order = np.argsort(cat[0], kind="stable")
    return scan_ref.Emissions(*(a[order] for a in cat))


def _segment(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def scan_bytes(coefs: np.ndarray) -> bytes:
    """(rows, cols, 64) zigzag coefficients of the one component -> its
    scan as the encoder writes it: one DHT segment with the optimal DC
    table (class 0, slot 0) then AC table (class 1, slot 0) of the scan's
    own symbol counts, the SOS, and the entropy-coded data."""
    em = sequential_emissions(coefs.reshape(-1, 64))
    has = em.sym >= 0
    dht, codes = b"", {}
    for slot, cls in ((DC_SLOT, 0), (AC_SLOT, 1)):
        m = has & (em.tbl == slot)
        bits, vals = scan_ref.gen_optimal_table(
            np.bincount(em.sym[m], minlength=256))
        codes[slot] = scan_ref.code_table(bits, vals)
        dht += bytes([cls << 4]) + bytes(bits[1:17]) + bytes(vals)
    sos = bytes([1, COMP_ID, 0x00, 0, 63, 0])
    return _segment(0xC4, dht) + _segment(0xDA, sos) + scan_ref.pack(em,
                                                                    codes)


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------

class Read(NamedTuple):
    frame: jpeg_read.Frame
    coefs: np.ndarray            # (rows, cols, 64) zigzag


def frame_ok(fr: jpeg_read.Frame, w: int, h: int, quality: int) -> bool:
    """SOF1 alone among the frame markers, precision 12, one component
    sampled 1x1 on quant table 3 at `quality`, one sequential scan of it
    over the whole spectrum."""
    sofs = [m for m in fr.markers if 0xC0 <= m <= 0xCF
            and m not in (0xC4, 0xC8, 0xCC)]
    if sofs != [SOF1] or fr.precision != PRECISION:
        return False
    if (fr.width, fr.height) != (w, h) or len(fr.comps) != 1:
        return False
    c = fr.comps[0]
    if (c.cid, c.h, c.v) != (COMP_ID, 1, 1) or c.tq not in fr.qtables:
        return False
    nat = fr.qtables[c.tq][np.argsort(jpeg_read.ZIGZAG)]
    if not np.array_equal(nat, encode_ref.qtable(quality)):
        return False
    if len(fr.scans) != 1:
        return False
    s = fr.scans[0]
    return (s.comps, s.ss, s.se, s.ah, s.al) == ((0,), 0, 63, 0, 0) \
        and s.dc_tables[0] is not None and s.ac_tables[0] is not None


def read(data: bytes, w: int, h: int, quality: int):
    """The stream's frame and its coefficients, or None where it does not
    parse or is not this configuration's frame. jpeg_read's decoder runs
    the sequential scan at any precision (its coefficients() takes 8-bit
    frames only)."""
    try:
        fr = jpeg_read.parse(data)
        if not frame_ok(fr, w, h, quality):
            return None
        coefs = jpeg_read._Decoder(fr).run()[0]
    except jpeg_read.JpegError:
        return None
    return Read(fr, coefs)


def header_ok(data: bytes, w: int, h: int, quality: int) -> bool:
    """The cheap check of an answer: its markers up to the scan's data
    parse into this configuration's frame, tables and single scan, and
    the data that follows holds no marker (every 0xFF byte stuffed) up to
    the EOI that ends the stream: a regular expression reads the data,
    where jpeg_read.parse walks it in Python."""
    pos = 2
    while data[:2] == b"\xff\xd8" and pos + 4 <= len(data) \
            and data[pos] == 0xFF:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xDA:
            pos = end
            continue
        if data[-2:] != b"\xff\xd9" or _MARKER.search(data, end,
                                                   len(data) - 2):
            return False
        try:
            fr = jpeg_read.parse(data[:end] + b"\xff\xd9")
        except jpeg_read.JpegError:
            return False
        return frame_ok(fr, w, h, quality)
    return False


def check_stream(data: bytes, img: np.ndarray, quality: int,
                 deringing: bool, seed=0, n_blocks: int = 512,
                 n_rows: int = 8, kmax: int = KMAX,
                 maxq: int = MAXQ, maxs: int = MAXS) -> dict:
    """Read the stream back and hold it to the (H, W) 12-bit source:
    {"bad_stream": 0 or 1 (unreadable, or not this configuration's
    frame), "bad_coef": coefficients outside the trellis's candidates,
    "bad_scan": 1 where the scan is not the optimal-table coding of its
    coefficients, "bad_trellis": sampled blocks and rows other than the
    trellis's, "coefs": coefficients checked}. seed draws the trellis's
    sample; kmax and maxq are the trellis's limits, maxs deringing's
    threshold. The image has to be whole blocks."""
    h, w = img.shape
    if h % 8 or w % 8:
        raise ValueError("the reference holds whole blocks only")
    got = read(data, w, h, quality)
    if got is None:
        return {"bad_stream": 1, "bad_coef": 0, "bad_scan": 0,
                "bad_trellis": 0, "coefs": 0}
    qt = encode_ref.qtable(quality)
    raw = raw_coefficients(np.asarray(img), int(qt[0]), deringing, maxs)
    nat = np.zeros_like(got.coefs, dtype=np.int64)
    nat[..., jpeg_read.ZIGZAG] = got.coefs
    return {"bad_stream": 0,
            "bad_coef": outside_candidates(raw, nat, qt, maxq),
            "bad_scan": int(scan_bytes(got.coefs) != got.frame.scans[0].raw),
            "bad_trellis": bad_trellis(raw, nat, qt, deringing,
                                       np.random.default_rng(seed),
                                       n_blocks, n_rows, kmax, maxq),
            "coefs": raw.size}
