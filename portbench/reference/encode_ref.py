"""Plain reference of what mozjpeg's default encoder must put in a JPEG.

The check reads the bytes back (jpeg_read) and recomputes, from the
source pixels, the raw coefficients the encoder quantizes: colour
conversion (jccolor.c), h2v2 downsampling with its alternating bias
(jcsample.c), overshoot deringing (mozjpeg jcdctmgr.c
preprocess_deringing) and the accurate integer FDCT (jfdctint.c). It
then holds the stream to four things:

  - every quantized coefficient is one the trellis may choose (jcdctmgr.c
    quantize_trellis): for an AC coefficient of raw value x (8x scaled)
    and quantizer q, qval = (|x| + 4q) // 8q, and the trellis keeps 0,
    qval or 2^k - 1 for k below qval's bit length, with x's sign; the
    DC keeps qval + d for |d| <= nc // 2, nc = min(9, (2 + 60 // q) | 1);
  - on a sample of blocks and block rows drawn from a seed, the
    coefficients are the trellis's own choice (trellis_ref);
  - the scans are those mozjpeg's scan search picks for the stream's
    coefficients, each coded with its own optimal Huffman tables, byte
    for byte (scan_ref);
  - the frame, the quant tables (jcparam.c's table 3, N. Robidoux's,
    the JCP_MAX_COMPRESSION default, scaled by jpeg_quality_scaling) and
    the sampling are the configuration's.
"""
from __future__ import annotations

import numpy as np

from . import jpeg_read, scan_ref, trellis_ref

# mozjpeg jcparam.c std_luminance_quant_tbl[3] = std_chrominance_quant_tbl[3]
ROBIDOUX = np.array([
    16, 16, 16, 18, 25, 37, 56, 85,
    16, 17, 20, 27, 34, 40, 53, 75,
    16, 20, 24, 31, 43, 62, 91, 135,
    18, 27, 31, 40, 53, 74, 106, 156,
    25, 34, 43, 53, 69, 94, 131, 189,
    37, 40, 62, 74, 94, 124, 169, 238,
    56, 53, 91, 106, 131, 169, 226, 311,
    85, 75, 135, 156, 189, 238, 311, 418], dtype=np.int64)

MAXQ = 1023          # the largest 8-bit coefficient the trellis keeps
DC_CAND_MAX = 9


def qtable(quality: int) -> np.ndarray:
    """(64,) natural-order table of jpeg_set_quality(quality) over table 3
    (the same for luma and chroma), clamped to 1..32767 as
    jpeg_add_quant_table does without force_baseline (cjpeg's default)."""
    q = min(max(int(quality), 1), 100)
    sf = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((ROBIDOUX * sf + 50) // 100, 1, 32767)


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c rgb_ycc_convert -> three (H, W) int64 planes."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    off = 128 << 16
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b
         + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + off + half - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + off + half - 1) >> 16
    return y, cb, cr


def _pad(pl: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the right column and bottom row out to (h, w)
    (jcsample.c expand_right_edge, jcprepct.c expand_bottom_edge)."""
    return np.pad(pl, ((0, h - pl.shape[0]), (0, w - pl.shape[1])),
                  mode="edge")


def downsample_h2v2(pl: np.ndarray) -> np.ndarray:
    """jcsample.c h2v2_downsample of an even-sized plane: the 2x2 sum plus
    a bias of 1, 2, 1, 2, ... along each row, over 4."""
    s = pl[0::2, 0::2] + pl[0::2, 1::2] + pl[1::2, 0::2] + pl[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias[None, :]) >> 2


def component_planes(rgb: np.ndarray, h_samp: int = 2, v_samp: int = 2):
    """The sample planes the FDCT sees, padded to whole MCUs: Y at full
    size, Cb and Cr downsampled (4:2:0) or not (4:4:4)."""
    h, w = rgb.shape[:2]
    mh, mw = 8 * v_samp, 8 * h_samp
    ph, pw = -(-h // mh) * mh, -(-w // mw) * mw
    y, cb, cr = (_pad(p, ph, pw) for p in rgb_to_ycc(rgb))
    if (h_samp, v_samp) == (1, 1):
        return [y, cb, cr]
    if (h_samp, v_samp) != (2, 2):
        raise ValueError("only 4:2:0 and 4:4:4 are handled")
    return [y, downsample_h2v2(cb), downsample_h2v2(cr)]


def blocks(pl: np.ndarray) -> np.ndarray:
    """(bh * 8, bw * 8) plane -> (bh, bw, 64) natural-order blocks."""
    bh, bw = pl.shape[0] // 8, pl.shape[1] // 8
    return pl.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh, bw, 64)


def dering(blk: np.ndarray, q0: int) -> np.ndarray:
    """preprocess_deringing over (N, 64) natural-order centred samples
    (int64): in each block with some but not all samples at 127, every run
    of them along the zigzag walk becomes a Catmull-Rom overshoot curve,
    ceil'd and capped, in float32 arithmetic as the C code rounds it."""
    maxs = 127
    out = blk.copy()
    zz = blk[:, jpeg_read.ZIGZAG]                      # walk order
    hit = zz >= maxs
    cnt = hit.sum(1)
    act = np.nonzero((cnt > 0) & (cnt < 64))[0]
    if act.size == 0:
        return out
    zz, hit, cnt = zz[act], hit[act], cnt[act]
    total = zz.sum(1)
    head = np.trunc((maxs * 64 - total) / cnt).astype(np.int64)
    maxover = maxs + np.minimum(min(31, 2 * int(q0)), head)
    new = zz.copy()
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
            step = np.float32(1.0) / np.float32(length + 1)
            pos = step
            tan1 = np.float32(fslope * length)
            tan2 = np.float32(-lslope * length)
            v = np.float32(maxs)
            for i in range(start, end):
                t2 = pos * pos
                t3 = t2 * pos
                c1 = (np.float32(2.0) * t3 - np.float32(3.0) * t2) \
                    + np.float32(1.0)
                c2 = (np.float32(-2.0) * t3) + np.float32(3.0) * t2
                c3 = (t3 - np.float32(2.0) * t2) + pos
                c4 = t3 - t2
                val = ((v * c1 + tan1 * c3) + v * c2) + tan2 * c4
                new[bi, i] = min(int(np.ceil(val)), int(maxover[bi]))
                pos = np.float32(pos + step)
    res = np.empty_like(new)
    res[:, jpeg_read.ZIGZAG] = new
    out[act] = res
    return out


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


class F:
    """jfdctint.c's FIX() constants, CONST_BITS 13."""


for _name, _x in (("0_298", 0.298631336), ("0_390", 0.390180644),
                  ("0_541", 0.541196100), ("0_765", 0.765366865),
                  ("0_899", 0.899976223), ("1_175", 1.175875602),
                  ("1_501", 1.501321110), ("1_847", 1.847759065),
                  ("1_961", 1.961570560), ("2_053", 2.053119869),
                  ("2_562", 2.562915447), ("3_072", 3.072711026)):
    setattr(F, "F_" + _name, int(_x * (1 << 13) + 0.5))


def _fdct_1d(d, first: bool):
    """One jfdctint.c pass over axis -1 of int64 d (..., 8)."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    sh = 13 - 2 if first else 13 + 2
    if first:
        o0, o4 = (t10 + t11) << 2, (t10 - t11) << 2
    else:
        o0, o4 = _descale(t10 + t11, 2), _descale(t10 - t11, 2)
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


def fdct_islow(blk: np.ndarray) -> np.ndarray:
    """(..., 64) natural-order centred samples -> (..., 64) natural-order
    coefficients, 8x scaled as jpeg_fdct_islow leaves them."""
    b = blk.astype(np.int64).reshape(blk.shape[:-1] + (8, 8))
    rows = _fdct_1d(b, True)                              # over each row
    cols = _fdct_1d(np.swapaxes(rows, -1, -2), False)     # over columns
    return np.swapaxes(cols, -1, -2).reshape(blk.shape)


def raw_coefficients(pl: np.ndarray, qt: np.ndarray, deringing: bool):
    """A padded component plane -> (bh, bw, 64) natural raw coefficients
    as the trellis receives them."""
    blk = blocks(pl.astype(np.int64) - 128)
    bh, bw = blk.shape[:2]
    flat = blk.reshape(-1, 64)
    if deringing:
        flat = dering(flat, int(qt[0]))
    return fdct_islow(flat).reshape(bh, bw, 64)


def outside_candidates(raw: np.ndarray, got: np.ndarray,
                       qt: np.ndarray) -> int:
    """How many of the written coefficients (natural order, same shape as
    raw) the trellis could not have chosen."""
    q = qt.astype(np.int64)
    x = np.abs(raw)
    sign = np.where(raw < 0, -1, 1)
    qval = np.minimum((x + 4 * q) // (8 * q), MAXQ)
    got = got.astype(np.int64)
    ac, dc = got[..., 1:], got[..., 0]
    qv = qval[..., 1:]
    mag = np.abs(ac)
    nc = scan_ref.nbits(qv)
    mask_form = ((mag & (mag + 1)) == 0) & (scan_ref.nbits(mag) < nc)
    ok = (mag == 0) | (mag == qv) | mask_form
    ok &= (ac == 0) | (np.sign(ac) == sign[..., 1:])
    q0 = int(q[0])
    ncd = min(DC_CAND_MAX, (2 + 60 // q0) | 1)
    half = ncd // 2
    m = dc * sign[..., 0]
    lo = np.clip(qval[..., 0] - half, -MAXQ, MAXQ)
    hi = np.clip(qval[..., 0] + half, -MAXQ, MAXQ)
    okdc = (m >= lo) & (m <= hi)
    return int((~ok).sum() + (~okdc).sum())


def bad_scans(fr, coefs) -> int:
    """The scans that differ from what mozjpeg's scan search and optimal
    Huffman tables write for these coefficients: by their parameters or
    by a byte of their DHT, SOS or data; a scan missing or extra counts
    one."""
    maxh = max(c.h for c in fr.comps)
    maxv = max(c.v for c in fr.comps)
    sf = scan_ref.Frame(list(coefs),
                        [jpeg_read.real_grid(fr, ci) for ci in range(len(coefs))],
                        [(c.h, c.v) for c in fr.comps],
                        -(-fr.width // (8 * maxh)),
                        -(-fr.height // (8 * maxv)))
    want = [((tuple(sc.comps), sc.ss, sc.se, sc.ah, sc.al), data)
            for sc, data in scan_ref.search(sf)]
    got = [((s.comps, s.ss, s.se, s.ah, s.al), s.raw) for s in fr.scans]
    return (sum(g != w for g, w in zip(got, want))
            + abs(len(got) - len(want)))


def bad_trellis(raws, coefs, grids, qt: np.ndarray, v_samp, rng,
                n_blocks: int, n_rows: int) -> int:
    """The sampled blocks whose AC coefficients, and the sampled block
    rows whose DCs, differ from the trellis's (trellis_ref), per
    component n_blocks blocks and n_rows rows drawn by rng."""
    q_zz = qt[jpeg_read.ZIGZAG]
    bad = 0
    for ci, (raw, got, (rows, cols)) in enumerate(zip(raws, coefs, grids)):
        raw = raw[:rows, :cols]
        got = np.asarray(got, np.int64)[:rows, :cols]
        raw_zz = raw[..., jpeg_read.ZIGZAG].reshape(-1, 64)
        x = np.abs(raw_zz)
        plain = np.sign(raw_zz) * ((x + 4 * q_zz) // (8 * q_zz))
        rate, eobl = trellis_ref.rate_table(trellis_ref.ac_lengths(plain))
        lam = trellis_ref.lambdas(raw.reshape(-1, 64))
        pick = rng.choice(len(raw_zz), min(n_blocks, len(raw_zz)),
                          replace=False)
        ac = trellis_ref.trellis_ac(raw_zz[pick], q_zz, lam[pick], rate,
                                    eobl)
        bad += int(np.any(ac != got.reshape(-1, 64)[pick, 1:], 1).sum())
        v = v_samp if ci == 0 else 1
        r = np.sort(rng.choice(rows, min(n_rows, rows), replace=False))
        last0 = np.where(r % v == 0, 0, got[r - 1, -1, 0])
        q0 = int(q_zz[0])
        lam_dc = lam.reshape(rows, cols)[r] * trellis_ref.weights(q_zz)[0]
        dc = trellis_ref.trellis_dc_rows(
            raw[r, :, 0], last0, q0,
            trellis_ref.std_dc_lengths(0 if ci == 0 else 1), lam_dc,
            trellis_ref.num_dc_candidates(q0))
        bad += int(np.any(dc != got[r, :, 0], 1).sum())
    return bad


def _frame_ok(fr, w: int, h: int, quality: int, progressive: bool,
              h_samp: int, v_samp: int) -> bool:
    samp = [(c.h, c.v) for c in fr.comps]
    qt = qtable(quality)
    return ((fr.width, fr.height) == (w, h)
            and fr.progressive == progressive
            and samp == [(h_samp, v_samp), (1, 1), (1, 1)]
            and all(np.array_equal(fr.qtables.get(c.tq, np.zeros(64))
                                   [np.argsort(jpeg_read.ZIGZAG)], qt)
                    for c in fr.comps))


_SCRIPTS = {}


def header_ok(data: bytes, w: int, h: int, quality: int, progressive: bool,
              h_samp: int, v_samp: int) -> bool:
    """The cheap check of an answer: it parses, its frame, quant tables
    and sampling are the configuration's, and its scans are a list that
    the scan search can write."""
    try:
        fr = jpeg_read.parse(data)
    except jpeg_read.JpegError:
        return False
    n = len(fr.comps)
    if n not in _SCRIPTS:
        _SCRIPTS[n] = scan_ref.possible_scripts(n)
    script = tuple((s.comps, s.ss, s.se, s.ah, s.al) for s in fr.scans)
    return (_frame_ok(fr, w, h, quality, progressive, h_samp, v_samp)
            and script in _SCRIPTS[n])


def check_stream(data: bytes, rgb: np.ndarray, quality: int,
                 progressive: bool, h_samp: int, v_samp: int,
                 deringing: bool, seed=0, n_blocks: int = 512,
                 n_rows: int = 8) -> dict:
    """Read the stream back and hold it to the source: {"bad_stream": 0
    or 1 (unreadable, or a frame, table or sampling other than the
    configuration's), "bad_coef": coefficients outside the trellis's
    candidates, "bad_scans": scans other than the search's (bad_scans),
    "bad_trellis": sampled blocks and rows other than the trellis's
    (bad_trellis), "coefs": coefficients checked}. seed draws the
    trellis's sample. The image has to be whole MCUs: the dummy blocks
    that pad an MCU are not the trellis's, and are not held here."""
    h, w = rgb.shape[:2]
    if h % (8 * v_samp) or w % (8 * h_samp):
        raise ValueError("the reference holds whole MCUs only")
    bad = {"bad_stream": 1, "bad_coef": 0, "bad_scans": 0,
           "bad_trellis": 0, "coefs": 0}
    try:
        fr = jpeg_read.parse(data)
        coefs = jpeg_read.coefficients(fr)
    except jpeg_read.JpegError:
        return bad
    if not _frame_ok(fr, w, h, quality, progressive, h_samp, v_samp):
        return bad
    qt = qtable(quality)
    n_bad = n = 0
    raws = []
    for pl, zz in zip(component_planes(rgb, h_samp, v_samp), coefs):
        raw = raw_coefficients(pl, qt, deringing)
        got = np.zeros_like(zz, dtype=np.int64)
        got[..., jpeg_read.ZIGZAG] = zz
        n_bad += outside_candidates(raw, got, qt)
        n += raw.size
        raws.append(raw)
    grids = [jpeg_read.real_grid(fr, ci) for ci in range(len(coefs))]
    return {"bad_stream": 0, "bad_coef": n_bad,
            "bad_scans": bad_scans(fr, coefs),
            "bad_trellis": bad_trellis(raws, coefs, grids, qt, v_samp,
                                       np.random.default_rng(seed),
                                       n_blocks, n_rows),
            "coefs": n}
