"""Plain reference of mozjpeg's trellis quantization (jcdctmgr.c
quantize_trellis) with the default settings: one pass, the AC band
[1, 63] and the DC trellis, no EOB optimisation, lambda weights 1/q^2.

The rate of an AC coefficient is the code length, in the optimal table
of the component's plainly rounded coefficients (an AC-first symbol
count over [1, 63] with every run/size pair counted once more), of its
run/size symbol, plus its bits, plus a ZRL code for every 16 zeros
before it; a block's end costs the EOB code. The rate of a DC is the
standard DC table's code of the difference to the DC before it in its
block row. The distortion is (8 q c - x)^2 lambda / q^2 for raw
coefficient x (the FDCT's output) and lambda = 2^14.75 / (2^16.5 +
norm / 63), norm the sum of the block's squared AC coefficients. Both
Viterbi searches run in float32 in the order mozjpeg adds, ties to the
first candidate, so the written coefficients must equal theirs exactly.
The DC rows of a block row pair chain (each row after the first of an
iMCU row starts from the last DC of the row above it).
"""
from __future__ import annotations

import numpy as np

from . import scan_ref

LOG_SCALE1 = 14.75
LOG_SCALE2 = 16.5
KMAX = 10
MAXQ = 1023
BIG = np.float32(1e38)
DC_CAND_MAX = 9
# Annex K.3 standard DC tables: code length of each category
STD_DC_BITS = {0: (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
               1: (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)}

f32 = np.float32


def std_dc_lengths(slot: int) -> np.ndarray:
    bits = np.zeros(17, np.int64)
    bits[1:] = STD_DC_BITS[slot]
    return scan_ref.code_table(bits, np.arange(12))[1]


def ac_lengths(plain_zz: np.ndarray) -> np.ndarray:
    """(n, 64) plainly rounded zigzag blocks in raster order -> the code
    length of each AC symbol in the trellis's rate table."""
    em = scan_ref.ac_first(plain_zz, 1, 63, 0, 0)
    f = np.bincount(em.sym[em.sym >= 0], minlength=256).astype(np.int64)
    for run in range(16):
        f[16 * run:16 * run + 12] += 1
    bits, vals = scan_ref.gen_optimal_table(f)
    return scan_ref.code_table(bits, vals)[1]


def rate_table(si: np.ndarray):
    """-> (rate[r, k] f32 for a run r in 0..62 before a coefficient of k+1
    bits, BIG where it has no code; the EOB length)."""
    r = np.arange(63)[:, None]
    k = np.arange(KMAX)[None, :]
    cl = si[16 * (r & 15) + k + 1]
    zrl = si[0xF0]
    ok = (cl > 0) & ((r < 16) | (zrl > 0))
    rate = (cl.astype(f32) + (k + 1).astype(f32)) + \
        (r >> 4).astype(f32) * f32(zrl)
    return np.where(ok, rate, BIG).astype(f32), f32(si[0])


def lambdas(raw_nat: np.ndarray) -> np.ndarray:
    """(n, 64) natural-order raw coefficients -> (n,) f32 lambda."""
    r = raw_nat.astype(f32)
    terms = r * r
    acc = np.zeros(len(r), f32)
    for i in range(1, 64):
        acc = acc + terms[:, i]
    norm = acc / f32(63.0)
    lam = 2.0 ** LOG_SCALE1 / (2.0 ** LOG_SCALE2 + norm.astype(np.float64))
    return lam.astype(f32)


def weights(q_zz: np.ndarray) -> np.ndarray:
    q = q_zz.astype(f32)
    return f32(1.0) / (q * q)


def trellis_ac(raw_zz: np.ndarray, q_zz: np.ndarray, lam: np.ndarray,
               rate: np.ndarray, eobl) -> np.ndarray:
    """raw_zz (n, 64) zigzag raw coefficients, q_zz (64,), lam (n,) ->
    (n, 63) the trellis's AC coefficients (zigzag 1..63)."""
    n = len(raw_zz)
    x = np.abs(raw_zz).astype(np.int64)
    q8 = (q_zz.astype(np.int64) << 3)
    ltbl = weights(q_zz)
    qval = np.minimum((x + (q8 >> 1)) // q8, MAXQ)
    zterm = ((x * x).astype(f32) * lam[:, None]) * ltbl[None, :]
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
    acc = np.full((n, 64), BIG, f32)
    acc[:, 0] = 0
    rs = np.zeros((n, 64), np.int64)
    bv = np.zeros((n, 64), np.int64)
    kv = np.arange(KMAX)
    rows = np.arange(n)
    for i in range(1, 64):
        qv, nci = qval[:, i], nc[:, i]
        cand = np.where(kv[None, :] == (nci - 1)[:, None], qv[:, None],
                        (2 << kv)[None, :] - 1)                  # (n, K)
        delta = cand * q8[i] - x[:, i:i + 1]
        cdist = ((delta * delta).astype(f32) * lam[:, None]) * ltbl[i]
        r = i - 1 - pos                                          # (64,)
        rt = np.where((r >= 0)[:, None], rate[np.clip(r, 0, 62)], BIG)
        tail = (azd[:, i - 1:i] - azd) + acc                    # (n, 64)
        cost = (rt[None] + cdist[:, None, :]) + tail[:, :, None]
        valid = ((jvalid & (pos < i)[None])[:, :, None]
                 & ((kv[None] < nci[:, None]) & (qv != 0)[:, None])[:, None]
                 & (rt < BIG)[None])
        cost = np.where(valid, cost, BIG)
        kidx = cost.argmin(2)                                    # (n, 64)
        bestc = np.take_along_axis(cost, kidx[..., None], 2)[..., 0]
        upd = bestc < BIG
        bestcand = np.where(upd, np.take_along_axis(cand, kidx, 1), 0)
        jidx = bestc.argmin(1)
        acc[:, i] = np.where(qv != 0, bestc[rows, jidx], BIG)
        rs[:, i] = jidx
        bv[:, i] = bestcand[rows, jidx]
    azd_se = azd[:, 63]
    end_wo = (acc + azd_se[:, None]) - azd
    end_cost = end_wo + np.where(pos < 63, eobl, f32(0))[None]
    end_cost = np.where(nonzero, end_cost, BIG)
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
                    si: np.ndarray, lam_dc: np.ndarray, nc: int
                    ) -> np.ndarray:
    """Independent block rows: raw_dc (R, L) raw DCs, last0 (R,) the DC
    each row starts from, lam_dc (R, L) f32 lambda / q0^2 -> (R, L) the
    trellis's DCs."""
    R, L = raw_dc.shape
    q8 = q0 * 8
    sign = np.where(raw_dc < 0, -1, 1)
    x = np.abs(raw_dc).astype(np.int64)
    qval = (x + q8 // 2) // q8
    ks = np.arange(nc)
    mag = np.clip(qval[..., None] - nc // 2 + ks, -MAXQ, MAXQ)
    delta = mag * q8 - x[..., None]
    dist = (delta * delta).astype(f32) * lam_dc[..., None]
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
        cost = step + acc[:, :, None]                  # (R, l_prev, k)
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


def num_dc_candidates(q0: int) -> int:
    return min(DC_CAND_MAX, (2 + 60 // q0) | 1)
