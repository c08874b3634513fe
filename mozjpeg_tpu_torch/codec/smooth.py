"""Progressive block smoothing (jdcoefct.c decompress_smooth_data).

A copy of mozjpeg_tpu/codec/smooth.py (numpy, host side): the port keeps
its own so that it imports nothing of the JAX package.

For partially-received progressive streams djpeg interpolates the
not-yet-received AC coefficients (and, in the DC-only case, re-estimates
DC and low ACs with a Gaussian-like kernel) from the 5x5 neighborhood of
block DC values (jdcoefct.c:429-760).  This module reproduces that math
bit-exactly on whole coefficient planes.

Geometry notes (all verified against the reference's sliding-register
logic, jdcoefct.c:572-600):
- columns clamp to [0, width_in_blocks-1];
- rows in non-final iMCU rows reach into the next two PADDED block rows
  (the virtual array's dummy rows, which hold real decoded dummy blocks
  for interleaved scans), while the final iMCU row clamps within itself
  using its own block_rows for the image_block_row arithmetic.
"""
from __future__ import annotations

import numpy as np

# zigzag index k (== cinfo->coef_bits index) -> natural (row, col) of the
# quantizer divisor (Q01_POS.. constants, jdcoefct.c:53-62)
_NAT_POS = [(0, 0), (0, 1), (1, 0), (2, 0), (1, 1),
            (0, 2), (0, 3), (1, 2), (2, 1), (3, 0)]


def smoothing_ok(jp, coef_bits_cur) -> bool:
    """jdcoefct.c:360-421 smoothing_ok: progressive, all ten quantizers
    nonzero per component, DC at least partly known, and some AC still
    inaccurate."""
    if not jp.progressive or coef_bits_cur is None:
        return False
    useful = False
    for ci, c in enumerate(jp.components):
        qt = jp.scan_qtables[0].get(c.quant_tbl, jp.qtables.get(c.quant_tbl))
        if qt is None:
            return False
        for (r, col) in _NAT_POS:
            if qt[r, col] == 0:
                return False
        if coef_bits_cur[ci][0] < 0:
            return False
        for k in range(1, 10):
            if coef_bits_cur[ci][k] != 0:
                useful = True
    return useful


def _neighbor_rows(bh: int, v: int, total_imcu: int):
    """Row indices (pp, p, nx, nn) per block row, following the
    image_block_row conditions of jdcoefct.c:545-570."""
    pp = np.zeros(bh, np.int64)
    p = np.zeros(bh, np.int64)
    nx = np.zeros(bh, np.int64)
    nn = np.zeros(bh, np.int64)
    last_start = v * (total_imcu - 1)
    lbr = bh - last_start                    # block rows in last iMCU row
    for r in range(bh):
        if r < last_start:
            ibr, ibrs = r, v * total_imcu    # middle iMCU rows
        else:
            br = r - last_start
            ibr = (total_imcu - 1) * lbr + br
            ibrs = lbr * total_imcu
        p[r] = r - 1 if ibr > 0 else r
        pp[r] = r - 2 if ibr > 1 else p[r]
        nx[r] = r + 1 if ibr < ibrs - 1 else r
        nn[r] = r + 2 if ibr < ibrs - 2 else nx[r]
    return pp, p, nx, nn


def _pred(num, q, Al):
    """workspace[k] estimate: symmetric truncating division by q<<8 with
    q<<7 rounding offset, magnitude-clamped to (1<<Al)-1 when Al>0."""
    mag = (np.int64(q) * 128 + np.abs(num)) // (np.int64(q) * 256)
    if Al > 0:
        mag = np.minimum(mag, (1 << Al) - 1)
    return np.where(num >= 0, mag, -mag)


def smooth_plane(plane: np.ndarray, bh: int, bw: int, v: int,
                 total_imcu: int, qtbl: np.ndarray,
                 coef_bits: np.ndarray) -> np.ndarray:
    """Apply decompress_smooth_data's coefficient estimation to the first
    bh x bw blocks of a padded zigzag plane; returns a smoothed copy of
    plane[:bh, :bw] (int32)."""
    out = plane[:bh, :bw].astype(np.int32).copy()
    coef_bits = np.asarray(coef_bits)
    change_dc = bool(np.all(coef_bits[1:10] == -1))

    # DC neighborhood: rows may reach padded rows (real dummy data);
    # columns clamp to the real width
    pp, p, nx, nn = _neighbor_rows(bh, v, total_imcu)
    need = int(max(nn.max(), bh - 1)) + 1
    dcfull = plane[:need, :bw, 0].astype(np.int64)
    cols = np.arange(bw)
    cl = np.clip(cols - 2, 0, bw - 1)
    c1 = np.clip(cols - 1, 0, bw - 1)
    cr = np.clip(cols + 1, 0, bw - 1)
    crr = np.clip(cols + 2, 0, bw - 1)
    rows = {0: dcfull[pp], 1: dcfull[p],
            2: dcfull[np.arange(bh)], 3: dcfull[nx], 4: dcfull[nn]}
    # DC01..DC25 in reading order (row-2..row+2) x (col-2..col+2)
    D = {}
    for ri in range(5):
        base = rows[ri]
        D[ri * 5 + 1] = base[:, cl]
        D[ri * 5 + 2] = base[:, c1]
        D[ri * 5 + 3] = base
        D[ri * 5 + 4] = base[:, cr]
        D[ri * 5 + 5] = base[:, crr]

    q00 = np.int64(qtbl[0, 0])
    if change_dc:
        kernels = {
            1: (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7]
                - 13 * D[9] + 3 * D[10] - 3 * D[11] + 38 * D[12]
                - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17]
                - 13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]),
            2: (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6]
                + 13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16]
                - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21]
                + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]),
            3: (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12]
                - 14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18]
                + 2 * D[19] + D[23]),
            4: (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17]
                + 9 * D[19] + D[21] - D[25]),
            5: (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12]
                - 14 * D[13] + 7 * D[14] + D[15] + 2 * D[17]
                - 5 * D[18] + 2 * D[19]),
            6: (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]),
            7: (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]),
            8: (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]),
            9: (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]),
        }
        ks = range(1, 10)
    else:
        kernels = {
            1: (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]),
            2: (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]),
            3: (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]),
            4: (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20]
                + D[22] - D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9]),
            5: (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]),
        }
        ks = range(1, 6)

    for k in ks:
        Al = int(coef_bits[k])
        if Al == 0:
            continue                         # fully known: no estimate
        q = int(qtbl[_NAT_POS[k]])
        pred = _pred(q00 * kernels[k], q, Al).astype(np.int32)
        mask = out[:, :, k] == 0
        out[:, :, k] = np.where(mask, pred, out[:, :, k])

    if change_dc:
        num = q00 * (
            -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5]
            - 6 * D[6] + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10]
            - 8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14]
            - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19]
            - 6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24]
            - 2 * D[25])
        out[:, :, 0] = _pred(num, int(q00), 0).astype(np.int32)
    return out


def smooth_component(plane: np.ndarray, bh: int, bw: int, v: int,
                     total_imcu: int, qtbl: np.ndarray,
                     cur_latch: np.ndarray, prev_latch: np.ndarray,
                     last_good_imcu: int) -> np.ndarray:
    """Rows at or before last_good_iMCU_row use the current scan's
    coef_bits latch; rows beyond use the previous scan's
    (jdcoefct.c:514-519)."""
    split = min((last_good_imcu + 1) * v, bh)
    a = smooth_plane(plane, bh, bw, v, total_imcu, qtbl, cur_latch)
    if split >= bh:
        return a
    b = smooth_plane(plane, bh, bw, v, total_imcu, qtbl, prev_latch)
    a[split:] = b[split:]
    return a
