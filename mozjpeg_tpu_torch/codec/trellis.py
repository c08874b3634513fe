"""Trellis quantization program: lambdas, rate tables, AC and DC trellis,
and the EOB-run DP.

Port of the mozjpeg_tpu/codec/trellis.py pieces of the batched encode
path (the make_trellis_all_t program with the AC kernel and host-built
rate tables, i.e. use_pallas=True and dev_first=None, and the
make_band_hist_t statistics): mozjpeg's rate-distortion Viterbi
(jcdctmgr.c:936-1330 quantize_trellis).

  - lambda_from_norm_t: per-block lambda from the p1 norm sums, the host
    chain of trellis.lambda_from_norm in float64 torch on the device;
  - trellis_tables_from_hist: per-image AC code lengths from an AC-first
    histogram (native Annex-K tablegen), or the standard table's when
    Huffman optimization is off, and the standard DC lengths;
  - band_hists: per-image AC-first histograms of the current coefficients
    over one band, for the statistics passes that precede each trellis
    pass after the first (trellis_num_loops > 1, use_scans_in_trellis);
  - rate_lut: the run-indexed (B, 128, 16) rate table of the AC kernel;
  - eob_block_dp, trellis_dc_rows: the plain EOB-run DP and DC DP over
    block rows (ops/trellis_rows.py, named here as before);
  - trellis_all: every component's AC band trellis (ops/trellis_ac.py),
    and its EOB-run DP and DC trellis (ops/trellis_rows.py: one launch a
    component and band, one a component, on the card).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..entropy import encode as entenc
from ..entropy.huffman import derive_codes
from ..ops import trellis_ac as _ac
from ..ops import trellis_rows as _rows
from ..ops.symbols import ac_first_histograms_t, nbits
from ..ops.trellis_rows import DC_CAND_MAX
from ..ops.trellis_rows import eob_block_dp, trellis_dc_rows  # noqa: F401
from .stages import stage


def kmax_maxq(precision: int):
    """(kmax, maxq) of the trellis at a data precision: the largest
    quantized magnitude 2^(precision+2) - 1 and its bit length (10, 1023
    at 8 bits; 14, 16383 at 12), as make_trellis_all_t derives them."""
    return precision + 2, (1 << (precision + 2)) - 1


@functools.lru_cache(maxsize=1)
def recip2_table() -> np.ndarray:
    """IEEE f32 1/(q*q) for q in [0, 32767] (host numpy division), the
    table the JAX package reads instead of dividing on a device."""
    q = np.arange(32768, dtype=np.float32)
    with np.errstate(divide="ignore"):
        return np.float32(1.0) / (q * q)


def lambda_from_norm_t(norm_sum: torch.Tensor, s1: float, s2: float
                       ) -> torch.Tensor:
    """Per-block lambda from the sequential f32 norm sums (N,) f32:
    f32 norm/63, then 2^s1 / (2^s2 + norm) in float64, rounded to f32.
    Both divisions are tensor-by-tensor (IEEE on every device; PyTorch
    turns a division by a Python scalar into a reciprocal product)."""
    norm = torch.div(norm_sum, torch.full_like(norm_sum, 63.0))
    if s2 > 0:
        num = torch.full_like(norm, 2.0 ** s1, dtype=torch.float64)
        lam = torch.div(num, (2.0 ** s2) + norm.to(torch.float64))
    else:
        lam = torch.full_like(norm, 2.0 ** (s1 - 12.0), dtype=torch.float64)
    return lam.to(torch.float32)


def trellis_tables_from_hist(achist, tbl_slot: int,
                             optimize_coding: bool = True):
    """Rate tables for a trellis pass: (ac_si, dc_si) int32 code lengths.
    With optimize_coding the AC table is the optimal one for the AC-first
    histogram (every run/size pair counted once more, so that each has a
    code), else the standard table of the slot; DC is always standard."""
    from .encoder import STD_TABLES
    if optimize_coding:
        f = np.zeros(257, np.int64)
        f[:256] = np.asarray(achist).astype(np.int64)
        for run in range(16):
            for size in range(12):
                f[16 * run + size] += 1
        ac_tbl = entenc.gen_optimal_table(f)
    else:
        ac_tbl = STD_TABLES[(1, tbl_slot)]
    _, ac_si = derive_codes(ac_tbl)
    _, dc_si = derive_codes(STD_TABLES[(0, tbl_slot)])
    return ac_si.astype(np.int32), dc_si.astype(np.int32)


def band_hists(qs, ss: int, se: int, batch: int, ris=None):
    """Per component (64, B*n) coefficients -> (B, 256) int32 AC-first
    histograms over [ss, se], each image on its own, with the
    components' restart intervals ris (make_band_hist_t)."""
    return [ac_first_histograms_t(q, batch, ris[ci] if ris else 0, ss, se)
            for ci, q in enumerate(qs)]


def get_num_dc_candidates(q0: int) -> int:
    return min(DC_CAND_MAX, (2 + 60 // q0) | 1)


def rate_lut(ac_si: torch.Tensor, kmax: int = _ac.KMAX) -> torch.Tensor:
    """ac_si (B, 256) int32 -> (B, 128, 16) f32 with [b, 63-run, k] =
    ehufsi[16*(run&15) + k+1] + (k+1) + (run>>4)*zrl_len, BIG where
    invalid (code length 0, run >= 16 without a ZRL code, row >= 64 i.e.
    run < 0, k >= kmax), and the EOB code length at [b, 127, 0]."""
    dev = ac_si.device
    f = ac_si.to(torch.float32)
    tt = torch.arange(128, device=dev)[:, None]
    kk = torch.arange(_ac.RR_K, device=dev)[None, :]
    r = 63 - tt
    rpos = r.clamp_min(0)
    sym = (16 * (rpos & 15) + kk + 1).clamp_max(255)   # k >= kmax: masked
    cl = f[:, sym]                                     # (B, 128, 16)
    zrl = f[:, 0xF0][:, None, None]
    rb = (rpos >> 4).to(torch.float32)[None] * zrl
    ok = (((r >= 0) & (kk < kmax))[None] & (cl > 0)
          & ((r < 16)[None] | (zrl > 0)))
    lut = torch.where(ok, (cl + (kk + 1).to(torch.float32)[None]) + rb,
                      torch.tensor(_ac.BIGF, dtype=torch.float32,
                                   device=dev))
    lut[:, 127, 0] = f[:, 0]
    return lut.contiguous()


def ac_example_inputs(kind: str, b: int, n_img: int, seed: int = 0,
                      precision: int = 8):
    """Seeded arguments of the AC trellis for B=b images of n_img blocks,
    as numpy arrays (raw (64, N) int32, qtbl (64,) int32, ltbl (64,) f32,
    rate_luts (b, 128, 16) f32, lam (N,) f32), for tests and the smoke run.
    tie: q = 1, raw on multiples of 8 and lambda 1/64, so that every
    distortion and cost is an integer and ties between predecessors and
    bit lengths are common; sparse: nine in ten AC coefficients quantize
    to zero; dense: every AC coefficient nonzero, qval spread up to maxq
    (and past it, clamped); zero: all raw zero; no_codes: sparse blocks
    with every rate and the EOB length BIG, so that no step beats BIG and
    every end cost is BIG or more. At precision 12 the values scale with
    maxq (16383 against 1023), so that dense and sparse raw values pass
    46,341, whose square wraps int32, and the rate LUT has kmax 14."""
    rng = np.random.default_rng(seed)
    n = b * n_img
    kmax, maxq = kmax_maxq(precision)
    wide = (maxq + 1) // 1024             # 1 at 8 bits, 16 at 12
    lam = (rng.random(n) * 4 + 0.01).astype(np.float32)
    qtbl = rng.integers(1, 60, 64).astype(np.int32)
    if kind == "tie":
        qtbl = np.ones(64, np.int32)
        raw = rng.integers(-20, 21, (64, n)) * 8
        raw[rng.random(raw.shape) < 0.7] = 0
        if wide > 1:
            # a tenth of the values reach bit lengths up to kmax
            raw[rng.random(raw.shape) < 0.1] *= maxq // 20
        lam = np.full(n, 1 / 64, np.float32)
    elif kind == "dense":
        qtbl = rng.integers(1, 5, 64).astype(np.int32)
        q8 = (qtbl << 3)[:, None]
        qval = rng.integers(1, maxq + 77 * wide, (64, n))
        raw = qval * q8 + rng.integers(-(q8 >> 1), q8 >> 1, (64, n))
        raw[0] = rng.integers(-2000 * wide, 2000 * wide, n)
    elif kind == "zero":
        raw = np.zeros((64, n), np.int64)
    else:
        raw = rng.integers(-3000 * wide, 3000 * wide, (64, n))
        raw[rng.random(raw.shape) < 0.9] = 0
    raw = (raw * rng.choice([-1, 1], (64, n))).astype(np.int32)
    si = rng.integers(2, 17, (b, 256)).astype(np.int32)
    si[:, 0] = rng.integers(2, 10, b)
    si[b - 1, 0xF0] = 0                   # one image without a ZRL code
    luts = rate_lut(torch.as_tensor(si), kmax).numpy()
    if kind == "no_codes":
        luts = np.full_like(luts, _ac.BIGF)
    return raw, qtbl, recip2_table()[qtbl], luts, lam


def trellis_all(geoms, raws, qs, lams, ac_sis, dc_sis, qtbl_zzs, ncands,
                batch: int, bands=((1, 63),), dc_on: bool = True,
                eob_opt: bool = False, delta_w: float = 0.0, times=None,
                record=None, precision: int = 8):
    """Trellis every component of a batch of same-shape images: the AC
    trellis of each band in `bands` (with the EOB-run DP when eob_opt),
    then, with dc_on, the DC trellis, at the (kmax, maxq) of the
    precision (kmax_maxq).

    raws/qs: per component (64, B*n) int32 / int16 image-major planes;
    lams: per component (B*n,) f32; ac_sis: per component (B, 256) int32
    tensors; dc_sis: per component (256,) int32; qtbl_zzs: per component
    (64,) int32 numpy zigzag quant tables. Returns the final (64, B*n)
    int16 planes. `times` (dict) accumulates synchronised stage seconds
    (trellis_ac, trellis_eob, trellis_dc). With `record` (dict),
    record["trellis_ac"], record["trellis_eob"] and record["trellis_dc"]
    get the arguments of each call of the three kernels' wrappers
    (ops/trellis_ac.trellis_ac, ops/trellis_rows.eob_dp and trellis_dc),
    which launch one kernel each on the card."""
    dev = raws[0].device
    recip = recip2_table()
    pos = torch.arange(64, device=dev)[:, None]
    outs = []
    kmax, maxq = kmax_maxq(precision)
    with stage(times, "trellis_ac", dev):
        luts_all = rate_lut(torch.cat(list(ac_sis), 0), kmax)
    for ci, g in enumerate(geoms):
        qz = np.asarray(qtbl_zzs[ci], np.int32)
        new_q = qs[ci]
        for ss, se in bands:
            with stage(times, "trellis_ac", dev):
                args = (raws[ci], torch.as_tensor(qz, device=dev),
                        torch.as_tensor(recip[qz], device=dev),
                        luts_all[ci * batch:(ci + 1) * batch], lams[ci], ss,
                        se, g.bh * g.bw, kmax, maxq)
                if record is not None:
                    record.setdefault("trellis_ac", []).append(args)
                new_band, ei = _ac.trellis_ac(*args)
                in_band = (pos >= ss) & (pos <= se)
                new_q = torch.where(in_band, new_band.to(torch.int16), new_q)
            if eob_opt:
                with stage(times, "trellis_eob", dev):
                    eargs = (ei, ac_sis[ci], g.bh, g.bw)
                    if record is not None:
                        record.setdefault("trellis_eob", []).append(eargs)
                    keep = _rows.eob_dp(*eargs)
                    new_q = torch.where(in_band & ~keep.reshape(1, -1),
                                        torch.zeros_like(new_q), new_q)
        outs.append(new_q)
    if not dc_on:
        return tuple(outs)
    with stage(times, "trellis_dc", dev):
        for ci, g in enumerate(geoms):
            q0 = int(qtbl_zzs[ci][0])
            dargs = (raws[ci][0].reshape(batch, g.bh, g.bw),
                     lams[ci].reshape(batch, g.bh, g.bw), q0,
                     float(recip[q0]), dc_sis[ci], ncands[ci], g.v, delta_w,
                     maxq)
            if record is not None:
                record.setdefault("trellis_dc", []).append(dargs)
            dc = _rows.trellis_dc(*dargs)
            new_q = outs[ci].clone()
            new_q[0] = dc.reshape(-1).to(torch.int16)
            outs[ci] = new_q
    return tuple(outs)


# ---------------------------------------------------------------------------
# The arithmetic-coding trellis (quantize_trellis_arith,
# jcdctmgr.c:1333-1667): one block row at a time with the rates of the
# adaptive coder's current states, which the host trains on each row's
# choices before it snapshots the next row's rates (encoder.py).
# Candidates are {qval, qval - 1} with no clamp; the AC rate is truncated
# to an integer (`int rate;`) before the distortion is added.
#
# Everything that depends on the rates alone (the run and EOB rates, the
# per-position rate ladders) is tabled on the host in f32 numpy, and
# every per-block term that does not depend on the DP (each candidate's
# coded bits, distortion and rate, the zero-distortion tails) is computed
# for all positions at once; the DP itself then takes a few launches per
# position. Each element still sees the reference's f32 operations in
# its order: sums in a fixed order, every product rounded (no FMA
# contraction in eager PyTorch), the zero-distortion prefix serial.
# ---------------------------------------------------------------------------

ARITH_MAXNB_AC = 14
ARITH_MAXNB_DC = 15


def _frnd(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's rounding barrier min(x, 3e38): the identity on
    finite costs, and it maps +inf to 3e38."""
    return torch.clamp_max(x, 3.0e38)


@functools.lru_cache(maxsize=4)
def _recip2_dev(device: str) -> torch.Tensor:
    return torch.as_tensor(recip2_table(), device=device)


def _arith_ac_tables(r: np.ndarray, ss: int, se: int, ac_k: int):
    """The rate-only terms of the AC trellis from ac_rates (256, 2), for
    positions i in [ss, se] (s = i - ss): run_bits (S, 64), the run rate
    of predecessor j at step i (the serial f32 recurrence of the JAX
    package's `A`); the coef_bits ladders a1 (S,), ladder (S, 12) and the
    final-decision tables zf, m0, m1 (S, 15); r_eob (64,), the EOB rate
    at each end position."""
    f32 = np.float32
    pos = np.arange(ss, se + 1)
    j = np.arange(64)
    r_eob_j = r[3 * np.minimum(j, 63), 0]
    A = np.zeros(64, f32)
    run_bits = np.empty((len(pos), 64), f32)
    for s, i in enumerate(pos):
        A = np.where(j == i - 1, r_eob_j, A + r[3 * max(i - 2, 0) + 1, 0])
        run_bits[s] = A + r[3 * (i - 1) + 1, 1]
    st0 = 3 * (pos - 1) + 2
    stl = np.where(pos <= ac_k, 189, 217)
    ladder = r[stl[:, None] + np.arange(ARITH_MAXNB_AC - 2)[None], 1]
    nbv = np.arange(ARITH_MAXNB_AC + 1)[None]
    hi = stl[:, None] + nbv - 2
    zf = np.where(nbv <= 1, r[st0, 0][:, None], r[np.minimum(hi, 255), 0])
    m_state = np.where(nbv <= 1, st0[:, None] + 14,
                       np.minimum(hi, 241) + 14)
    eob = r[3 * np.clip(j - 1, 0, 63), 1]
    return (run_bits, r[st0, 1].astype(f32), ladder.astype(f32),
            zf.astype(f32), r[m_state, 0].astype(f32),
            r[m_state, 1].astype(f32), eob.astype(f32))


def _gather_nb(tab: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """tab (S, 15)[s, nb[s, ...]] for nb (S, C, N)."""
    s, c, n = nb.shape
    return torch.gather(tab[:, None, :].expand(s, c, tab.shape[1]), 2,
                        nb.to(torch.int64))


def arith_ac_row(raw, qcoef, qtbl_zz, lam, ac_rates, ss: int, se: int,
                 ac_k: int = 5) -> torch.Tensor:
    """The AC trellis of band [ss, se] over N blocks sharing one rate
    snapshot (the JAX package's _arith_ac_row).

    raw (64, N) int32 unquantized coefficients (x8), qcoef (64, N) int16
    current ones, qtbl_zz (64,) int32 zigzag quant table, lam (N,) f32,
    ac_rates (256, 2) f32 numpy (the coder's, on the host) -> (64, N)
    int16, the band replaced by the trellis's choice. Ties go to the first
    minimum in the reference's (j, candidate) order
    (jcdctmgr.c:1552-1599)."""
    dev = raw.device
    n = raw.shape[1]
    f32 = torch.float32
    big = torch.tensor(float(np.float32(1e38)), dtype=f32, device=dev)
    (run_bits, a1, ladder, zf, m0, m1, eob) = (
        torch.as_tensor(t, device=dev) for t in
        _arith_ac_tables(ac_rates, ss, se, ac_k))
    S = se - ss + 1
    pos = torch.arange(64, device=dev)[:, None]
    in_band = (pos >= ss) & (pos <= se)
    x = raw.abs()
    sign = torch.where(raw < 0, -1, 1).to(torch.int32)
    q8_v = qtbl_zz.to(torch.int32) << 3
    q8 = q8_v[:, None]
    qval = (x + (q8 >> 1)) // q8                       # no clamp (arith)
    ltbl = _recip2_dev(str(dev))[qtbl_zz.to(torch.int64)]
    zdist = _frnd(_frnd((x * x).to(f32) * lam[None, :]) * ltbl[:, None])
    zterm = torch.where(in_band, zdist, torch.zeros((), dtype=f32,
                                                    device=dev))
    # serial f32 prefix; positions outside the band add exact zeros
    azd = torch.zeros((64, n), dtype=f32, device=dev)
    c = azd[0]
    for i in range(ss, se + 1):
        c = c + zterm[i]
        azd[i] = c
    azd[se + 1:] = c
    azd_prev = torch.cat([torch.zeros((1, n), dtype=f32, device=dev),
                          azd[:-1]], 0)

    # each candidate's terms at every in-band position: (S, 2, N)
    qv = qval[ss:se + 1]
    cand = torch.stack([qv, qv - 1], 1)
    okc = torch.stack([qv != 0, qv > 1], 1)
    v = cand.clamp_min(1)
    vd = v - 1
    nb = nbits(vd)
    cb = torch.ones(v.shape, dtype=f32, device=dev)        # the sign bit
    zero = torch.zeros((), dtype=f32, device=dev)
    a1v = a1[:, None, None]
    cb = cb + torch.where(vd >= 1, a1v, zero)
    cb = cb + torch.where(vd >= 2, a1v, zero)
    for k in range(3, ARITH_MAXNB_AC + 1):
        cb = cb + torch.where(nb >= k, ladder[:, k - 3, None, None], zero)
    cb = cb + _gather_nb(zf, nb)
    m0v, m1v = _gather_nb(m0, nb), _gather_nb(m1, nb)
    for p in range(ARITH_MAXNB_AC - 2, -1, -1):
        bit = (vd >> p) & 1
        cb = cb + torch.where(p <= nb - 2, torch.where(bit == 1, m1v, m0v),
                              zero)
    delta = cand * q8_v[ss:se + 1, None, None] - x[ss:se + 1, None, :]
    cdist = _frnd(_frnd((delta * delta).to(f32) * lam)
                  * ltbl[ss:se + 1, None, None])
    # (S, 64, 2, N): (int rate + distortion), and which (j, cand) are
    # allowed; (S, 64, N): the zero-distortion tail before acc[j]
    rate = (cb[:, None] + run_bits[:, :, None, None]).to(torch.int32) \
        .to(f32)
    rc = rate + cdist[:, None]
    j_idx = torch.arange(64, device=dev)
    j_nonzero = (qval != 0) & in_band
    j_valid = (j_idx == ss - 1)[:, None] | j_nonzero
    ii = torch.arange(ss, se + 1, device=dev)
    valid = ((j_valid[None] & (j_idx[None, :] < ii[:, None])[..., None])
             [:, :, None, :] & okc[:, None])
    tails = azd_prev[ss:se + 1, None, :] - azd[None]

    acc = torch.where((j_idx == ss - 1)[:, None], zero, big) \
        .expand(64, n).contiguous()
    args = torch.empty((S, n), dtype=torch.int64, device=dev)
    for s in range(S):
        cost = rc[s] + (tails[s] + acc)[:, None]
        cost = torch.where(valid[s], cost, big).reshape(128, n)
        best, args[s] = torch.min(cost, 0)
        torch.where(qv[s] != 0, best, big, out=acc[ss + s])
    run_start = torch.zeros((64, n), dtype=torch.int64, device=dev)
    run_start[ss:se + 1] = args // 2
    best_val = torch.zeros((64, n), dtype=torch.int32, device=dev)
    best_val[ss:se + 1] = torch.where(args % 2 == 0, qv, qv - 1)

    azd_se = azd[se]
    end_cost = ((acc + azd_se[None]) - azd) \
        + torch.where(pos < se, eob[:, None], zero)
    end_cost = torch.where(j_nonzero, end_cost, big)
    end_cost[ss - 1] = azd_se + float(ac_rates[0, 1])
    last = torch.argmin(end_cost, 0)

    # the walk back from `last`, by pointer doubling: reach[j] is the
    # mask of the in-band positions on the path from j down to the band
    # start (bit j - 1 for position j >= ss >= 1), jump[j] the position
    # 2^k steps down; six doublings cover a path of 64
    jb = j_idx[:, None].expand(64, n)
    sh = (jb - 1).clamp_min(0)
    one = torch.ones((), dtype=torch.int64, device=dev)
    reach = torch.where(jb >= ss, one << sh, 0 * one)
    jump = torch.where(jb >= ss, run_start, jb)
    for _ in range(6):
        reach = reach | torch.gather(reach, 0, jump)
        jump = torch.gather(jump, 0, jump)
    path = torch.gather(reach, 0, last[None])[0]
    keep = (((path[None] >> sh) & 1) == 1) & j_nonzero
    new_band = torch.where(keep, best_val * sign, 0).to(torch.int16)
    return torch.where(in_band, new_band, qcoef)


def _arith_dc_bits(d, st0, r):
    """Coded bits of DC difference d from context state st0, and the new
    context (dc_L = 0, dc_U = 1), as the JAX package's dc_bits_ctx; r is
    the (64, 2) rate table tensor."""
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    nz = d != 0
    neg = d < 0
    vd = (d.abs() - 1).clamp_min(0)
    nb = nbits(vd)
    bits = torch.where(nz, r[st0, 1], r[st0, 0])
    bits = bits + torch.where(nz, torch.where(neg, r[st0 + 1, 1],
                                              r[st0 + 1, 0]), zero)
    st1 = st0 + 2 + neg.to(torch.int64)
    bits = bits + torch.where(nz & (vd >= 1), r[st1, 1], zero)
    for k in range(2, ARITH_MAXNB_DC + 1):
        bits = bits + torch.where(nz & (nb >= k), r[20 + k - 2, 1], zero)
    stf = torch.where(vd == 0, st1,
                      torch.where(nb == 1, 20, 20 + nb - 1).to(torch.int64))
    bits = bits + torch.where(nz, r[stf, 0], zero)
    m0, m1 = r[stf + 14, 0], r[stf + 14, 1]
    for p in range(ARITH_MAXNB_DC - 2, -1, -1):
        bit = (vd >> p) & 1
        bits = bits + torch.where(nz & (p <= nb - 2),
                                  torch.where(bit == 1, m1, m0), zero)
    ctx = torch.where(nz, torch.where(neg, 8, 4) + torch.where(nb >= 2, 8, 0),
                      0)
    return bits, ctx


def arith_dc_rows(raw_dc, last_dc0, q0: int, dc_rates, nc: int, lam_dc):
    """The DC trellis of R independent block rows in lockstep, with
    adaptive rates and per-candidate context tracking
    (quantize_trellis_arith's DC section). raw_dc (R, L) int32, last_dc0
    (R,) int32 each row's starting predictor, dc_rates (64, 2) f32 numpy
    (the coder's, on the host), lam_dc (R, L) f32 -> (R, L) int32 chosen
    DC (the JAX package's _arith_dc_row, row by row). The context a
    predecessor leaves is one of 0, 4, 8, 12 and 16, so every step's bits
    are computed for the five contexts at once and the DP gathers the one
    of each predecessor's; ties go to the first minimum."""
    dev = raw_dc.device
    R, L = raw_dc.shape
    r = torch.as_tensor(dc_rates, device=dev)
    q8 = int(q0) * 8
    sign = torch.where(raw_dc < 0, -1, 1).to(torch.int32)
    x = raw_dc.abs()
    qval = (x + q8 // 2) // q8
    ks = torch.arange(nc, dtype=torch.int32, device=dev)
    cand_mag = qval[..., None] - nc // 2 + ks              # no clamp
    delta_q = cand_mag * q8 - x[..., None]
    dist = _frnd((delta_q * delta_q).to(torch.float32) * lam_dc[..., None])
    cand = cand_mag * sign[..., None]                      # (R, L, nc)

    bits0, ctx0 = _arith_dc_bits(cand[:, 0] - last_dc0[:, None],
                                 torch.zeros((), dtype=torch.int64,
                                             device=dev), r)
    acc = bits0 + dist[:, 0]
    cidx = ctx0 // 4
    bts = torch.zeros((R, L, nc), dtype=torch.int64, device=dev)
    if L > 1:
        # bd[t-1, r, l, c, k]: bits of predecessor l -> candidate k from
        # context 4c, plus k's distortion; nctx the context it leaves
        d = cand[:, 1:, None, :] - cand[:, :-1, :, None]   # (R, L-1, l, k)
        st = torch.arange(0, 20, 4, device=dev).reshape(5, 1, 1, 1, 1)
        bits, nctx = _arith_dc_bits(d[None], st, r)
        bd = (bits + dist[None, :, 1:, None, :]).permute(2, 1, 3, 0, 4) \
            .contiguous()
        nctx = (nctx[0] // 4).permute(1, 0, 2, 3).contiguous()
        sel = (R, nc, 1, nc)
        for t in range(1, L):
            cost = torch.gather(bd[t - 1], 2, cidx[:, :, None, None]
                                .expand(sel))[:, :, 0] + acc[:, :, None]
            acc, bt = torch.min(cost, 1)
            bts[:, t] = bt
            cidx = torch.gather(nctx[t - 1], 1, bt[:, None])[:, 0]
    best = torch.argmin(acc, 1)
    # the walk back: cur_t = bts[t+1] o ... o bts[L-1] (best), the suffix
    # compositions by doubling (maps of the nc candidates)
    g = torch.empty((R, L, nc), dtype=torch.int64, device=dev)
    g[:, :-1] = bts[:, 1:]
    g[:, -1] = torch.arange(nc, device=dev)
    k = 1
    while k < L:
        g[:, :L - k] = torch.gather(g[:, :L - k], 2, g[:, k:])
        k *= 2
    cur = torch.gather(g, 2, best[:, None, None].expand(R, L, 1))
    return torch.gather(cand, 2, cur)[..., 0]


def arith_dc_imcu_row(raw_dc, q0: int, dc_rates, nc: int, lam_dc):
    """The DC trellis of the v block rows of one iMCU row, whose last DC
    chains from row to row and starts at 0: raw_dc and lam_dc (v, L) ->
    (v, L) int32. Rows go in pairs: the second row of a pair runs beside
    the first once for each of the first row's nc final candidates, and
    the first row's choice picks it afterwards, so that a pair takes one
    pass of L steps and nothing leaves the device."""
    dev = raw_dc.device
    v, L = raw_dc.shape
    last = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = []
    for k in range(0, v, 2):
        if k + 1 == v:
            outs.append(arith_dc_rows(raw_dc[k:k + 1], last, q0, dc_rates,
                                      nc, lam_dc[k:k + 1]))
            break
        # the first row's final candidates: its last block's magnitudes
        # base .. base + nc - 1 with the block's sign
        q8 = int(q0) * 8
        xl = raw_dc[k, L - 1:L]
        sgn = torch.where(xl < 0, -1, 1).to(torch.int32)
        base = (xl.abs() + q8 // 2) // q8 - nc // 2
        hyp = (base + torch.arange(nc, dtype=torch.int32, device=dev)) * sgn
        rows = torch.cat([raw_dc[k:k + 1],
                          raw_dc[k + 1:k + 2].expand(nc, L)])
        lams = torch.cat([lam_dc[k:k + 1],
                          lam_dc[k + 1:k + 2].expand(nc, L)])
        res = arith_dc_rows(rows, torch.cat([last, hyp]), q0, dc_rates, nc,
                            lams)
        pick = (res[0, L - 1:L] * sgn - base).to(torch.int64)
        second = torch.index_select(res[1:], 0, pick)
        outs += [res[:1], second]
        last = second[:, L - 1]
    return torch.cat(outs)


def arith_trellis_comps(ncomps: int, loops: int, bands: bool):
    """The (component, band) pairs the reference's arithmetic trellis
    passes quantize: arithmetic forces optimize_coding off
    (jcmaster.c:1088), and the pass bookkeeping that follows only ever
    selects component 0 and, with use_scans_in_trellis, its first band;
    the other components stay round-to-nearest. Repeat passes over the
    same component are fixed points, so one visit suffices."""
    del ncomps, loops, bands
    return [(0, 0)]
