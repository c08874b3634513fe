"""Symbol statistics of whole coefficient planes.

Port of mozjpeg_tpu/ops/symbols.py:
  - ac_first_histogram_t and _ac_first_hist_seg: the exact phuff
    AC-first gather counts of mozjpeg jcphuff.c encode_mcu_AC_first in
    coefficient-major layout, including the cross-block EOB runs, the
    0x7FFF forced flush and the flush at restart boundaries (its
    within-block and cross-block halves, within_block_hist and
    eob_run_hist, are also ops/p1.py's plain versions of the p1
    kernels);
  - ac_histogram, dc_histogram_interleaved and dc_histogram_restart: the
    sequential scan's dc_counts / ac_counts of the reference's gather
    pass (jchuff.c:886-944) in block-major layout, which the sharded
    encoders (parallel/) sum over their shards.
All as whole-tensor ops; every count is an exact integer bincount, and a
batch axis computes one histogram per image (or sums the images') at
once. The AC-first counts at a point transform Al and the AC-refinement
counts are ops/bitpack.py's AcFirst.hist and AcRefine.hist.
"""
from __future__ import annotations

import torch


def nbits(v: torch.Tensor) -> torch.Tensor:
    """JPEG_NBITS of a non-negative integer tensor (0 -> 0), exact for
    v < 2**24: the binary exponent of float(v)."""
    return torch.frexp(v.to(torch.float32)).exponent.to(torch.int32)


def _bincount_rows(sym, mask, nrows: int) -> torch.Tensor:
    """Per-row 256-bin counts of sym (R, ...) where mask -> (R, 256)."""
    row = torch.arange(nrows, device=sym.device).reshape(
        (nrows,) + (1,) * (sym.dim() - 1))
    flat = (row * 256 + sym.to(torch.int64))[mask]
    return torch.bincount(flat, minlength=256 * nrows).reshape(nrows, 256)


def within_block_hist(band: torch.Tensor) -> torch.Tensor:
    """band (L, B, N) coefficients of B segments in one band -> (B, 256)
    int64 counts of the within-block (run, size) symbols: per nonzero
    coefficient ((run & 15) << 4) | nbits, and (run >> 4) ZRLs."""
    band = band.to(torch.int32)
    L, B, N = band.shape
    nz = band != 0
    pos = torch.arange(L, device=band.device)[:, None, None]
    idx = torch.where(nz, pos + 1, 0)
    prev_incl = idx.cummax(0).values
    prev_excl = torch.cat([torch.zeros_like(prev_incl[:1]),
                           prev_incl[:-1]], 0)
    run = pos - prev_excl
    sym = ((run & 15) << 4) | nbits(band.abs())
    hist = _bincount_rows(sym.permute(1, 0, 2), nz.permute(1, 0, 2), B)
    hist[:, 0xF0] += torch.where(nz, run >> 4, 0).sum((0, 2))
    return hist


def eob_run_hist(has_nz: torch.Tensor, trailing: torch.Tensor
                 ) -> torch.Tensor:
    """The EOB runs across blocks of B segments of N blocks: has_nz (B,
    N) bool, a block holds a nonzero in the band; trailing (B, N) bool,
    its last band coefficient is zero -> (B, 256) int64 counts. A run
    starts at a block with trailing zeros, extends over the following
    all-zero blocks and is emitted before the next block holding a
    nonzero (or at the segment's end)."""
    B, N = has_nz.shape
    dev = has_nz.device
    bpos = torch.arange(N, device=dev)[None, :]
    prev_nzb_incl = torch.where(has_nz, bpos, -1).cummax(1).values
    prev_nzb = torch.cat([torch.full((B, 1), -1, device=dev,
                                     dtype=prev_nzb_incl.dtype),
                          prev_nzb_incl[:, :-1]], 1)
    gap = bpos - prev_nzb - 1
    prev_trail = (prev_nzb >= 0) & torch.gather(trailing, 1,
                                                prev_nzb.clamp_min(0))
    run_at = gap + prev_trail.to(gap.dtype)
    emit_here = has_nz & (run_at > 0)

    last_nzb = prev_nzb_incl[:, -1:]
    last_trail = (last_nzb >= 0) & torch.gather(trailing, 1,
                                                last_nzb.clamp_min(0))
    final_run = torch.where(last_nzb >= 0,
                            (N - 1) - last_nzb + last_trail.to(gap.dtype),
                            N)          # no nonzero block: N all-zero blocks

    def add_runs(hist, runs, valid):
        # split runs at the 0x7FFF forced-flush boundary: k full EOB14
        # symbols plus one EOBn for the remainder
        k = torch.where(valid, runs // 0x7FFF, 0)
        r = torch.where(valid, runs % 0x7FFF, 0)
        hist[:, 14 << 4] += k.sum(1)
        cat = (nbits(r) - 1).clamp_min(0)
        return hist + _bincount_rows(cat << 4, valid & (r > 0), B)

    hist = torch.zeros((B, 256), dtype=torch.int64, device=dev)
    hist = add_runs(hist, run_at, emit_here)
    return add_runs(hist, final_run, torch.ones_like(final_run,
                                                     dtype=torch.bool))


def _ac_first_hist_seg(zz: torch.Tensor, Ss: int, Se: int) -> torch.Tensor:
    """zz (64, B, N): B independent segments of N blocks -> (B, 256)
    int64 counts."""
    nz = zz[Ss:Se + 1] != 0
    return (within_block_hist(zz[Ss:Se + 1])
            + eob_run_hist(nz.any(0), ~nz[-1]))


def by_segment(fn, x: torch.Tensor, batch: int, ri: int) -> torch.Tensor:
    """fn over the restart segments of image-major blocks: x (..., B*n)
    -> (B, 256) int32, fn (..., S, L) -> (S, 256) counts of S segments of
    L blocks. With a restart interval ri each image splits into segments
    of ri blocks in raster order (the last one shorter), counted
    independently and summed."""
    lead = x.shape[:-1]
    xb = x.reshape(*lead, batch, -1)
    n = xb.shape[-1]
    if not ri or ri >= n:
        return fn(xb).to(torch.int32)
    nfull = n // ri
    hist = fn(xb[..., :nfull * ri].reshape(*lead, batch * nfull, ri)) \
        .reshape(batch, nfull, 256).sum(1)
    if n > nfull * ri:
        hist = hist + fn(xb[..., nfull * ri:])
    return hist.to(torch.int32)


def ac_first_histogram_t(zz: torch.Tensor, Ss: int = 1, Se: int = 63,
                         ri: int = 0) -> torch.Tensor:
    """(64, N) zigzag coefficients of one component in scan order ->
    (256,) int32 AC-first counts over band [Ss, Se]; ri > 0 is the restart
    interval in blocks, at whose boundaries the EOB runs flush
    (emit_restart, jcphuff.c)."""
    return ac_first_histograms_t(zz, 1, ri, Ss, Se)[0]


def ac_first_histograms_t(zz: torch.Tensor, batch: int, ri: int = 0,
                          Ss: int = 1, Se: int = 63) -> torch.Tensor:
    """(64, B*n) image-major planes -> (B, 256) int32: one AC-first
    histogram per image over band [Ss, Se]. With a restart interval ri
    each image splits into segments of ri blocks in raster order (the
    last one shorter), counted independently and summed."""
    return by_segment(lambda z: _ac_first_hist_seg(z, Ss, Se), zz, batch,
                      ri)


def dc_hist(deltas: torch.Tensor) -> torch.Tensor:
    """(S, m) DC differences -> (S, 256) int64 size-category counts."""
    size = nbits(deltas.abs()).long()
    hist = torch.zeros((deltas.shape[0], 256), dtype=torch.int64,
                       device=deltas.device)
    return hist.scatter_add_(1, size, torch.ones_like(size))


def ac_histogram(zz: torch.Tensor) -> torch.Tensor:
    """(N, 64) zigzag blocks -> (256,) int32 sequential-scan AC counts:
    per block, (run >> 4) ZRLs and ((run & 15) << 4 | nbits) before each
    nonzero AC coefficient, and one EOB unless position 63 is nonzero."""
    ac = zz[:, 1:].to(torch.int64)                     # (N, 63)
    nz = ac != 0
    pos = torch.arange(1, 64, device=zz.device)[None, :]
    prev_incl = torch.where(nz, pos, 0).cummax(1).values
    prev_excl = torch.cat([torch.zeros_like(prev_incl[:, :1]),
                           prev_incl[:, :-1]], 1)
    run = pos - prev_excl - 1                          # zeros before pos
    sym = ((run & 15) << 4) | nbits(ac.abs())
    hist = torch.bincount(sym[nz], minlength=256)
    hist[0xF0] += torch.where(nz, run >> 4, 0).sum()
    hist[0x00] += (ac[:, -1] == 0).sum()
    return hist.to(torch.int32)


def dc_histogram_restart(plane: torch.Tensor, h: int, v: int, mcus_x: int,
                         mcus_y: int, r: int, Al: int = 0) -> torch.Tensor:
    """DC size-category counts in interleaved-MCU order with the
    predictor reset every r MCUs (jchuff.c emit_restart); Al > 0 is the
    point transform of a progressive DC-first scan (arithmetic shift).
    plane: (..., bh_pad, bw_pad, 64) zigzag coefficients; a leading axis
    sums the images' counts, each image with its own predictor chain.
    -> (256,) int32."""
    dc = plane[..., 0].to(torch.int64) >> Al
    m = dc.reshape(-1, mcus_y, v, mcus_x, h)
    seq = m.permute(0, 1, 3, 2, 4).reshape(m.shape[0], -1)
    prev = torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], 1)
    idx = torch.arange(seq.shape[1], device=seq.device)[None, :]
    prev = torch.where(idx % (r * h * v) == 0, 0, prev)
    return dc_hist(seq - prev).sum(0).to(torch.int32)


def dc_histogram_interleaved(plane: torch.Tensor, h: int, v: int,
                             mcus_x: int, mcus_y: int) -> torch.Tensor:
    """dc_histogram_restart with one predictor chain over the whole
    plane (no restart interval)."""
    return dc_histogram_restart(plane, h, v, mcus_x, mcus_y,
                                mcus_x * mcus_y)
