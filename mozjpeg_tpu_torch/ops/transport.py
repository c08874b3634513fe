"""Device coefficient transport: a Huffman-coded download in place of the
coefficient planes.

Port of mozjpeg_tpu/ops/transport.py, word for word on the wire, so the
shared native decoder (entropy.cpp mj_transport_decode) reads the port's
words. The quantized coefficients Huffman-pack on the device with FIXED
tables (the Annex K luma pair at 8 bits, deterministic extended tables
at 12 bits, _tables) into an internal stream that the host decodes back
into planes, a download several times smaller than the planes.

An internal format, not a JPEG scan: one stream per image of u32 words,
MSB first, no byte stuffing, no markers; blocks in the sparse pack's
order (image-major, components in order, raster blocks); per block the
DC delta (the predictor resets per image and chains across components)
coded with the DC table, then the (run, size) + magnitude AC symbols
with ZRL and EOB coded with the AC table for every component.

Per block the coder has fixed lanes, in stream order: DC, for each of
the first CAPR nonzero AC coefficients a ZRL lane of up to two ZRLs, a
ZRL lane of one and its symbol, and EOB. A lane is live where its
symbol is emitted and within the first captot live lanes of the group;
a segmented prefix sum of the live lengths gives every symbol's bit
offset in its image's stream, and each symbol lands in one or two words
by a scatter-add of disjoint bits (ops/bitpack.py's arithmetic). The JAX
package compacts the lanes with sorts first; the live lanes in lane
order are that same sequence. A block's nonzeros are ranked by a prefix
sum of its nonzero mask, the order the JAX sort gives.

Overflow (a block with more than CAPR nonzero AC coefficients, more
live lanes than the capacity, a magnitude past the table's sizes, or an
image past capw words) flags the header; the caller packs again at a
larger capacity once, then takes the sparse download. The flagged words
still equal the JAX package's.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import consts, native
from ..entropy import encode as entenc
from ..entropy.huffman import HuffTable, derive_codes, derive_decode_table
from ..utils import xfer
from .bitpack import M32, words_i32
from .sparsepack import split_blocks
from .symbols import nbits

CAPR = 48                   # per-block nonzero capacity (sparse pack's 48)
LANES_PER_RANK = 3          # [ZRL x (1..2)] [ZRL x 1] [symbol]
TRIM_STEP = 8192            # word-download bucket (32 KB)


def _scap() -> int:
    """Live lanes a block, on average, that a pack holds (the capacity)."""
    return int(os.environ.get("MJ_TRANSPORT_SCAP", "12"))


@functools.lru_cache(maxsize=2)
def _tables(precision: int = 8):
    """The transport's (DC, AC) Huffman tables: the std luma pair at 8
    bits; at 12 bits (sizes up to 15 DC / 14 AC) Annex-K-optimal tables
    of a fixed geometric frequency profile, the JAX package's."""
    if precision == 8:
        return (HuffTable(*consts.STD_DC_LUMINANCE),
                HuffTable(*consts.STD_AC_LUMINANCE))
    f = np.zeros(257, np.int64)
    for s in range(16):
        f[s] = 1 << (16 - s)
    dc = entenc.gen_optimal_table(f)
    f = np.zeros(257, np.int64)
    f[0x00] = 1 << 16
    f[0xF0] = 1 << 12
    for run in range(16):
        for size in range(1, 15):
            f[(run << 4) | size] = max(1, (1 << 14) >> (run + size))
    return dc, entenc.gen_optimal_table(f)


@functools.lru_cache(maxsize=2)
def _luts(precision: int = 8):
    """(DC codes (16,), DC lengths (16,), AC codes (256,), AC lengths
    (256,)) int64, the DC pair zero past the table's sizes (12 at 8
    bits, 16 at 12), as the JAX package's unrolled select leaves them."""
    dct, act = _tables(precision)
    dco, dsi = derive_codes(dct)
    aco, asi = derive_codes(act)
    ndc = 12 if precision == 8 else 16
    dco16 = np.zeros(16, np.int64)
    dsi16 = np.zeros(16, np.int64)
    dco16[:ndc] = dco[:ndc]
    dsi16[:ndc] = dsi[:ndc]
    return (dco16, dsi16, (aco & 0xFFFF).astype(np.int64),
            asi.astype(np.int64))


def pack_transport(flat: torch.Tensor, b: int, n_tot: int, captot: int,
                   capw: int, precision: int = 8):
    """flat (64, nt) int16 zigzag planes (nt = b * n_tot, the sparse
    pack's block order) -> (words (b, capw) int32, header (b + 2,) int32
    [bits of each image | live lanes wanted | overflow])."""
    dev = flat.device
    dco, dsi, aco, asi = (torch.as_tensor(t, device=dev)
                          for t in _luts(precision))
    zco, zsi = int(aco[0xF0]), int(asi[0xF0])
    eco, esi = int(aco[0x00]), int(asi[0x00])
    nbmax_ac = 10 if precision == 8 else 14
    nt = b * n_tot
    x = flat.T.to(torch.int64)                           # (nt, 64)

    # DC lane: the delta's size and magnitude bits
    dc = x[:, 0].reshape(b, n_tot)
    delta = (dc - torch.cat([torch.zeros_like(dc[:, :1]), dc[:, :-1]], 1)
             ).reshape(nt)
    nb_dc = nbits(delta.abs()).to(torch.int64) & 15
    t2 = torch.where(delta < 0, delta - 1, delta) & 0x7FFF
    v_dc = (dco[nb_dc] << nb_dc) | (t2 & ((1 << nb_dc) - 1))
    l_dc = dsi[nb_dc] + nb_dc

    # the first CAPR nonzero AC coefficients of each block, in order
    ac = x[:, 1:]
    nz = (ac != 0).to(torch.int64)
    rank = torch.cumsum(nz, 1) - nz
    over_rank = (nz.sum(1) > CAPR).any()
    sel = (nz > 0) & (rank < CAPR)
    col = torch.where(sel, rank, CAPR)
    kcol = torch.arange(1, 64, device=dev).expand(nt, 63)
    p_s = torch.full((nt, CAPR + 1), 64, dtype=torch.int64, device=dev) \
        .scatter_(1, col, torch.where(sel, kcol, 64))[:, :CAPR]
    v_s = torch.zeros((nt, CAPR + 1), dtype=torch.int64, device=dev) \
        .scatter_(1, col, torch.where(sel, ac, 0))[:, :CAPR]
    real = p_s < 64
    prev_p = torch.cat([torch.zeros_like(p_s[:, :1]), p_s[:, :-1]], 1)
    run = torch.where(real, p_s - prev_p - 1, 0)
    zc = run >> 4                                         # 0..3
    anb = torch.where(real, nbits(v_s.abs()).to(torch.int64), 0)
    over_mag = (anb > nbmax_ac).any()
    t2 = torch.where(v_s < 0, v_s - 1, v_s) & 0x3FFF
    sym = (((run & 15) << 4) | anb) & 255
    nb_s = anb & 15
    v_sym = (aco[sym] << nb_s) | (t2 & ((1 << nb_s) - 1))
    l_sym = asi[sym] + nb_s
    c_a = zc.clamp_max(2)
    v_a = torch.where(c_a == 2, (zco << zsi) | zco, zco)
    need_eob = torch.where(real, p_s, 0).amax(1) < 63

    # the lanes in stream order and which of them the coder emits
    ones = torch.ones((nt, 1), dtype=torch.int64, device=dev)
    vals = torch.cat([v_dc[:, None],
                      torch.stack([v_a, zco * torch.ones_like(v_a), v_sym],
                                  2).reshape(nt, -1), eco * ones], 1)
    lens = torch.cat([l_dc[:, None],
                      torch.stack([c_a * zsi, zsi * torch.ones_like(c_a),
                                   l_sym], 2).reshape(nt, -1), esi * ones],
                     1)
    cont = torch.cat([ones > 0,
                      torch.stack([real & (zc >= 1), real & (zc == 3), real],
                                  2).reshape(nt, -1), need_eob[:, None]], 1)
    c64 = cont.reshape(-1).to(torch.int64)
    total = c64.sum()
    live = (cont & ((torch.cumsum(c64, 0) - c64) < captot).reshape(nt, -1))
    ln_rows = torch.where(live, lens, 0)
    bits_v = ln_rows.sum(1).reshape(b, n_tot).sum(1)
    over = (over_rank | over_mag | (total > captot)
            | (bits_v > capw * 32).any())

    # each live symbol's bit offset in its image's stream, then its one
    # or two word contributions (disjoint bits: the add is an or)
    val = vals[live]
    ln = ln_rows[live]
    img = torch.arange(nt, device=dev)[:, None].expand(nt, vals.shape[1])[
        live] // n_tot
    start = torch.cumsum(bits_v, 0) - bits_v
    off = torch.cumsum(ln, 0) - ln - start[img]
    sh = off & 31
    w0 = off >> 5
    space0 = 32 - sh
    spill = (ln - space0).clamp_min(0)
    keep0 = ln - spill
    c0 = torch.where(ln > 0, (val >> spill) << (space0 - keep0), 0)
    c1 = torch.where(spill > 0, (val << (32 - spill)) & M32, 0)
    d0 = img * capw + w0                 # past a row spills to the next
    d1 = torch.where(w0 + 1 < capw, d0 + 1, b * capw)
    words = torch.zeros(b * capw + 1, dtype=torch.int64, device=dev)
    words.scatter_add_(0, d0.clamp_max(b * capw), c0)
    words.scatter_add_(0, d1.clamp_max(b * capw), c1)
    header = torch.cat([bits_v, total[None], over[None].to(torch.int64)])
    return (words_i32(words[:b * capw]).reshape(b, capw),
            header.to(torch.int32))


# running per-geometry estimate of the largest image's word count, so
# that the single-transfer fetch rarely needs a second one
_EST_WORDS: dict = {}


def pack_batch(finals, b: int, scap: int = 0, precision: int = 8):
    """finals: per component (64, B * n_c) int16 planes on the device ->
    (words, header, n_tot, capw), the sparse pack's block order. scap
    overrides the capacity (live lanes a block; the retry packs at 32);
    precision picks the table set."""
    flat = torch.cat([f.reshape(64, b, -1) for f in finals], 2)
    n_tot = flat.shape[2]
    nt = b * n_tot
    captot = -(-nt * (scap or _scap()) // 512) * 512
    capw = 13 * n_tot + 2
    words, header = pack_transport(flat.reshape(64, nt), b, n_tot, captot,
                                   capw, precision)
    return words, header, n_tot, capw


def fetch(packed):
    """One transfer of [header | each image's words up to the running
    estimate]; a second, exact one only when an image outgrew it.
    -> (words (b, w) uint32, bits (b,) int32), or None on overflow."""
    words_dev, header_dev, n_tot, capw = packed
    b = words_dev.shape[0]
    est = _EST_WORDS.get(n_tot, max(1, n_tot * 5 // 32))
    bucket = min(capw, -(-int(est * 1.3) // TRIM_STEP) * TRIM_STEP)
    buf = torch.cat([header_dev, words_dev[:, :bucket].reshape(-1)]) \
        .cpu().numpy()
    xfer.add_d2h(buf.nbytes)
    header = buf[:b + 2]
    if int(header[-1]):
        return None
    bits = header[:-2]
    need = int(max(1, (int(bits.max()) + 31) // 32))
    _EST_WORDS[n_tot] = need
    if need <= bucket:
        return (buf[b + 2:].view(np.uint32).reshape(b, bucket),
                bits.astype(np.int32))
    bucket = min(capw, -(-need // TRIM_STEP) * TRIM_STEP)
    words = words_dev[:, :bucket].cpu().numpy().view(np.uint32)
    xfer.add_d2h(words.nbytes)
    return words, bits.astype(np.int32)


@functools.lru_cache(maxsize=2)
def _dec_tables(precision: int = 8):
    """The decoder arrays of the table pair for the native walker."""
    out = []
    for tbl in _tables(precision):
        mn, mx, vp, vals = derive_decode_table(tbl)
        v = np.zeros(256, np.uint8)
        v[:len(vals)] = vals
        out.append((np.ascontiguousarray(mn.astype(np.int32)),
                    np.ascontiguousarray(mx.astype(np.int64)),
                    np.ascontiguousarray(vp.astype(np.int32)),
                    np.ascontiguousarray(v)))
    return out


def decode_to_planes(words: np.ndarray, bits: np.ndarray, b: int, comps,
                     precision: int = 8):
    """Host decode of the stream (native mj_transport_decode) -> per
    image per component (bh, bw, 64) int16 planes, or None on a
    malformed stream."""
    n_tot = sum(g.bh * g.bw for g in comps)
    out = np.zeros((b * n_tot, 64), np.int16)
    (dmn, dmx, dvp, dvl), (amn, amx, avp, avl) = _dec_tables(precision)
    words = np.ascontiguousarray(words)
    bits = np.ascontiguousarray(bits.astype(np.int32))
    rc = native.lib().mj_transport_decode(
        words.ctypes.data_as(native.u32p), words.shape[1],
        bits.ctypes.data_as(native.i32p), b, n_tot,
        dmn.ctypes.data_as(native.i32p), dmx.ctypes.data_as(native.i64p),
        dvp.ctypes.data_as(native.i32p), dvl.ctypes.data_as(native.u8p),
        amn.ctypes.data_as(native.i32p), amx.ctypes.data_as(native.i64p),
        avp.ctypes.data_as(native.i32p), avl.ctypes.data_as(native.u8p),
        out.ctypes.data_as(native.i16p))
    if rc != 0:
        return None
    return split_blocks(out, b, comps)
