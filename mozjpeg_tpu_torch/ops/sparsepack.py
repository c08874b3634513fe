"""Sparse coefficient transfer: nonzero masks + an exactly compacted value
stream.

Port of mozjpeg_tpu/ops/sparsepack.py, word for word on the wire, so the
shared native expanders read the port's words. Quantized coefficient
planes are mostly zero, so a download (or upload) of masks and nonzero
values moves fewer bytes than the dense int16 planes.

ENCODE download (pack_planes_exact, fetch_exact, expand_flat_to_planes):
  header int32 [per-block 64-bit nonzero masks (lo, hi words) | total |
  total_esc | overflow]; the values in block order, zigzag order inside
  a block, one byte each (0x80 marks an escape), four to a u32 word,
  little-endian; the escapes' int16 values, two to a word. The host
  syncs the header, downloads only the buckets the actual counts need
  and expands natively (entropy.cpp mj_sparse_expand_flat). A block
  denser than CAP_BLOCK, more values than VALS_PER_BLOCK_CAP a block on
  average, or more escapes than half that, flags the overflow, and the
  caller downloads dense.
DECODE upload, flat (pack_flat_host, expand_flat_dev): the same masks /
  bytes / escapes layout packed on the host, buckets sized exactly.
DECODE upload, superblocks (pack_host, expand_dev): per-block masks and
  per-superblock int16 value slabs (native post.cpp mj_sparse_pack).

The JAX package compacts with sorts and one-hot einsums; here every
value moves by index (scatter and gather, exact by construction; a
matmul may run in TF32 on the card). A value's place is its block's
exclusive offset plus its rank among the block's nonzeros, a prefix
sum of the nonzero mask, which is the order the JAX sorts give. On
overflow the words still equal the JAX package's: ranks past CAP_BLOCK
repeat the block's last kept value, as its clipped gather does. Words
are int64 holding 32 bits on the device (ops/bitpack.py), int32 on the
wire, uint32 on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..utils import xfer
from .bitpack import words_i32, words_i64

CAP_BLOCK = 48
G = 8                       # blocks per superblock
CAP_SB_CHOICES = (128, 192, 256, 320)   # adaptive per-superblock slots
VALS_PER_BLOCK_CAP = 16     # static value capacity = nt * this
TRIM_WORDS_STEP = 32768     # download bucket, 128 KB


def _nz_bits(masks: torch.Tensor, nt: int) -> torch.Tensor:
    """(nt * 2,) or (nt, 2) 32-bit mask words -> (nt, 64) int64 0/1."""
    m = words_i64(masks.reshape(nt, 2))
    k = torch.arange(64, device=masks.device)
    word = torch.where(k[None, :] < 32, m[:, 0:1], m[:, 1:2])
    return (word >> (k & 31)) & 1


def expand_dev(masks: torch.Tensor, vals: torch.Tensor, nt: int,
               cap_sb: int) -> torch.Tensor:
    """Inverse of pack_host on the device: masks (nt, 2) int32 per-block
    64-bit nonzero bitmaps, vals (S, cap_sb // 2) int32 = each
    superblock's nonzero values as int16 pairs in (block, zigzag) order
    -> dense (64, nt) int16 zigzag planes."""
    dev = masks.device
    nzb = _nz_bits(masks, nt)
    rank = torch.cumsum(nzb, 1) - nzb
    counts = nzb.sum(1)
    c_sb = counts.reshape(nt // G, G)
    start = (torch.cumsum(c_sb, 1) - c_sb).reshape(nt, 1)
    v2 = vals.contiguous().view(torch.int16).reshape(-1)
    slot = start + rank
    # the JAX one-hots hold CAP_BLOCK slots a block and cap_sb a slab
    ok = (nzb > 0) & (rank < CAP_BLOCK) & (slot < cap_sb)
    sb = torch.arange(nt, device=dev)[:, None] // G
    idx = torch.where(ok, sb * cap_sb + slot, 0)
    return torch.where(ok, v2[idx], 0).T.to(torch.int16)


def pack_host(planes_flat: np.ndarray, cap_choices=CAP_SB_CHOICES):
    """Host-side pack (native mj_sparse_count / mj_sparse_pack) of
    (nblocks, 64) int16 zigzag planes for upload: nblocks padded to a
    multiple of G, the smallest capacity bucket that fits the worst
    superblock. -> (masks (nt, 2) int32 view, vals (S, cap_sb // 2)
    int32, nt, cap_sb), or None when no bucket fits or a block has more
    than CAP_BLOCK nonzeros (the caller uploads dense)."""
    lib = native.lib()
    n = planes_flat.shape[0]
    nt = -(-n // G) * G
    if nt != n or not planes_flat.flags.c_contiguous:
        buf = np.zeros((nt, 64), np.int16)
        buf[:n] = planes_flat
        planes_flat = buf
    S = nt // G
    counts = np.empty(S, np.int32)
    maxc = lib.mj_sparse_count(planes_flat.ctypes.data_as(native.i16p), nt,
                               G, counts.ctypes.data_as(native.i32p))
    cap_sb = next((c for c in cap_choices if maxc <= c), None)
    if cap_sb is None:
        return None
    masks = np.empty((nt, 2), np.uint32)
    vals = np.empty((S, cap_sb // 2), np.int32)
    rc = lib.mj_sparse_pack(planes_flat.ctypes.data_as(native.i16p), nt, G,
                            cap_sb, masks.ctypes.data_as(native.u32p),
                            vals.ctypes.data_as(native.i16p))
    if rc != 0:
        return None
    if maxc > CAP_BLOCK and np.any(
            np.sum(planes_flat.reshape(nt, 64) != 0, axis=1) > CAP_BLOCK):
        return None
    return masks.view(np.int32), vals, nt, cap_sb


def pack_exact(flat: torch.Tensor):
    """flat (64, nt) int16 zigzag planes -> (header (nt * 2 + 3,) int32
    [masks | total | total_esc | overflow], lo (capv // 4,) int32 words
    of value bytes, esc (capv // 4,) int32 words of escape int16 pairs),
    capv = nt * VALS_PER_BLOCK_CAP; the JAX _pack_exact."""
    dev = flat.device
    nt = flat.shape[1]
    x = flat.to(torch.int64)                         # (64, nt)
    nz = (x != 0).to(torch.int64)
    k = torch.arange(64, device=dev)[:, None]
    bit = torch.where(nz > 0, 1 << (k & 31), 0)
    mask_lo = bit[:32].sum(0)                        # distinct bits: an or
    mask_hi = bit[32:].sum(0)
    counts = nz.sum(0)
    over_blk = (counts > CAP_BLOCK).any()
    rank = torch.cumsum(nz, 0) - nz
    capv = nt * VALS_PER_BLOCK_CAP
    off = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    over = over_blk | (total > capv)
    # a block's ranks past CAP_BLOCK take its last kept value (the JAX
    # gather clips the slot); such a pack is flagged and not read
    last = torch.where((rank == CAP_BLOCK - 1) & (nz > 0), x, 0).sum(0)
    v = torch.where(rank < CAP_BLOCK, x, last[None, :])
    pos = off[None, :] + rank
    keep = (nz > 0) & (pos < capv)
    vals = torch.zeros(capv + 1, dtype=torch.int64, device=dev)
    vals.scatter_(0, torch.where(keep, pos, capv).reshape(-1),
                  torch.where(keep, v, 0).reshape(-1))
    vals = vals[:capv]
    live = torch.arange(capv, device=dev) < total
    # one byte a value: quantized AC values are mostly small; 0x80 marks
    # an escape whose int16 rides in the side stream
    esc = live & ((vals < -127) | (vals > 127))
    lo = torch.where(esc, -128, vals) & 0xFF
    quad = lo.reshape(capv // 4, 4)
    words_lo = (quad[:, 0] | (quad[:, 1] << 8) | (quad[:, 2] << 16)
                | (quad[:, 3] << 24))
    cap_esc = capv // 2
    esc64 = esc.to(torch.int64)
    eidx = torch.cumsum(esc64, 0) - esc64
    total_esc = esc64.sum()
    over = over | (total_esc > cap_esc)
    evals = torch.zeros(cap_esc + 1, dtype=torch.int64, device=dev)
    evals.scatter_(0, torch.where(esc, eidx, cap_esc).clamp_max(cap_esc),
                   torch.where(esc, vals, 0))
    evals = evals[:cap_esc] & 0xFFFF
    epair = evals.reshape(cap_esc // 2, 2)
    words_esc = epair[:, 0] | (epair[:, 1] << 16)
    masks = torch.stack([mask_lo, mask_hi], 1).reshape(-1)
    header = torch.cat([words_i32(masks),
                        torch.stack([total, total_esc,
                                     over.to(torch.int64)]).to(torch.int32)])
    return header, words_i32(words_lo), words_i32(words_esc)


def pack_planes_exact(finals, b: int):
    """finals: per component (64, B * n_c) int16 planes on the device ->
    (header, (lo, esc), nt, n_tot). Block order: image-major, components
    in order, raster blocks."""
    flat = torch.cat([f.reshape(64, b, -1) for f in finals], 2)
    n_tot = flat.shape[2]
    nt = b * n_tot
    header, lo, esc = pack_exact(flat.reshape(64, nt))
    return header, (lo, esc), nt, n_tot


def _bucket(n: int) -> int:
    return -(-max(n, 1) // TRIM_WORDS_STEP) * TRIM_WORDS_STEP


def fetch_exact(header_dev: torch.Tensor, words_dev, nt: int):
    """Sync the header, then only the needed byte and escape buckets.
    -> (masks (nt * 2,) uint32, lo uint8, esc int16, total), or None on
    overflow (the caller downloads dense)."""
    header = header_dev.cpu().numpy()
    if int(header[-1]):
        xfer.add_d2h(header.nbytes)
        return None
    total = int(header[-3])
    total_esc = int(header[-2])
    masks = header[:nt * 2].view(np.uint32)
    lo_dev, esc_dev = words_dev
    lo = lo_dev[:_bucket((total + 3) // 4)].cpu().numpy().view(np.uint8)
    if total_esc == 0:
        esc = np.zeros(0, np.int16)
    else:
        esc = esc_dev[:_bucket((total_esc + 1) // 2)].cpu().numpy() \
            .view(np.int16)
    xfer.add_d2h(header.nbytes + lo.nbytes + esc.nbytes)
    return masks, lo, esc, total


def split_blocks(out: np.ndarray, b: int, comps) -> list:
    """(b * n_tot, 64) blocks -> per image per component (bh, bw, 64)."""
    images, off = [], 0
    for _ in range(b):
        planes = []
        for g in comps:
            n = g.bh * g.bw
            planes.append(out[off:off + n].reshape(g.bh, g.bw, 64))
            off += n
        images.append(planes)
    return images


def expand_flat_to_planes(masks: np.ndarray, lo: np.ndarray,
                          esc: np.ndarray, nt: int, b: int, comps):
    """Host expansion of the exact layout (native mj_sparse_expand_flat)
    -> per image per component (bh, bw, 64) int16 planes, or None on a
    malformed stream."""
    out = np.zeros((nt, 64), np.int16)
    masks, lo, esc = (np.ascontiguousarray(a) for a in (masks, lo, esc))
    rc = native.lib().mj_sparse_expand_flat(
        masks.ctypes.data_as(native.u32p), lo.ctypes.data_as(native.u8p),
        esc.ctypes.data_as(native.i16p), nt, len(lo), len(esc),
        out.ctypes.data_as(native.i16p))
    if rc != 0:
        return None
    return split_blocks(out, b, comps)


def _relbucket(n: int, floor_step: int) -> int:
    """n rounded up to a coarse-mantissa bucket (at most 20% slack,
    never finer than floor_step): the JAX package's static render shapes
    per geometry, kept for the same bytes on the wire."""
    n = max(n, 1)
    step = max(floor_step, 1 << max((n - 1).bit_length() - 3, 0))
    return -(-n // step) * step


def pack_flat_host(flat: np.ndarray):
    """(n, 64) int16 zigzag planes -> (masks (n * 2,) int32 view, lo
    (capv,) uint8, esc (cape,) int16, nt, total, nesc) for the decode
    upload; the host knows every count, so nothing overflows and a
    block may hold all 64 nonzeros."""
    n = flat.shape[0]
    m = flat != 0
    masks = np.packbits(m, axis=1, bitorder="little")    # (n, 8) u8
    vals = flat[m].astype(np.int32)                      # block, then k
    total = int(vals.size)
    esc_mask = (vals < -127) | (vals > 127)
    esc = vals[esc_mask].astype(np.int16)
    nesc = int(esc.size)
    lo = np.zeros(_relbucket(total, 16384), np.uint8)
    lo[:total] = np.where(esc_mask, 0x80, vals & 0xFF).astype(np.uint8)
    esc_buf = np.zeros(_relbucket(nesc, 2048), np.int16)
    esc_buf[:nesc] = esc
    return (np.ascontiguousarray(masks).view(np.int32).reshape(-1), lo,
            esc_buf, n, total, nesc)


def expand_flat_dev(masks: torch.Tensor, lo: torch.Tensor,
                    esc: torch.Tensor, nt: int) -> torch.Tensor:
    """Device inverse of pack_flat_host: masks (nt * 2,) int32, lo
    (capv,) uint8, esc (cape,) int16 -> dense (64, nt) int16 zigzag
    planes. The r-th set bit of block t takes the value at its offset
    plus r; a 0x80 byte takes the escape of its rank among the 0x80s."""
    nzb = _nz_bits(masks, nt)
    counts = nzb.sum(1)
    off = torch.cumsum(counts, 0) - counts
    rank = torch.cumsum(nzb, 1) - nzb
    byte = lo.to(torch.int64)
    is_esc = (byte == 0x80).to(torch.int64)
    erank = (torch.cumsum(is_esc, 0) - is_esc).clamp_max(esc.shape[0] - 1)
    ev = esc.to(torch.int64)[erank]
    val = torch.where(is_esc > 0, ev, torch.where(byte >= 128, byte - 256,
                                                  byte))
    vidx = (off[:, None] + rank).clamp_max(byte.shape[0] - 1)
    return torch.where(nzb > 0, val[vidx], 0).T.to(torch.int16)
