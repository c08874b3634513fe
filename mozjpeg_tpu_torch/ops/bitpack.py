"""Huffman bit packing on the device, restart-parallel.

Port of mozjpeg_tpu/ops/bitpack.py. The reference's entropy coder writes
one serial bit stream (jchuff.c encode_one_block, jcphuff.c); its only
parallelism is the restart interval, at which the DC predictors, the EOB
runs and the byte alignment reset. So every restart segment packs on its
own, all at once:

  1. per block, each symbol the coder could emit gets a fixed lane of
     (value, bit length), 0 bits where the symbol is absent: a DC lane,
     three ZRL lanes and a (run, size) + magnitude lane per AC position,
     an EOB lane (and for progressive scans the EOB-run flushes);
  2. a segmented exclusive prefix sum of the lengths gives every lane's
     bit offset in its segment;
  3. each lane splits into at most two 32-bit word contributions,
     scatter-added into the segment's words: the bit ranges are
     disjoint, so the add is an or, exact in any order.

A scan has 4-6 lanes per coefficient of its band, so a packer builds
them a chunk of rows (blocks, or MCUs) at a time, the chunk sized to the
device's free memory (chunk_rows): a first pass sums each row's bits, a
segmented prefix sum over the rows places them, and a second pass
scatters each chunk's lanes. Where one chunk holds every row, the lanes
are built once. A packer's memory is so bounded whatever the image's
size, and its words are sized to the longest segment's bits.

Words are int64 holding 32 bits each (torch's uint32 supports few ops).
The host (finish_segments, numpy) trims each segment to its bytes,
1-pads the last byte, stuffs 0x00 after each 0xFF and joins the segments
with RSTn markers. The AC-refinement packer takes its cross-block EOB-run
and correction-bit flush schedule from the native mj_ac_refine_schedule
on the host, as the JAX package's does. Byte-identical to the serial
host encoder (native entropy.cpp).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from .symbols import nbits

M32 = 0xFFFFFFFF
DC = slice(0, 1)


def words_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 words of 32 bits -> int32 tensors of the same bits: the
    4-byte wire word of a download, read as uint32 on the host."""
    return torch.where(w > 0x7FFFFFFF, w - (1 << 32), w).to(torch.int32)


def words_i64(w: torch.Tensor) -> torch.Tensor:
    """32-bit wire words (int32 bits) -> int64 in [0, 2**32)."""
    return w.to(torch.int64) & M32

# A packer's live temporaries take about LANE_BYTES for each lane of its
# chunk (122 measured on the card at a 16.7M-lane chunk). A chunk takes a
# quarter of the card's memory that its allocator has not handed out, at
# most MAX_CHUNK_BYTES (CPU_CHUNK_BYTES on the host).
LANE_BYTES = 128
MAX_CHUNK_BYTES = 8 << 30
CPU_CHUNK_BYTES = 256 << 20


def chunk_rows(dev: torch.device, lanes_per_row: int) -> int:
    """The rows of one chunk of a packer with lanes_per_row lanes a row.
    The allocator's counts are read, not the driver's (cudaMemGetInfo),
    which is slow beside a packer's launches."""
    if dev.type == "cuda":
        free = (torch.cuda.get_device_properties(dev).total_memory
                - torch.cuda.memory_allocated(dev))
        budget = min(free // 4, MAX_CHUNK_BYTES)
    else:
        budget = CPU_CHUNK_BYTES
    return max(1, budget // LANE_BYTES // lanes_per_row)


def _nb(v: torch.Tensor) -> torch.Tensor:
    """JPEG_NBITS of non-negative v, int64."""
    return nbits(v).to(torch.int64)


def _mag_bits(v: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """The nb magnitude bits of v (v - 1 for negative v, jchuff.c)."""
    return torch.where(v < 0, v - 1, v) & ((1 << nb) - 1)


def _prev_excl(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive running maximum along `dim` (0 before the first)."""
    c = torch.cummax(x, dim).values
    return torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)),
                      c.narrow(dim, 0, c.shape[dim] - 1)], dim)


def _block_lanes(zz, dc_delta, dc_co, dc_si, ac_co, ac_si):
    """Symbol lanes of blocks: zz (..., 64) int64 zigzag coefficients,
    dc_delta (...) int64; tables (256,) int64. -> (vals, lens), each
    (..., 254) int64, in emission order: DC, per position [ZRL ZRL ZRL
    symbol], EOB."""
    nb = _nb(dc_delta.abs())
    dc_val = (dc_co[nb] << nb) | _mag_bits(dc_delta, nb)
    dc_len = dc_si[nb] + nb

    ac = zz[..., 1:]
    k = torch.arange(1, 64, device=zz.device)
    nz = ac != 0
    marked = torch.where(nz, k, 0)
    run = k - _prev_excl(marked) - 1
    anb = _nb(ac.abs())
    sym = ((run & 15) << 4) + anb
    sym_val = (ac_co[sym] << anb) | _mag_bits(ac, anb)
    sym_len = torch.where(nz, ac_si[sym] + anb, 0)
    nzrl = run >> 4
    zrl = [torch.where(nz & (nzrl >= i), ac_si[0xF0], 0) for i in (1, 2, 3)]
    eob_len = torch.where(marked.amax(-1) < 63, ac_si[0], 0)

    zv = ac_co[0xF0].expand_as(sym_val)
    pos_vals = torch.stack([zv, zv, zv, sym_val], -1).flatten(-2)
    pos_lens = torch.stack(zrl + [sym_len], -1).flatten(-2)
    vals = torch.cat([dc_val[..., None], pos_vals,
                      ac_co[0].expand_as(dc_val)[..., None]], -1)
    lens = torch.cat([dc_len[..., None], pos_lens, eob_len[..., None]], -1)
    return vals, lens


def _dc_deltas(seq: torch.Tensor) -> torch.Tensor:
    """(S, n) DC values per segment -> differences to the previous block,
    the predictor 0 at each segment's start."""
    return seq - torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], 1)


def _mcu_rows(planes, geoms, mcus_x: int, mcus_y: int, lo: int, hi: int,
              coefs: slice = slice(None)):
    """Per component (hi - lo, v*h, K) int64 blocks of the MCUs lo:hi in
    MCU order (K: the coefficients `coefs`), zero past the real MCUs."""
    end = min(hi, mcus_x * mcus_y)
    r0 = lo // mcus_x
    r1 = -(-end // mcus_x) if end > lo else r0
    out = []
    for p, (h, v) in zip(planes, geoms):
        q = p[r0 * v:r1 * v, :mcus_x * h, coefs].to(torch.int64)
        K = q.shape[-1]
        q = q.reshape(r1 - r0, v, mcus_x, h, K).permute(0, 2, 1, 3, 4) \
            .reshape((r1 - r0) * mcus_x, v * h, K)
        q = q[lo - r0 * mcus_x:end - r0 * mcus_x]
        out.append(torch.nn.functional.pad(
            q, (0, 0, 0, 0, 0, hi - lo - q.shape[0])))
    return out


def _real(lens: torch.Tensor, lo: int, nreal: int) -> torch.Tensor:
    """lens of the rows lo:lo+R, 0 from row nreal on (the padding)."""
    rows = torch.arange(lo, lo + lens.shape[0], device=lens.device)
    return torch.where(rows[:, None] < nreal, lens, 0)


def _tables(tables, dev):
    """[(ehufco, ehufsi)] numpy pairs -> [(co, si)] int64 tensors."""
    return [(torch.as_tensor(np.asarray(co, np.int64), device=dev),
             torch.as_tensor(np.asarray(si, np.int64), device=dev))
            for co, si in tables]


class Placed(NamedTuple):
    """Where pack_rows put the lanes: row_off (rows,) each row's first
    bit in its segment, row_bits (rows,) its bits, tail_off (S, Lt) the
    offsets of the segments' tail lanes (None without a tail)."""
    row_off: torch.Tensor
    row_bits: torch.Tensor
    tail_off: Optional[torch.Tensor]


def _scatter(out: torch.Tensor, nwords: int, seg, vals, lens, off):
    """Add (R, K) lanes, the low `lens` bits (at most 32) of vals at bit
    offsets `off` of their segments `seg` (R, 1), into the flat words
    `out` of nwords a segment: each lane lands in one or two words."""
    sh = off & 31
    w0 = off >> 5
    space0 = 32 - sh
    spill = (lens - space0).clamp_min(0)
    keep0 = lens - spill
    c0 = torch.where(lens > 0, ((vals >> spill) << (space0 - keep0)) & M32,
                     0)
    c1 = torch.where(spill > 0, (vals << (32 - spill)) & M32, 0)
    base = seg * nwords
    for w, c in ((w0, c0), (w0 + 1, c1)):
        # an empty lane adds 0 at its own word (not all at one address,
        # whose atomics would serialise); what lies past the end drops
        inside = w < nwords
        out.scatter_add_(0, (base + torch.where(inside, w, 0)).reshape(-1),
                         torch.where(inside, c, 0).reshape(-1))


def pack_rows(dev, n_rows: int, restart: int, lanes_per_row: int,
              row_lanes, tail=None, extra=None):
    """Pack S = n_rows / restart segments of `restart` rows each, their
    lanes built a chunk of rows at a time -> ((S, nwords) int64 words of
    32 bits, MSB first, nwords fitting the longest segment; (S,) int64
    bits).

    row_lanes(lo, hi) -> (vals, lens, ctx): the lanes of rows lo:hi,
      each (hi - lo, lanes_per_row) int64 in emission order; ctx goes to
      extra;
    tail: (vals, lens) (S, Lt) lanes after each segment's rows, or None;
    extra(ctx, off, placed) -> (vals, lens, offs) (hi - lo, K): more bit
      ranges of those rows at explicit offsets in their segments, given
      the rows' lane offsets `off` and every row's Placed offsets."""
    S = n_rows // restart
    step = chunk_rows(dev, lanes_per_row)
    spans = [(lo, min(lo + step, n_rows)) for lo in range(0, n_rows, step)]
    built = None
    if len(spans) == 1:
        built = row_lanes(0, n_rows)
        row_bits = built[1].sum(1)
    else:
        row_bits = torch.cat([row_lanes(lo, hi)[1].sum(1)
                              for lo, hi in spans])
    rb = row_bits.reshape(S, restart)
    bits = rb.sum(1)
    tail_off = None
    if tail is not None:
        tcs = torch.cumsum(tail[1], 1)
        tail_off = bits[:, None] + tcs - tail[1]
        bits = bits + tcs[:, -1]
    placed = Placed((torch.cumsum(rb, 1) - rb).reshape(-1), row_bits,
                    tail_off)
    nwords = max(1, (int(bits.max()) + 31) // 32)
    out = torch.zeros(S * nwords, dtype=torch.int64, device=dev)
    for lo, hi in spans:
        vals, lens, ctx = built if built is not None else row_lanes(lo, hi)
        seg = torch.arange(lo, hi, device=dev)[:, None] // restart
        off = placed.row_off[lo:hi, None] + torch.cumsum(lens, 1) - lens
        _scatter(out, nwords, seg, vals, lens, off)
        if extra is not None:
            _scatter(out, nwords, seg, *extra(ctx, off, placed))
    if tail is not None:
        _scatter(out, nwords, torch.arange(S, device=dev)[:, None],
                 tail[0], tail[1], tail_off)
    return out.reshape(S, nwords), bits


def _pack_whole(vals, lens, restart: int):
    """pack_rows of lanes already built, (n_rows, L) each."""
    return pack_rows(vals.device, vals.shape[0], restart, vals.shape[1],
                     lambda lo, hi: (vals[lo:hi], lens[lo:hi], None))


def _pack_segments(planes, dc_tab, ac_tab, geoms, mcus_x: int, mcus_y: int,
                   restart: int):
    """Baseline sequential interleaved scan -> ((S, nwords) words, (S,)
    bits), one row per restart segment of `restart` MCUs."""
    num_mcus = mcus_x * mcus_y
    S = -(-num_mcus // restart)
    n = S * restart
    deltas = [_dc_deltas(d[:, :, 0].reshape(S, -1)).reshape(n, -1)
              for d in _mcu_rows(planes, geoms, mcus_x, mcus_y, 0, n, DC)]

    def lanes(lo, hi):
        parts = [_block_lanes(b, d[lo:hi], *dc_tab[ci], *ac_tab[ci])
                 for ci, (b, d) in enumerate(zip(_mcu_rows(
                     planes, geoms, mcus_x, mcus_y, lo, hi), deltas))]
        vals = torch.cat([v for v, _ in parts], 1).reshape(hi - lo, -1)
        lens = torch.cat([ln for _, ln in parts], 1).reshape(hi - lo, -1)
        return vals, _real(lens, lo, num_mcus), None

    bpm = sum(h * v for h, v in geoms)
    return pack_rows(planes[0].device, n, restart, bpm * 254, lanes)


def as_dev(p) -> torch.Tensor:
    """A plane as a tensor: itself, its device twin (DualPlane.dev) where
    the encoder attached one, else the host array as a CPU tensor."""
    if isinstance(p, torch.Tensor):
        return p
    d = getattr(p, "dev", None)
    return d if d is not None else torch.from_numpy(np.ascontiguousarray(p))


def fetch_trimmed(words: torch.Tensor, bits: torch.Tensor):
    """The bit counts (tiny), then only the filled prefix of the words:
    the packers allocate the worst case, 10-100x a real scan.
    -> (words, bits) on the host."""
    bits_h = bits.cpu().numpy()
    need = max(1, (int(bits_h.max()) + 31) // 32) if bits_h.size else 1
    return words[:, :min(need, words.shape[1])].cpu().numpy(), bits_h


def finish_segments(words: np.ndarray, bits: np.ndarray, restart: bool,
                    rst_offset: int = 0, trailing_rst: bool = False
                    ) -> bytes:
    """Host finishing: trim, 1-pad to the byte boundary, 0xFF-stuff, join
    with RSTn markers (the serial coder's flush and restart). rst_offset
    shifts the RST numbering and trailing_rst ends with a marker, for
    stitching a shard's segments into a larger scan."""
    out = []
    S = words.shape[0]
    for s in range(S):
        n = int(bits[s])
        nbytes = (n + 7) >> 3
        b = bytearray(words[s].astype(">u4").tobytes()[:nbytes])
        pad = (-n) % 8
        if pad:
            b[-1] |= (1 << pad) - 1
        seg = bytes(b)
        if b"\xff" in seg:
            a = np.frombuffer(seg, np.uint8)
            seg = np.insert(a, np.flatnonzero(a == 0xFF) + 1, 0).tobytes()
        out.append(seg)
        if restart and (s != S - 1 or trailing_rst):
            out.append(bytes([0xFF, 0xD0 + ((s + rst_offset) & 7)]))
    return b"".join(out)


def encode_scan_bitpar(planes: Sequence, geoms: Sequence[Tuple[int, int]],
                       mcus_x: int, mcus_y: int, restart: int,
                       dc_tables: List, ac_tables: List,
                       rst_offset: int = 0,
                       trailing_rst: bool = False) -> bytes:
    """Baseline sequential interleaved scan, packed on the device per
    restart segment, at 8 or 12 bits. planes: per component (bh_pad,
    bw_pad, 64) zigzag coefficients (DualPlanes or host arrays);
    dc_tables / ac_tables: per component (ehufco, ehufsi) numpy pairs."""
    pl = [as_dev(p) for p in planes]
    dev = pl[0].device
    num_mcus = mcus_x * mcus_y
    words, bits = _pack_segments(pl, _tables(dc_tables, dev),
                                 _tables(ac_tables, dev), tuple(geoms),
                                 mcus_x, mcus_y,
                                 restart if restart > 0 else num_mcus)
    return finish_segments(*fetch_trimmed(words, bits), restart > 0,
                           rst_offset, trailing_rst)


# ---------------------------------------------------------------------------
# Progressive scans (jcphuff.c), restart-parallel. A non-interleaved scan
# takes each block as one "MCU", in raster order over the component's
# real block grid (jcmaster.c:533 per_scan_setup).
# ---------------------------------------------------------------------------

def _look(tab: torch.Tensor, idx, seg) -> torch.Tensor:
    """tab[idx] of one table (256,), or tab[seg, idx] of one table per
    segment (S, 256) (a group's images packed as the segments of one
    call); seg broadcasts against idx."""
    if tab.dim() == 1:
        return tab[idx]
    return tab.reshape(-1)[seg * 256 + idx]


def _pack_dc_first(planes, dc_tab, geoms, mcus_x, mcus_y, restart, Al):
    """DC first (encode_mcu_DC_first): per block Huffman(nbits(delta)) +
    the delta's bits, on the DC point-transformed by Al."""
    num_mcus = mcus_x * mcus_y
    S = -(-num_mcus // restart)
    n = S * restart
    seg = torch.arange(n, device=planes[0].device)[:, None] // restart
    all_vals, all_lens = [], []
    for d, (co, si), (h, v) in zip(
            _mcu_rows(planes, geoms, mcus_x, mcus_y, 0, n, DC), dc_tab,
            geoms):
        deltas = _dc_deltas((d[:, :, 0] >> Al).reshape(S, -1)) \
            .reshape(n, h * v)
        nb = _nb(deltas.abs())
        all_vals.append((_look(co, nb, seg) << nb) | _mag_bits(deltas, nb))
        all_lens.append(_look(si, nb, seg) + nb)
    return _pack_whole(torch.cat(all_vals, 1),
                       _real(torch.cat(all_lens, 1), 0, num_mcus), restart)


def _pack_dc_refine(planes, geoms, mcus_x, mcus_y, restart, Al):
    """DC refinement: one raw bit per block, MCU order."""
    num_mcus = mcus_x * mcus_y
    n = -(-num_mcus // restart) * restart
    vals = torch.cat([(d[:, :, 0] >> Al) & 1 for d in _mcu_rows(
        planes, geoms, mcus_x, mcus_y, 0, n, DC)], 1)
    return _pack_whole(vals, _real(torch.ones_like(vals), 0, num_mcus),
                       restart)


def _eob_lane(runv, active, ac_co, ac_si, seg):
    """EOBn symbol + the run's low bits for runs `runv` where active."""
    nb = (_nb(runv) - 1).clamp_min(0)
    sym = nb << 4
    val = (_look(ac_co, sym, seg) << nb) | (runv & ((1 << nb) - 1))
    return val, torch.where(active & (runv > 0),
                            _look(ac_si, sym, seg) + nb, 0)


def _count(h: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor):
    """Add one to the flat counts h at each idx where mask: a histc of
    the bins' centres, the others moved below its range (no sync, as a
    selection or a bincount would take, and no atomics piled onto one
    bin). Exact: float32 holds the centres, and each bin's count of a
    chunk (at most a few million entries) below 2^24."""
    n = h.numel()
    x = torch.where(mask, idx.to(torch.float32) + 0.5, -1.0)
    h += torch.histc(x, bins=n, min=0, max=n).to(torch.int64)


def _run_hist(h: torch.Tensor, runs: torch.Tensor, seg: torch.Tensor):
    """Count the EOBn symbols of the EOB runs `runs` (0: none) into the
    flat (S * 256) counts h, each in its segment seg."""
    _count(h, seg * 256 + ((_nb(runs) - 1).clamp_min(0) << 4), runs > 0)


class Band:
    """The coefficients Ss..Se of one component's bh x bw real blocks in
    raster order, n_rows >= bh * bw rows (zero past the real blocks: the
    segment grid's padding), read a chunk of rows at a time from its
    (bh_pad, bw_pad, 64) plane."""

    def __init__(self, plane: torch.Tensor, bh: int, bw: int, Ss: int,
                 Se: int, n_rows: int):
        self.plane, self.bw, self.Ss, self.Se = plane, bw, Ss, Se
        self.nreal, self.n_rows, self.W = bh * bw, n_rows, Se - Ss + 1
        self.device = plane.device

    def rows(self, lo: int, hi: int) -> torch.Tensor:
        """(hi - lo, W) int64 coefficients of the rows lo:hi."""
        bw = self.bw
        end = min(hi, self.nreal)
        r0 = lo // bw
        r1 = -(-end // bw) if end > lo else r0
        q = self.plane[r0:r1, :bw, self.Ss:self.Se + 1].to(torch.int64) \
            .reshape(-1, self.W)[lo - r0 * bw:end - r0 * bw]
        return torch.nn.functional.pad(q, (0, 0, 0, hi - lo - q.shape[0]))

    def spans(self, lanes_per_row: int):
        """[(lo, hi)] chunks of rows, sized to memory."""
        step = chunk_rows(self.device, lanes_per_row)
        return [(lo, min(lo + step, self.n_rows))
                for lo in range(0, self.n_rows, step)]


class AcFirst:
    """An AC-first scan (encode_mcu_AC_first) of one component's Band,
    point-transformed by Al, `restart` blocks a segment: the cross-block
    EOB runs from per-block summaries, then its gather-mode counts
    (hist) or its packed words (pack).

    Lanes per block: [EOB-run flush] + W x [ZRL x3, (run, size) + bits]
    + [forced 0x7FFF flush], and one per segment for its final run. The
    cross-block run is prefix sums: with C the running count of blocks
    that end in zeros and D = C - e, the run flushed before a block with
    a symbol is D minus D at the previous such block (mod 32767 across
    the forced flushes, emit_eobrun)."""

    def __init__(self, band: Band, Al: int, restart: int):
        self.band, self.Al, self.restart = band, Al, restart
        n, W, dev = band.n_rows, band.W, band.device
        S = self.S = n // restart
        self.lanes_per_row = 4 * W + 2
        last_nz = torch.cat([self._syms(lo, hi)[2].amax(1)
                             for lo, hi in band.spans(W)])
        has_sym = last_nz > 0
        e = torch.where(torch.arange(n, device=dev) < band.nreal,
                        (last_nz < W).to(torch.int64), 0)
        e_seg = e.reshape(S, restart)
        hs = has_sym.reshape(S, restart)
        C = torch.cumsum(e_seg, 1)
        D = C - e_seg
        D_at_sym = torch.where(hs, D, 0)
        prev_D = (_prev_excl(torch.where(hs, D_at_sym + 1, 0), 1) - 1) \
            .clamp_min(0)
        pending = (D - prev_D) % 32767
        self.flush_run = torch.where(hs & (pending > 0), pending, 0) \
            .reshape(n)
        since = C - prev_D
        # a forced flush when the count since the last flush reaches 0x7FFF
        self.forced = ((e_seg > 0) & ~hs & (since > 0)
                       & (since % 32767 == 0)).reshape(n)
        last_D = torch.where(hs, D_at_sym, 0).amax(1)
        self.end_run = (C[:, -1] - last_D) % 32767

    def _syms(self, lo: int, hi: int):
        """(raw, |raw| >> Al, position + 1 where nonzero else 0, the zero
        run before each position) of the rows lo:hi."""
        raw = self.band.rows(lo, hi)
        a = raw.abs() >> self.Al
        k = torch.arange(raw.shape[1], device=raw.device)[None, :]
        marked = torch.where(a != 0, k + 1, 0)
        return raw, a, marked, k - _prev_excl(marked, 1)

    def hist(self) -> torch.Tensor:
        """(S, 256) int64 gather-mode counts: the (run, size) symbols,
        the ZRLs, the EOBn runs."""
        n, S, dev = self.band.n_rows, self.S, self.band.device
        h = torch.zeros(S * 256, dtype=torch.int64, device=dev)
        for lo, hi in self.band.spans(self.lanes_per_row):
            _, a, _, run = self._syms(lo, hi)
            nz = a != 0
            base = (torch.arange(lo, hi, device=dev)
                    // self.restart * 256)[:, None]
            _count(h, base + ((run & 15) << 4) + _nb(a), nz)
            h.scatter_add_(0, base[:, 0] + 0xF0,
                           torch.where(nz, run >> 4, 0).sum(1))
        seg = torch.arange(n, device=dev) // self.restart
        _run_hist(h, self.flush_run, seg)
        _run_hist(h, torch.where(self.forced, 32767, 0), seg)
        _run_hist(h, self.end_run, torch.arange(S, device=dev))
        return h.reshape(S, 256)

    def pack(self, ac_co, ac_si):
        """Tables (256,) or one a segment (S, 256) -> ((S, nwords) words,
        (S,) bits)."""
        band, restart = self.band, self.restart
        W, dev = band.W, band.device

        def lanes(lo, hi):
            raw, a, _, run = self._syms(lo, hi)
            seg = torch.arange(lo, hi, device=dev)[:, None] // restart
            nz = a != 0
            t2 = torch.where(raw < 0, ~a, a)
            anb = _nb(a)
            sym = ((run & 15) << 4) + anb
            sym_len = torch.where(nz, _look(ac_si, sym, seg) + anb, 0)
            sym_val = (_look(ac_co, sym, seg) << anb) \
                | (t2 & ((1 << anb) - 1))
            nzrl = run >> 4
            zrl_len = _look(ac_si, 0xF0, seg)
            zrl = [torch.where(nz & (nzrl >= i), zrl_len, 0)
                   for i in (1, 2, 3)]
            fr, sb = self.flush_run[lo:hi], seg[:, 0]
            f_val, f_len = _eob_lane(fr, fr > 0, ac_co, ac_si, sb)
            ff_val, ff_len = _eob_lane(torch.full_like(fr, 32767),
                                       self.forced[lo:hi], ac_co, ac_si, sb)
            zv = _look(ac_co, 0xF0, seg).expand_as(sym_val)
            R = hi - lo
            pos_vals = torch.stack([zv, zv, zv, sym_val], 2) \
                .reshape(R, W * 4)
            pos_lens = torch.stack(zrl + [sym_len], 2).reshape(R, W * 4)
            return (torch.cat([f_val[:, None], pos_vals, ff_val[:, None]], 1),
                    torch.cat([f_len[:, None], pos_lens, ff_len[:, None]], 1),
                    None)

        e_val, e_len = _eob_lane(self.end_run, self.end_run > 0, ac_co,
                                 ac_si, torch.arange(self.S, device=dev))
        return pack_rows(dev, band.n_rows, restart, self.lanes_per_row,
                         lanes, tail=(e_val[:, None], e_len[:, None]))


def encode_scan_progressive_device(planes, geoms, mcus_x: int, mcus_y: int,
                                   scan_Ss: int, scan_Se: int, scan_Ah: int,
                                   scan_Al: int, restart: int,
                                   dc_tables=None, ac_tables=None,
                                   rst_offset: int = 0,
                                   trailing_rst: bool = False) -> bytes:
    """Device packing of a progressive scan of any kind, at 8 or 12 bits:
    DC first, DC refine, AC first, AC refine. For DC scans planes/geoms
    cover the scan's components in MCU order; for AC scans (one
    component) pass its plane with geoms=[(1, 1)] and mcus_x/mcus_y =
    its real bw/bh."""
    pl = [as_dev(p) for p in planes]
    dev = pl[0].device
    num_mcus = mcus_x * mcus_y
    r = restart if restart > 0 else num_mcus
    n = -(-num_mcus // r) * r
    if scan_Ss == 0 and scan_Ah == 0:                 # DC first
        words, bits = _pack_dc_first(pl, _tables(dc_tables, dev), geoms,
                                     mcus_x, mcus_y, r, scan_Al)
    elif scan_Ss == 0:                                # DC refine
        words, bits = _pack_dc_refine(pl, geoms, mcus_x, mcus_y, r, scan_Al)
    else:
        band = Band(pl[0], mcus_y, mcus_x, scan_Ss, scan_Se, n)
        scan = (AcFirst(band, scan_Al, r) if scan_Ah == 0
                else AcRefine(band, scan_Al, r))
        words, bits = scan.pack(*_tables(ac_tables, dev)[0])
    return finish_segments(*fetch_trimmed(words, bits), restart > 0,
                           rst_offset, trailing_rst)


def refine_schedule(e: np.ndarray, br: np.ndarray, ev: np.ndarray,
                    restart: int):
    """The sequential (EOB run, buffered correction bits) flush schedule
    of an AC-refinement scan (native mj_ac_refine_schedule) from the
    per-block summaries (N_p,) int32: e (the block ends in an EOB), br
    (its correction bits after the EOB), ev (it emits a symbol).
    -> (flush_run, flush_be, forced_run, forced_be, attach_blk,
    attach_kind, attach_base) (N_p,) and (end_run, end_be) (S,), int32."""
    n = len(e)
    S = -(-n // restart)
    outs = [np.zeros(n, np.int32) for _ in range(7)] \
        + [np.zeros(S, np.int32) for _ in range(2)]
    args = [np.ascontiguousarray(a, np.int32) for a in (e, br, ev)]

    def ptr(a):
        return a.ctypes.data_as(native.i32p)

    native.lib().mj_ac_refine_schedule(*map(ptr, args), n, restart,
                                       *map(ptr, outs))
    return outs


def _gather_pad(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (N, W) with a zero column in front, gathered at idx (0 reads the
    zero, i >= 1 reads a[:, i - 1])."""
    return torch.cat([torch.zeros_like(a[:, :1]), a], 1).gather(1, idx)


def refine_syms(raw: torch.Tensor, Al: int, nreal: int) -> dict:
    """The per-position symbols of an AC-refinement scan
    (encode_mcu_AC_refine) of one component: raw (N, W) int64 band
    coefficients, the rows from `nreal` on padding -> a dict of (N, W)
    int64 tensors (newly, prevnz, zrl_ct, r_sym, the correction-bit
    buckets and event positions) and the per-block summaries e, br, ev
    of refine_schedule (int32, 0 on padding)."""
    N_p, W = raw.shape
    dev = raw.device
    absv = raw.abs() >> Al
    newly = absv == 1
    prevnz = absv > 1
    zero = absv == 0
    kk = torch.arange(W, device=dev)[None, :]
    newly_pos = torch.where(newly, kk + 1, 0)
    EOB = newly_pos.amax(1)
    le_eob = (kk + 1) <= EOB[:, None]

    zi = torch.cumsum(zero.long(), 1)
    zi_excl = zi - zero.long()
    ln = _prev_excl(newly_pos, 1)                     # last newly < k
    Zw = zi_excl - _gather_pad(zi_excl, ln)           # zeros in (ln, k)
    nz = ~zero
    pnz = _prev_excl(torch.where(nz, kk + 1, 0), 1)
    Zw_j = torch.where(pnz > ln, _gather_pad(Zw, pnz), 0)
    r_before = (Zw_j & 15) + (Zw - Zw_j)
    zrl_ct = torch.where(nz & le_eob, r_before >> 4, 0)

    is_event = (zrl_ct > 0) | newly
    ev_pos = torch.where(is_event, kk + 1, 0)
    prev_ev = _prev_excl(ev_pos, 1)
    pz = torch.cumsum(prevnz.long(), 1)
    pz_excl = pz - prevnz.long()
    # a bucket takes the prevnz bits in [prev_ev, k): a ZRL at a
    # previously-nonzero position buffers its own bit after its flush
    # (jcphuff.c:885-889)
    bkt_len = torch.where(is_event, pz_excl - _gather_pad(
        pz, (prev_ev - 1).clamp_min(0)), 0)
    big = W + 1
    evp = torch.where(is_event, kk + 1, big)
    sufmin = torch.flip(torch.cummin(torch.flip(evp, [1]), 1).values, [1])
    nxt_ev = torch.cat([sufmin[:, 1:], torch.full_like(sufmin[:, :1], big)],
                       1)                             # first event > k
    real = torch.arange(N_p, device=dev) < nreal
    br = (prevnz & (kk + 1 > EOB[:, None])).sum(1)
    e, br, ev = (torch.where(real, x, 0).int()
                 for x in (EOB < W, br, EOB > 0))
    return dict(newly=newly, prevnz=prevnz, sgn=(raw >= 0).long(),
                corr=absv & 1, zrl_ct=zrl_ct, r_sym=r_before & 15,
                bktA=torch.where(zrl_ct > 0, bkt_len, 0),
                bktB=torch.where(newly & (zrl_ct == 0), bkt_len, 0),
                prev_ev=prev_ev, pz=pz, pz_excl=pz_excl, nxt_ev=nxt_ev,
                last_ev=ev_pos.amax(1), e=e, br=br, ev=ev)


class AcRefine:
    """An AC-refinement scan (encode_mcu_AC_refine) of one component's
    Band at Al, `restart` blocks a segment: the per-block summaries down
    to the host, the native flush schedule (refine_schedule) back up,
    then its gather-mode counts (hist) or its packed words (pack). sched:
    the schedule, where the caller kept it from an earlier AcRefine of
    the same band.

    Lanes per block: [EOBn flush][its correction bits] + per position
    [ZRL][bits A][ZRL][ZRL][symbol + sign][bits B] + [forced EOBn]
    [its bits]; per segment [end EOBn][its bits]. The correction-bit
    lanes only reserve their length: each bit scatters on its own at the
    lane's offset plus its rank."""

    def __init__(self, band: Band, Al: int, restart: int, sched=None):
        self.band, self.Al, self.restart = band, Al, restart
        self.S = band.n_rows // restart
        self.lanes_per_row = 4 + 6 * band.W
        if sched is None:
            summ = {"e": [], "br": [], "ev": []}
            for lo, hi in band.spans(self.lanes_per_row):
                syms = self._syms(lo, hi)
                for k, v in summ.items():
                    v.append(syms[k])
            sched = [torch.as_tensor(x, device=band.device).to(torch.int64)
                     for x in refine_schedule(*(torch.cat(v).cpu().numpy()
                                                for v in summ.values()),
                                              restart)]
        self.sched = sched

    def _syms(self, lo: int, hi: int) -> dict:
        return refine_syms(self.band.rows(lo, hi), self.Al,
                           self.band.nreal - lo)

    def hist(self) -> torch.Tensor:
        """(S, 256) int64 gather-mode counts: the newly-nonzero symbols,
        the ZRLs, and the EOBn runs of the flush schedule."""
        n, S, dev = self.band.n_rows, self.S, self.band.device
        h = torch.zeros(S * 256, dtype=torch.int64, device=dev)
        for lo, hi in self.band.spans(self.lanes_per_row):
            syms = self._syms(lo, hi)
            newly = syms["newly"]
            base = (torch.arange(lo, hi, device=dev)
                    // self.restart * 256)[:, None]
            _count(h, base + (syms["r_sym"] << 4) + 1, newly)
            h.scatter_add_(0, base[:, 0] + 0xF0, syms["zrl_ct"].sum(1))
        seg = torch.arange(n, device=dev) // self.restart
        _run_hist(h, self.sched[0], seg)                 # flush
        _run_hist(h, self.sched[2], seg)                 # forced
        _run_hist(h, self.sched[7], torch.arange(S, device=dev))  # end
        return h.reshape(S, 256)

    def pack(self, ac_co, ac_si):
        """Tables (256,) or one a segment (S, 256) -> ((S, nwords) words,
        (S,) bits)."""
        (flush_run, flush_be, forced_run, forced_be, attach_blk,
         attach_kind, attach_base, end_run, end_be) = self.sched
        band, restart = self.band, self.restart
        n, W, dev = band.n_rows, band.W, band.device
        seg_all = torch.arange(n, device=dev) // restart
        f_len_all = _eob_lane(flush_run, flush_run > 0, ac_co, ac_si,
                              seg_all)[1]

        def lanes(lo, hi):
            syms = self._syms(lo, hi)
            R = hi - lo
            seg = seg_all[lo:hi, None]
            fr, fo = flush_run[lo:hi], forced_run[lo:hi]
            f_val, f_len = _eob_lane(fr, fr > 0, ac_co, ac_si, seg[:, 0])
            fo_val, fo_len = _eob_lane(fo, fo > 0, ac_co, ac_si, seg[:, 0])
            zrl_ct, newly = syms["zrl_ct"], syms["newly"]
            zrl_val = _look(ac_co, 0xF0, seg).expand(R, W)
            zrl_len = _look(ac_si, 0xF0, seg)
            z_lens = [torch.where(zrl_ct >= i, zrl_len, 0) for i in (1, 2, 3)]
            symv = (syms["r_sym"] << 4) + 1
            sym_val = (_look(ac_co, symv, seg) << 1) | syms["sgn"]
            sym_len = torch.where(newly, _look(ac_si, symv, seg) + 1, 0)
            zu = torch.zeros_like(sym_val)
            pos_vals = torch.stack([zrl_val, zu, zrl_val, zrl_val, sym_val,
                                    zu], 2).reshape(R, 6 * W)
            pos_lens = torch.stack([z_lens[0], syms["bktA"], z_lens[1],
                                    z_lens[2], sym_len, syms["bktB"]],
                                   2).reshape(R, 6 * W)
            z1 = torch.zeros_like(f_val)[:, None]
            vals = torch.cat([f_val[:, None], z1, pos_vals, fo_val[:, None],
                              z1], 1)
            lens = torch.cat([f_len[:, None], flush_be[lo:hi, None],
                              pos_lens, fo_len[:, None],
                              forced_be[lo:hi, None]], 1)
            return vals, lens, (lo, hi, syms)

        def corr_bits(ctx, off, placed):
            """The correction bits, each at its bucket lane's offset plus
            its rank; a bit still buffered at its block's end goes out
            after the flush that takes it (attach_kind 0: a later block's
            EOBn flush, lane 1; 1: a forced EOBn, the last lane; else the
            segment's end EOBn, tail lane 1)."""
            lo, hi, syms = ctx
            zrl_ct, prevnz = syms["zrl_ct"], syms["prevnz"]
            nxt_ev, pz, pz_excl = syms["nxt_ev"], syms["pz"], syms["pz_excl"]
            q0 = (nxt_ev - 1).clamp(0, W - 1)
            q_zrl = zrl_ct.gather(1, q0) > 0
            bucket_lane = 2 + 6 * q0 + torch.where(q_zrl, 1, 5)
            rank_local = pz_excl - _gather_pad(
                pz, (syms["prev_ev"].gather(1, q0) - 1).clamp_min(0))
            has_local = prevnz & (nxt_ev <= W)
            is_global = prevnz & (nxt_ev > W)
            rank_unflushed = pz_excl - _gather_pad(
                pz, (syms["last_ev"] - 1).clamp_min(0)[:, None])
            tgt = attach_blk[lo:hi].clamp(0, n - 1)
            ak = attach_kind[lo:hi]
            g_off = torch.where(
                ak == 0, placed.row_off[tgt] + f_len_all[tgt],
                torch.where(ak == 1, placed.row_off[tgt]
                            + placed.row_bits[tgt] - forced_be[tgt],
                            placed.tail_off[seg_all[lo:hi], 1]))
            base = torch.where(is_global, g_off[:, None],
                               off.gather(1, bucket_lane))
            rank = torch.where(is_global,
                               attach_base[lo:hi, None] + rank_unflushed,
                               rank_local)
            return (syms["corr"], (has_local | is_global).long(),
                    base + rank)

        e_val, e_len = _eob_lane(end_run, end_run > 0, ac_co, ac_si,
                                 torch.arange(self.S, device=dev))
        tail = (torch.stack([e_val, torch.zeros_like(e_val)], 1),
                torch.stack([e_len, end_be], 1))
        return pack_rows(dev, n, restart, self.lanes_per_row, lanes, tail,
                         corr_bits)


def ac_refine_eob_bins(e: np.ndarray, br: np.ndarray, ev: np.ndarray,
                       ri: int) -> np.ndarray:
    """EOBn symbol counts of an AC-refinement scan from its per-block
    (e, br, ev): every run the flush schedule emits, binned as
    (nbits(run) - 1) << 4 -> (256,) int64."""
    N = len(e)
    r = ri if ri > 0 else N
    N_p = -(-N // r) * r

    def pad(a):
        out = np.zeros(N_p, np.int32)
        out[:N] = a
        return out

    outs = refine_schedule(pad(e), pad(br), pad(ev), r)
    hist = np.zeros(256, np.int64)
    for runs in (outs[0], outs[2], outs[7]):          # flush, forced, end
        rv = runs[runs > 0].astype(np.int64)
        if rv.size:
            np.add.at(hist, (np.floor(np.log2(rv)).astype(np.int64)) << 4,
                      1)
    return hist
