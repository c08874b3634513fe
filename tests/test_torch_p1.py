"""p1's islow path (ops/p1.py) on the CPU.

The plain route through pipeline_t (p1_batch_pre and _p1_planes, which
take ops/p1.p1_islow for islow) against the JAX package's _p1_batch_pre,
bit for bit: q_zz, raw_zz and the sidecar of norms and AC-first
histograms, at 8 and 12 bits, deringing on and off, B = 1 and 3, restart
intervals 0, 1, 5, n - 1, n and n + 3 (spread over the components), on
the unaligned 27x42 4:2:0 geometry of test_torch_encode_ops.py's
device-prep p1 and an unaligned 139x75 gray plane, the planes seeded by ops/p1.example_plane (deringing's
edge cases, flat runs) and read as views of one host-prep buffer.

The reciprocal quantizer against floor division at every quant value
1..65535 and the numerators where it could fail, and its s < 0 branch
against the plain quantizer; the mask-derived symbols against
symbols.within_block_hist on zero runs at each multiple of 16 and beside
it, a nonzero only at 63, all zero and all nonzero blocks.

Then numpy models of the two CUDA kernels of csrc/p1.cu, each following
its kernel's order of work, against the same JAX outputs: the kernels
cannot run without a card, so these models are the CPU check of their
algorithm.

  blocks model: every block at once in the kernel's order of work
  (eight lanes a block): sample rows centered, deringing's clipped count
  over the block and the run walk in zigzag order over the block's
  buffer, rewriting it as it goes, the row and column passes of the islow
  FDCT in wrapping int32, quantization by the reciprocal (floor(s / d)
  as the high 64 bits of s * ceil(2^64 / d), the s < 0 branch's
  division), the post-dering clamp on the int16 value, the within-block
  symbols and the flag byte from each block's 64-bit nonzero mask, and
  the norm as a serial f32 sum in natural order (a lane a block).
  EOB model: fixed tiles of 256 blocks of an image, one warp a tile,
  walking its flag bytes 32 at a time: the ballots of "nonzero",
  "trailing zero" and "segment start"; each nonzero block's run from the
  highest event below it in the chunk (a segment start cuts the run) or
  the carried run, each segment start's final run of the segment before;
  the tile's first event leaves its head run to the combine, and the
  tile's summary is (head, the run open at its end); then the last
  CTA's combine, 256 tiles at a time: a scan of the associative (has an
  event, open run) operator as warp shfl_up scans and a warps' prefix,
  each event tile's head run, the image's final run, and the 0x7FFF
  split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mozjpeg_tpu.codec import pipeline_t as jpt
from mozjpeg_tpu.codec.config import EncoderConfig as JCfg
from mozjpeg_tpu.codec.encoder import make_qtables
from mozjpeg_tpu.ops import symbols as jsymbols
from mozjpeg_tpu_torch.codec import pipeline_t as tpt
from mozjpeg_tpu_torch.codec.pipeline import geometry
from mozjpeg_tpu_torch.consts import JPEG_ZIGZAG
from mozjpeg_tpu_torch.ops import p1 as tp1
from mozjpeg_tpu_torch.ops import quant
from mozjpeg_tpu_torch.ops import symbols as tsymbols

F32 = np.float32
H, W = 27, 42                       # test_torch_encode_ops' device-prep p1
SAMP = [(2, 2), (1, 1), (1, 1)]
_, _, COMPS = geometry(W, H, SAMP)
NY = COMPS[0].bh * COMPS[0].bw      # 24 luma blocks an image
NC = COMPS[1].bh * COMPS[1].bw      # 6 chroma blocks
# one plane alone (a cheaper JAX compile), 139x75 grayscale: 180 blocks, so
# that one segment crosses several of the EOB walk's 32-block chunks
_, _, GRAY = geometry(139, 75, [(1, 1)])
NG = GRAY[0].bh * GRAY[0].bw

# (name, precision, B, deringing, quality, components, restart interval
# per component)
CASES = [
    ("8bit-B3-dering", 8, 3, True, 75, COMPS, (5, 1, NC + 3)),
    ("8bit-B1-plain-gray", 8, 1, False, 50, GRAY, (0,)),
    ("12bit-B1-dering-gray-q100", 12, 1, True, 100, GRAY, (NG - 1,)),
    ("12bit-B3-plain", 12, 3, False, 90, COMPS, (NY, NC - 1, NC)),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _bufs(precision, b, seed, comps):
    """(B, total) host-prep buffers [Y | Cb | Cr] of example planes."""
    parts = [tp1.example_plane(b, g.bh_pad, g.bw_pad, precision,
                               seed + ci).reshape(b, -1)
             for ci, g in enumerate(comps)]
    return np.concatenate(parts, 1)


@pytest.fixture(scope="module")
def jax_p1():
    """Each case through the JAX _p1_batch_pre: name -> (case, bufs,
    qtables per component, [(q_zz, raw_zz)], smalls)."""
    out = {}
    for i, case in enumerate(CASES):
        name, precision, b, dering_on, quality, comps, ris = case
        bufs = _bufs(precision, b, 10 * i, comps)
        qt = make_qtables(JCfg(quality=quality).resolved())
        cqt = [np.asarray(qt[min(s, len(qt) - 1)])
               for s in (0, 1, 1)[:len(ris)]]
        merged, small = jpt._p1_batch_pre(
            jnp.asarray(bufs), tuple(comps), dering_on, precision, ris,
            "islow", qts81=tuple(jpt._dev_qtbl(q) for q in cqt), dts81=None)
        out[name] = (case, bufs, qt, cqt,
                     [(np.asarray(q), np.asarray(r)) for q, r in merged],
                     np.asarray(small))
    return out


def _planes(bufs_t, comps):
    b = bufs_t.shape[0]
    planes, off = [], 0
    for g in comps:
        size = g.bh_pad * 8 * g.bw_pad * 8
        planes.append(bufs_t[:, off:off + size].reshape(b, g.bh_pad * 8,
                                                        g.bw_pad * 8))
        off += size
    return planes


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_plain_route_matches_jax_p1(jax_p1, name):
    """pipeline_t's p1 on the CPU (ops/p1's plain route, the planes as
    views of the buffer) equals the JAX _p1_batch_pre bit for bit, and
    launches nothing."""
    case, bufs, qt, cqt, merged_j, small_j = jax_p1[name]
    _, precision, b, dering_on, _, comps, ris = case
    before = (tp1.p1_blocks.launches, tp1.p1_eob_hist.launches)
    if precision == 8:
        merged, small, norms = tpt.p1_batch_pre(
            _t(bufs), tuple(comps), qt, dering_on, "islow", ris)
    else:
        merged, small, norms = tpt._p1_planes(
            _planes(_t(bufs), comps), comps, cqt, dering_on, "islow", ris,
            precision)
    assert (tp1.p1_blocks.launches, tp1.p1_eob_hist.launches) == before
    for (q, r), (qj, rj) in zip(merged, merged_j):
        _eq(q, qj)
        _eq(r, rj)
    _eq(small, small_j)
    assert [n.shape[0] for n in norms] == [b * g.bh * g.bw for g in comps]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    plane = torch.zeros((1, 16, 16), dtype=torch.uint8)
    q = np.ones(64, np.int32)
    with pytest.raises(ValueError):
        tp1.p1_blocks(plane.to(torch.int16), 2, 2, q, True)
    with pytest.raises(ValueError):
        tp1.p1_blocks(plane, 3, 2, q, True)             # past the plane
    with pytest.raises(ValueError):
        tp1.p1_blocks(plane, 2, 2, q, True, precision=16)
    with pytest.raises(ValueError):
        tp1.p1_blocks(plane, 2, 2, np.zeros(64, np.int32), True)
    flags = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tp1.p1_eob_hist(flags, torch.zeros((3, 256), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        tp1.p1_eob_hist(flags, torch.zeros((2, 256), dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        tp1.p1_blocks(plane.to("meta"), 2, 2, q, True)


# ---------------------------------------------------------------------------
# numpy models of the kernels
# ---------------------------------------------------------------------------

ZZ = np.asarray(JPEG_ZIGZAG)        # natural index of zigzag position k
MAXS = 127


def _dering(zz, q0):
    """The kernel's run walk on zz (64 ints, zigzag), in place."""
    m = 0
    for k in range(64):
        m |= int(zz[k] >= MAXS) << k
    cnt = bin(m).count("1")
    if cnt in (0, 64):
        return
    total = sum(zz)
    num = MAXS * 64 - total
    headroom = abs(num) // cnt * (1 if num >= 0 else -1)   # trunc
    maxover = MAXS + min(headroom, min(31, 2 * q0))
    rem = m
    while rem:
        a = (rem & -rem).bit_length() - 1
        opn = (~m & ((1 << 64) - 1)) >> a
        b = a + (opn & -opn).bit_length() - 1 if opn else 64
        rem = 0 if b >= 64 else rem & ~((1 << b) - 1)
        f1 = zz[a - 1] if a > 0 else zz[0]
        f2 = zz[a - 2] if a >= 2 else zz[0]
        l1 = zz[b] if b < 64 else zz[63]
        l2 = zz[b + 1] if b + 1 < 64 else zz[63]
        fslope = max(f1 - f2, MAXS - f1)
        lslope = max(l1 - l2, MAXS - l1)
        if a == 0:
            fslope = lslope
        if b == 64:
            lslope = fslope
        length = b - a
        step = F32(1) / F32(length + 1)
        tan1, tan2 = F32(fslope * length), F32(-lslope * length)
        t = F32(0)
        for i in range(a, b):
            t = step if i == a else F32(t + step)
            t2 = F32(t * t)
            t3 = F32(t2 * t)
            cf1 = F32(F32(F32(F32(2) * t3) - F32(F32(3) * t2)) + F32(1))
            cf2 = F32(F32(F32(-2) * t3) + F32(F32(3) * t2))
            cf3 = F32(F32(t3 - F32(F32(2) * t2)) + t)
            cf4 = F32(t3 - t2)
            val = F32(F32(F32(F32(F32(127) * cf1) + F32(tan1 * cf3))
                          + F32(F32(127) * cf2)) + F32(tan2 * cf4))
            zz[i] = min(int(np.ceil(val)), maxover)


def w32(x):
    """int32 two's complement wrap of an int64 array (or a Python int)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _descale(x, n):
    return w32(x + (1 << (n - 1))) >> n


def _fdct_1d(d, shift_even, n):
    """fdct_1d on int64 arrays d[0..7] (each any shape), wrapping int32."""
    tmp0, tmp7 = w32(d[0] + d[7]), w32(d[0] - d[7])
    tmp1, tmp6 = w32(d[1] + d[6]), w32(d[1] - d[6])
    tmp2, tmp5 = w32(d[2] + d[5]), w32(d[2] - d[5])
    tmp3, tmp4 = w32(d[3] + d[4]), w32(d[3] - d[4])
    tmp10, tmp13 = w32(tmp0 + tmp3), w32(tmp0 - tmp3)
    tmp11, tmp12 = w32(tmp1 + tmp2), w32(tmp1 - tmp2)
    o = [None] * 8
    if shift_even >= 0:
        o[0] = w32((tmp10 + tmp11) << shift_even)
        o[4] = w32((tmp10 - tmp11) << shift_even)
    else:
        o[0] = _descale(tmp10 + tmp11, -shift_even)
        o[4] = _descale(tmp10 - tmp11, -shift_even)
    z1 = w32(w32(tmp12 + tmp13) * 4433)
    o[2] = _descale(z1 + w32(tmp13 * 6270), n)
    o[6] = _descale(z1 + w32(tmp12 * -15137), n)
    z1, z2 = w32(tmp4 + tmp7), w32(tmp5 + tmp6)
    z3, z4 = w32(tmp4 + tmp6), w32(tmp5 + tmp7)
    z5 = w32(w32(z3 + z4) * 9633)
    t4, t5 = w32(tmp4 * 2446), w32(tmp5 * 16819)
    t6, t7 = w32(tmp6 * 25172), w32(tmp7 * 12299)
    z1, z2 = w32(z1 * -7373), w32(z2 * -20995)
    z3, z4 = w32(w32(z3 * -16069) + z5), w32(w32(z4 * -3196) + z5)
    o[7] = _descale(w32(t4 + z1) + z3, n)
    o[5] = _descale(w32(t5 + z2) + z4, n)
    o[3] = _descale(w32(t6 + z2) + z3, n)
    o[1] = _descale(w32(t7 + z1) + z4, n)
    return o


U64 = np.uint64


def recip(d):
    """The kernel's reciprocal of each divisor d >= 2: ceil(2^64 / d) as
    uint64, computed as (2^64 - 1) // d + 1."""
    return U64(0xFFFFFFFFFFFFFFFF) // np.asarray(d, U64) + U64(1)


def umulhi(s, m):
    """__umul64hi(s, m) for 0 <= s < 2^32: the high 64 bits of the
    128-bit product, from m's 32-bit halves (each partial product stays
    under 2^64)."""
    s, m = np.asarray(s, U64), np.asarray(m, U64)
    lo = s * (m & U64(0xFFFFFFFF))
    return (s * (m >> U64(32)) + (lo >> U64(32))) >> U64(32)


def quantize_model(c, d, m):
    """The kernel's quantizer on int64 arrays: c the raw coefficients, d
    = 8q, m = recip(d) -> the int16 value before the post-dering clamp.
    s = |c| + d/2 in wrapping int32; s >= 0: umulhi(s, m); s < 0: C's
    truncating division, then the floor fix."""
    a = np.where(c < 0, w32(-c), c)
    s = w32(a + (d >> 1))
    pos = s >= 0
    mag_pos = umulhi(np.where(pos, s, 0), m).astype(np.int64)
    trunc = np.where(pos, 0, -(np.abs(s) // d))       # s < 0: toward zero
    mag_neg = trunc - ((~pos) & (trunc * d != s))
    mag = np.where(pos, mag_pos, mag_neg)
    v = w32(np.where(c < 0, -mag, mag))
    return ((v + 32768) & 0xFFFF) - 32768             # to int16


def hibit64(x):
    """The highest set bit of each uint64 of x (63 - __clzll), -1 for 0."""
    x = np.asarray(x, U64)
    out = np.full(x.shape, -1, np.int64)
    nz = x != 0
    pos = np.zeros(x.shape, np.int64)
    y = x.copy()
    for sh in (32, 16, 8, 4, 2, 1):
        big = y >= (U64(1) << U64(sh))
        pos = np.where(big, pos + sh, pos)
        y = np.where(big, y >> U64(sh), y)
    return np.where(nz, pos, out)


def clz64(x):
    """Leading zeros of each uint64 of x (__clzll), 64 for 0."""
    return 63 - hibit64(x)


def mask_symbols(q):
    """The kernel's within-block symbols from each block's nonzero mask:
    q (..., 64) int zigzag-ordered quantized values -> (sym (..., 64),
    -1 where no symbol; zrl (...,)). With a sentinel at bit 0, a nonzero
    at zigzag k >= 1 has run clz64(mask << (64 - k)) = k - 1 - (its
    highest nonzero in [1, k - 1], or 0)."""
    nz = q != 0
    m = (nz.astype(U64) << np.arange(64, dtype=U64)).sum(-1, dtype=U64)
    ms = m | U64(1)
    sym = np.full(q.shape, -1, np.int64)
    zrl = np.zeros(q.shape[:-1], np.int64)
    mg = np.abs(q.astype(np.int64))
    nb = np.frexp(mg.astype(np.float64))[1]
    for k in range(1, 64):
        run = clz64(ms << U64(64 - k))
        on = nz[..., k]
        sym[..., k] = np.where(on, ((run & 15) << 4) | nb[..., k], -1)
        zrl += np.where(on, run >> 4, 0)
    return sym, zrl


def model_blocks(plane, bh, bw, qtbl, dering_on, precision):
    """p1_blocks_kernel's order of work, every block of plane (B, >= bh*8,
    >= bw*8) at once -> (q_zz (64, N) int16, raw_zz (64, N) int32, norm
    (N,) f32, hist (B, 256), flags (N,) uint8):
      1. lane r's sample row r, centered; with deringing the lanes' clipped
         counts and sums reduced over the block, and the run walk (lane 0)
         on the blocks with 0 < cnt < 64, in zigzag order over the block's
         buffer;
      2. the row pass on the lanes, the transpose through the buffer, the
         column pass;
      3. lane c quantizes natural index 8y + c by the reciprocal (d = 8q,
         umulhi(|c| + d/2, ceil(2^64 / d)), the s < 0 branch's division),
         the int16 value, the post-dering clamp;
      4. the nonzero mask (the OR of the lanes' bits at their zigzag
         positions), each nonzero's symbol and ZRLs from it (with a
         sentinel at bit 0, the run before zigzag k is the count of
         leading zeros of the mask shifted left by 64 - k), the flag byte
         from the mask;
      5. the norm: lane g of warp 0 sums block g's squares from the staged
         raw values in natural order 1..63.
    The histogram adds count each (warp instruction, bin) once with its
    popcount, the same sum as a count a symbol."""
    plane = np.asarray(plane)
    b = plane.shape[0]
    n = bh * bw
    q = np.asarray(qtbl).reshape(64).astype(np.int64)
    center = 1 << (precision - 1)
    pass1 = 2 if precision == 8 else 1
    maxc = (1 << (precision + 2)) - 1
    # (N, lane r, x): sample row r of each block
    v = plane[:, :bh * 8, :bw * 8].astype(np.int64).reshape(
        b, bh, 8, bw, 8).transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8)
    v = w32(v - center)
    if dering_on:
        cnt = (v >= MAXS).sum((1, 2))
        for i in np.nonzero((cnt > 0) & (cnt < 64))[0]:
            zz = [int(x) for x in v[i].reshape(64)[ZZ]]
            _dering(zz, int(q[0]))
            flat = v[i].reshape(64)
            flat[ZZ] = zz
            v[i] = flat.reshape(8, 8)
    rows = _fdct_1d([v[:, :, x] for x in range(8)], pass1, 13 - pass1)
    rows = np.stack(rows, -1)                       # (N, r, x) after pass 1
    cols = _fdct_1d([rows[:, y, :] for y in range(8)], -pass1,
                      13 + pass1)
    coef = np.stack(cols, 1)                        # (N, y, c) natural
    raw = coef.reshape(-1, 64)                      # natural index 8y + c
    d = q << 3
    qv = quantize_model(raw, d[None, :], recip(d)[None, :])
    if dering_on:
        qv = np.clip(qv, -maxc, maxc)
    q_zz = qv[:, ZZ].T.astype(np.int16)
    raw_zz = raw[:, ZZ].T.astype(np.int32)
    rf = raw.astype(F32)
    sq = rf * rf
    norm = np.zeros(b * n, F32)
    for k in range(1, 64):
        norm = norm + sq[:, k]
    sym, zrl = mask_symbols(q_zz.T.astype(np.int64))
    hist = np.zeros((b, 256), np.int64)
    img = np.repeat(np.arange(b), n)
    on = sym >= 0
    np.add.at(hist, (np.broadcast_to(img[:, None], sym.shape)[on],
                     sym[on]), 1)
    np.add.at(hist[:, 0xF0], img, zrl)
    nzm = q_zz != 0
    flags = (nzm[1:].any(0).astype(np.uint8)
             | ((~nzm[63]).astype(np.uint8) << 1))
    return q_zz, raw_zz, norm, hist, flags


EOB_TILE = 256     # blocks a warp of the EOB kernel walks (csrc/p1.cu)
EOB_WARPS = 8      # tiles a CTA, and the combine's warps
LANES = np.arange(32)


def _emit(counts, runs):
    """emit_run for each of runs: run // 0x7FFF forced EOB14 symbols,
    then EOBn for a remainder above 0."""
    runs = np.asarray(runs, np.int64).ravel()
    counts[14] += int((runs // 0x7FFF).sum())
    r = runs % 0x7FFF
    r = r[r > 0]
    np.add.at(counts, np.frexp(r.astype(np.float64))[1] - 1, 1)


def _hi_below(m, incl):
    """31 - clz of each lane's ballot of m (T, 32) masked to the lanes
    below it (and itself with incl): the highest such lane, else -1."""
    acc = np.maximum.accumulate(np.where(m, LANES, -1), axis=1)
    if incl:
        return acc
    return np.concatenate([np.full((m.shape[0], 1), -1), acc[:, :-1]], 1)


def _run_below(p, q, tr, at):
    """run_below: the run open just before lane `at` from the highest
    nonzero block p and segment start q below it, -1 if neither."""
    trp = np.take_along_axis(tr, np.maximum(p, 0), 1)
    return np.where(q > p, at - q, np.where(p >= 0, at - p - 1 + trp, -1))


def _up(x, off):
    """__shfl_up_sync over the warps' lanes (W, 32): lane i reads lane
    i - off (the lanes below off keep their own value)."""
    return np.concatenate([x[:, :off], x[:, :-off]], 1)


def model_eob(flags, hist, batch, ri, warps=EOB_WARPS):
    """p1_eob_hist_kernel: every tile of EOB_TILE blocks of an image side
    by side (a warp each), 32 flag bytes a chunk: the ballots of
    "nonzero", "trailing zero" and "segment start"; each nonzero block's
    run from the highest event below it in the chunk or the carried run,
    each segment start's final run of the segment before; the tile's
    first event leaves its head (the blocks from the tile's start) to
    the combine; the carry after each chunk. Then the last CTA's combine
    of the image's (head, carry) summaries, EOB_WARPS * 32 tiles at a
    time: the warps' inclusive shfl_up scans of (has an event, open
    run), the lanes' exclusive prefix, the warps' prefix, each event
    tile's head run and the image's final run. -> hist with the runs
    added. `warps` other than the kernel's EOB_WARPS narrows the
    combine's blocks, so that short images cross several."""
    hist = np.array(hist, np.int64)
    n = flags.size // batch
    if ri <= 0 or ri > n:
        ri = n
    tiles = -(-n // EOB_TILE)
    t0 = np.arange(tiles) * EOB_TILE
    tn = np.minimum(EOB_TILE, n - t0)
    rows = np.arange(tiles)
    for img in range(batch):
        counts = np.zeros(15, np.int64)
        f = np.zeros(tiles * EOB_TILE, np.int64)
        f[:n] = flags[img * n:(img + 1) * n]
        fl = f.reshape(tiles, EOB_TILE // 32, 32)
        seen = np.zeros(tiles, bool)
        carry = np.zeros(tiles, np.int64)
        head = np.full(tiles, -1, np.int64)
        for u in range(EOB_TILE // 32):
            base = u * 32
            act = base < tn                     # the others have left
            cnt = np.clip(tn - base, 0, 32)
            pos = t0[:, None] + base + LANES
            nz = (fl[:, u] & 1) != 0
            tr = (fl[:, u] >> 1) & 1
            ss = (LANES < cnt[:, None]) & (pos % ri == 0)
            p = _hi_below(nz, False)
            hv = np.full((tiles, 32), -1, np.int64)
            for at_ev, q in ((nz, _hi_below(ss, True)),
                             (ss, _hi_below(ss, False))):
                run = _run_below(p, q, tr, LANES)
                first = at_ev & (run < 0)
                run = np.where(first, carry[:, None] + LANES, run)
                hd = first & ~seen[:, None]
                hv = np.where(hd, run, hv)
                run = np.where(hd, 0, run)
                _emit(counts, run[at_ev & (run > 0)])
            ev = act & (nz | ss).any(1)
            new = ev & ~seen
            head = np.where(new, hv[rows, np.argmax(hv >= 0, 1)], head)
            seen |= ev
            pm, qm = _hi_below(nz, True)[:, -1], _hi_below(ss, True)[:, -1]
            trp = tr[rows, np.maximum(pm, 0)]
            carry = np.where(ev, np.where(qm > pm, cnt - qm,
                                          cnt - 1 - pm + trp),
                             np.where(act, carry + cnt, carry))
        # the combine
        R = 0
        width = warps * 32
        for base in range(0, tiles, width):
            k = min(width, tiles - base)
            hs = np.full(width, -1, np.int64)
            vs = np.zeros(width, np.int64)
            hs[:k], vs[:k] = head[base:base + k], carry[base:base + k]
            E, V = (hs >= 0).astype(np.int64).reshape(warps, 32), \
                vs.reshape(warps, 32)
            for off in (1, 2, 4, 8, 16):
                oe, ov = _up(E, off), _up(V, off)
                on = LANES >= off
                V = np.where(on & (E == 0), V + ov, V)
                E = np.where(on, E | oe, E)
            xe = np.where(LANES == 0, 0, _up(E, 1))
            xv = np.where(LANES == 0, 0, _up(V, 1))
            pe = pv = 0
            for w in range(warps):
                ce = pe | xe[w]
                cv = np.where(xe[w] != 0, xv[w], pv + xv[w])
                rj = np.where(ce != 0, cv, R + cv)
                h = hs.reshape(warps, 32)[w]
                _emit(counts, (rj + h)[h >= 0])
                if E[w, 31]:
                    pe, pv = 1, int(V[w, 31])
                else:
                    pv += int(V[w, 31])
            R = pv if pe else R + pv
        _emit(counts, [R])
        hist[img, 0:0xF0:16] += counts
    return hist


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_kernel_models_match_jax_p1(jax_p1, name):
    """The two kernels' models, chained as p1_islow chains the kernels,
    give the JAX q_zz, raw_zz, norms and histograms of every component,
    and their flags and histograms equal the plain versions'."""
    case, bufs, qt, cqt, merged_j, small_j = jax_p1[name]
    _, precision, b, dering_on, _, comps, ris = case
    planes = [p.numpy() for p in _planes(_t(bufs), comps)]
    norms, hists = [], []
    for ci, g in enumerate(comps):
        q_zz, raw_zz, norm, hist, flags = model_blocks(
            planes[ci], g.bh, g.bw, cqt[ci], dering_on, precision)
        _eq(q_zz, merged_j[ci][0])
        _eq(raw_zz, merged_j[ci][1])
        pq, _, _, phist, pflags = tp1.p1_blocks_plain(
            _t(planes[ci]), g.bh, g.bw, cqt[ci], dering_on, precision)
        _eq(flags, pflags)
        _eq(hist.astype(np.int32), phist)
        hist = model_eob(flags, hist, b, ris[ci])
        _eq(hist.astype(np.int32), tp1.p1_eob_hist_plain(
            _t(flags), phist.clone(), b, ris[ci]))
        norms.append(norm.reshape(b, -1).view(np.int32))
        hists.append(hist.astype(np.int32))
    _eq(np.concatenate(norms + hists, 1).reshape(-1), small_j)


Q_ALL = np.arange(1, 65536, dtype=np.int64)      # every quant value


def test_reciprocal_quantizer_every_q():
    """floor(s / d) = umulhi(s, ceil(2^64 / d)) for d = 8q, q = 1..65535,
    at s = 0, 1, d - 1, d, d + 1, kd - 1 and kd (k the largest multiple
    under 2^31, and a seeded one), 2^31 - 1, and |c| + 4q at the FDCT's
    largest |c|, 2^30 (the 12-bit DC's column sum wrapped to INT_MIN
    and descaled by one bit)."""
    d = Q_ALL << 3
    m = recip(d)
    kmax = (2 ** 31 - 1) // d
    k = np.random.default_rng(0).integers(1, kmax + 1)
    nums = [np.zeros_like(d), np.ones_like(d), d - 1, d, d + 1,
            kmax * d - 1, kmax * d, k * d - 1, k * d,
            np.full_like(d, 2 ** 31 - 1), (1 << 30) + (d >> 1)]
    for s in nums:
        assert s.min() >= 0 and s.max() < 2 ** 31
        np.testing.assert_array_equal(umulhi(s, m).astype(np.int64),
                                      s // d)


def test_quantizer_model_matches_plain_at_the_extremes():
    """The kernel's quantizer (both branches: s < 0 where |c| + 4q wraps
    int32, C division with the floor fix) against the plain quantizer
    (ops/quant.quantize_islow_t) at c = INT_MIN, -2^30, values beside
    2^31 - 4q, zero and small values, for quant values 1, 7, 4096 and
    65535."""
    big = 2 ** 31
    for q in (1, 7, 4096, 65535):
        d = q << 3
        c = np.resize(np.array([
            -big, -big + 1, -(1 << 30), (1 << 30), big - 1, big - 1 - 4 * q,
            big - 4 * q, -(big - 4 * q), -(big - 4 * q) - 1, 0, 1, -1,
            4 * q, -4 * q, d, -d, 4 * q - 1, -(4 * q - 1)], np.int64), 128)
        plain = quant.quantize_islow_t(
            torch.from_numpy(c.astype(np.int32).reshape(8, 8, -1)),
            torch.full((8, 8, 1), q, dtype=torch.int32)).numpy()
        got = quantize_model(c, np.int64(d), recip(np.int64(d)))
        np.testing.assert_array_equal(got, plain.reshape(-1))
        a = np.where(c < 0, w32(-c), c)
        assert (w32(a + 4 * q) < 0).any()         # the s < 0 branch ran


def _symbol_blocks():
    """(n, 64) int16 zigzag blocks: zero runs of 15, 16, 31, 32, 47, 48
    and 62 between nonzeros (starting after the DC and after a nonzero at
    1), a nonzero only at 63, all zero, all nonzero, magnitudes up to
    32767 and -32768, and seeded sparse blocks."""
    rng = np.random.default_rng(4)
    out = []
    for run in (15, 16, 31, 32, 47, 48, 62):
        for start in (1, 2):
            q = np.zeros(64, np.int64)
            if start == 2:
                q[1] = 3
            if start + run < 64:
                q[start + run] = -5
            if start + run + 1 < 64:
                q[63] = 1
            out.append(q)
    q = np.zeros(64, np.int64)
    q[63] = -2
    out += [q, np.zeros(64, np.int64), rng.integers(1, 4, 64)]
    q = rng.integers(-1000, 1000, 64)
    q[5], q[9] = 32767, -32768
    out.append(q)
    for _ in range(40):
        q = np.where(rng.random(64) < 0.15, rng.integers(-300, 300, 64), 0)
        out.append(q)
    return np.stack(out).astype(np.int16)


def test_mask_symbols_match_within_block_hist():
    """Each block's symbols from its 64-bit nonzero mask (the run as the
    leading zeros of the mask, with a sentinel at bit 0, shifted left by
    64 - k; ZRLs run >> 4) give symbols.within_block_hist's counts, block
    by block."""
    blocks = _symbol_blocks()
    sym, zrl = mask_symbols(blocks.astype(np.int64))
    for i, q in enumerate(blocks):
        h = np.zeros(256, np.int64)
        np.add.at(h, sym[i][sym[i] >= 0], 1)
        h[0xF0] += zrl[i]
        want = tsymbols.within_block_hist(
            torch.from_numpy(q[1:].astype(np.int32)).reshape(63, 1, 1))
        np.testing.assert_array_equal(h, want.numpy()[0])


@pytest.mark.parametrize("kind,precision,dering_on", [
    ("wrap", 8, False), ("wrap", 12, False), ("clipped", 8, True),
    ("clipped", 12, True), ("clipped", 12, False)])
def test_blocks_model_on_adversarial_planes_matches_plain(kind, precision,
                                                          dering_on):
    """The blocks model against the plain version on ops/p1's adversarial
    planes: int32 samples whose FDCT wraps (the DC at -2^30), and
    all-clipped, half-clipped and top-half-clipped blocks, at quant
    values 1 and 65535 and a ramp."""
    plane = tp1.adversarial_plane(kind, 2, 3, 5, precision, 8)
    for qt in (np.ones(64, np.int32), np.full(64, 65535, np.int32),
               np.arange(1, 65, dtype=np.int32)):
        got = model_blocks(plane, 3, 5, qt, dering_on, precision)
        want = tp1.p1_blocks_plain(_t(plane), 3, 5, qt, dering_on,
                                   precision)
        for g, w in zip(got, want):
            _eq(np.asarray(g).astype(w.numpy().dtype), w)


def _flags_from(q_zz, batch):
    band = torch.from_numpy(q_zz[1:])
    nz = band != 0
    return (nz.any(0).to(torch.uint8)
            | ((~nz[-1]).to(torch.uint8) << 1)).numpy()


def _runs_q_zz(n, seed, zero_runs=(1, 200)):
    """(64, n) int16 blocks: runs of all-zero blocks of zero_runs lengths
    between nonzero blocks with and without a nonzero coefficient 63."""
    rng = np.random.default_rng(seed)
    q = np.zeros((64, n), np.int16)
    i = int(rng.integers(0, 40))
    while i < n:
        q[int(rng.integers(1, 64)), i] = rng.choice([-3, 1, 2, 700])
        if rng.random() < 0.4:
            q[63, i] = 1
        i += 1 + int(rng.integers(*zero_runs))
    return q


N_LONG = 0x7FFF + 5000     # one image's blocks in the EOB walk's tests


@pytest.fixture(scope="module")
def long_runs():
    """Three images of N_LONG blocks, (64, 3 * N_LONG) int16: zero runs of
    1 to 199 blocks across several 32-block chunks in image 0; in image 1
    one nonzero block early and one late without trailing zeros, a run
    past 0x7FFF between them; image 2 all zero. Their flags and
    within-block histograms."""
    q = np.zeros((64, 3 * N_LONG), np.int16)
    q[:, :N_LONG] = _runs_q_zz(N_LONG, 70)
    q[5, N_LONG + 3] = 4
    q[63, N_LONG + 3 + 0x7FFF + 10] = -1
    return _flags_from(q, 3), tp1.block_symbols_plain(_t(q), 3)[0]


@pytest.mark.parametrize("ri", [0, 7, 31, 32, 33, 100, 0x7FFF, N_LONG - 1,
                                N_LONG, N_LONG + 3])
def test_eob_model_across_chunks_and_past_0x7fff(long_runs, ri):
    """The chunked walk against the plain version (held against the JAX
    package's histograms above and in test_torch_encode_ops.py) at each
    restart interval: runs that cross several chunks, segments past
    0x7FFF blocks with the forced EOB14 flush, segments with no nonzero
    block."""
    flags, within = long_runs
    got = model_eob(flags, within.numpy(), 3, ri)
    _eq(got.astype(np.int32),
        tp1.p1_eob_hist_plain(_t(flags), within.clone(), 3, ri))
    if ri == 0 or ri >= N_LONG - 1:
        assert got[1, 0xE0] == got[2, 0xE0] == 1   # the forced flush


N_EDGE = tp1.EDGE_N     # one image's blocks in the tile-edge cases


def _q_zz_of(flags):
    """(64, n) int16 coefficients whose flag bytes over the band [62, 63]
    are `flags`: a nonzero block holds coefficient 62 where its bit 1 is
    set (63 zero), else coefficient 63. The EOB runs depend on the flags
    alone, and a two-coefficient band keeps the JAX compiles short."""
    q = np.zeros((64, flags.size), np.int16)
    q[62] = (flags == 3) * 3
    q[63] = (flags == 1) * -1
    return q


# the JAX package's AC-first histogram, one compile per shape and interval
jax_ac_first = jax.jit(jsymbols.ac_first_histogram_t,
                       static_argnums=(1, 2, 3))


@pytest.fixture(scope="module")
def edge_jax():
    """The tile-edge flags and, per restart interval, each image's EOB
    counts (the histogram's 16 * q bins) from the JAX package."""
    flags = tp1.edge_flags(17)
    out = {}
    for ri in EDGE_RIS:
        jri = 0 if ri >= N_EDGE else ri       # one segment an image
        out[ri] = np.stack([np.asarray(jax_ac_first(
            jnp.asarray(_q_zz_of(f)), 62, 63, jri))[0:0xF0:16]
            for f in flags])
    return flags, out


EDGE_RIS = [0, 1, 5, EOB_TILE - 1, EOB_TILE, EOB_TILE + 1, N_EDGE - 1,
            N_EDGE, N_EDGE + 3]


@pytest.mark.parametrize("ri", EDGE_RIS)
def test_eob_model_at_tile_edges_matches_plain_and_jax(edge_jax, ri):
    """The tiled EOB kernel's model and the plain version against the
    JAX package at each restart interval (every block a segment, segment
    starts on and beside the tile edges, one segment an image): runs
    ending beside and on tile edges, one nonzero block, all zero."""
    flags, want = edge_jax
    flat = flags.reshape(-1)
    zero = np.zeros((6, 256), np.int32)
    got = model_eob(flat, zero, 6, ri)
    _eq(got[:, 0:0xF0:16], want[ri].astype(np.int64))
    plain = tp1.p1_eob_hist_plain(_t(flat), _t(zero), 6, ri).numpy()
    _eq(plain[:, 0:0xF0:16], want[ri].astype(np.int32))
    assert not got[:, np.arange(256) % 16 != 0].any()


def test_eob_model_long_runs_match_jax(long_runs):
    """Runs past 0x7FFF blocks across more than a hundred tiles (images 1
    and 2 of long_runs, one segment an image): the model's forced EOB14
    flushes and EOBn remainders equal the JAX package's, also with the
    combine in blocks of 32 tiles."""
    flags, _ = long_runs
    zero = np.zeros((3, 256), np.int32)
    got = model_eob(flags, zero, 3, 0)
    # the combine over blocks of 32 tiles: the open run carried between
    _eq(model_eob(flags, zero, 3, 0, warps=1), got)
    for img in (1, 2):
        f = flags[img * N_LONG:(img + 1) * N_LONG]
        want = np.asarray(jax_ac_first(jnp.asarray(_q_zz_of(f)), 62, 63, 0))
        _eq(got[img, 0:0xF0:16], want[0:0xF0:16].astype(np.int64))
