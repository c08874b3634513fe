"""The port's PNG reader (utils/png.py, cjpeg's PNG input) against the
JAX package's, on PNGs built here: every colour type and bit depth, a
palette, Adam7 interlacing, all five row filters, iCCP (plausible and
not), sRGB, and garbage (truncated chunks, a bad filter byte, a missing
PLTE, wrong signatures): the same arrays, flags and profile, or the same
error (ValueError, or zlib's error on a cut stream)."""
import struct
import zlib

import numpy as np
import pytest

from mozjpeg_tpu.utils import png as jpng
from mozjpeg_tpu_torch.utils import png as tpng

_ADAM7 = jpng._ADAM7


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _pack_rows(samples, depth, rng):
    """(h, w, ch) samples -> filtered scanlines; the filter type of each
    row is seeded (the rows are stored with filter 0 data after a
    forward Sub/Up/Average/Paeth, so that unfiltering must undo it)."""
    h, w, ch = samples.shape
    if depth < 8:
        per = 8 // depth
        rows = []
        for y in range(h):
            v = samples[y, :, 0].astype(np.uint16)
            pad = (-w) % per
            v = np.concatenate([v, np.zeros(pad, np.uint16)])
            b = np.zeros(len(v) // per, np.uint16)
            for k in range(per):
                b |= v[k::per] << ((per - 1 - k) * depth)
            rows.append(b.astype(np.uint8))
        bpp = 1
    elif depth == 16:
        rows = [samples[y].astype(">u2").view(np.uint8).reshape(-1)
                for y in range(h)]
        bpp = 2 * ch
    else:
        rows = [samples[y].astype(np.uint8).reshape(-1) for y in range(h)]
        bpp = ch
    out, prev = b"", np.zeros_like(rows[0]) if rows else None
    for row in rows:
        ft = int(rng.integers(0, 5))
        r = row.astype(np.int32)
        p = prev.astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
        if ft == 0:
            f = r
        elif ft == 1:
            f = r - left
        elif ft == 2:
            f = r - p
        elif ft == 3:
            f = r - ((left + p) >> 1)
        else:
            pa, pb, pc = (np.abs(p - ul), np.abs(left - ul),
                          np.abs(left + p - 2 * ul))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, p, ul))
            f = r - pred
        out += bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return out


def _png(samples, depth, ctype, interlace=False, extra=(), rng=None,
         palette=None):
    rng = rng or np.random.default_rng(0)
    h, w = samples.shape[:2]
    if samples.ndim == 2:
        samples = samples[..., None]
    if interlace:
        raw = b""
        for x0, y0, dx, dy in _ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _pack_rows(sub, depth, rng)
    else:
        raw = _pack_rows(samples, depth, rng)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      int(interlace)))
    for c in extra:
        body += c
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    body += _chunk(b"IDAT", zlib.compress(raw))
    return jpng.SIGNATURE + body + _chunk(b"IEND", b"")


def _icc(size=200):
    p = bytearray(size)
    p[:4] = struct.pack(">I", size)
    p[36:40] = b"acsp"
    return bytes(p)


def _check(data):
    try:
        want = jpng.read_png(data)
    except Exception as e:                    # ValueError or zlib.error
        with pytest.raises(type(e)) as got:
            tpng.read_png(data)
        assert str(got.value) == str(e)
        return None
    got = tpng.read_png(data)
    assert got[0].dtype == want[0].dtype
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    return got


CASES = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16), (3, 1),
                                                (3, 2), (3, 4), (3, 8),
                                                (4, 8), (4, 16), (6, 8),
                                                (6, 16)]


@pytest.mark.parametrize("interlace", [False, True], ids=["flat", "adam7"])
@pytest.mark.parametrize("ctype,depth", CASES,
                         ids=["c%d-%d" % c for c in CASES])
def test_color_types_and_depths_equal_jax(ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth)
    h, w = 13, 11
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1 if ctype != 3 else min((1 << depth) - 1, 20)
    samples = rng.integers(0, top + 1, (h, w, ch))
    pal = (rng.integers(0, 256, (21, 3)).astype(np.uint8)
           if ctype == 3 else None)
    got = _check(_png(samples, depth, ctype, interlace, rng=rng,
                      palette=pal))
    assert got is not None and got[0].shape[:2] == (h, w)
    assert got[1] == (ctype in (0, 4))


def test_iccp_and_srgb_equal_jax():
    prof = _icc()
    good = _chunk(b"iCCP", b"name\x00\x00" + zlib.compress(prof))
    bad = _chunk(b"iCCP", b"name\x00\x00" + zlib.compress(b"x" * 140))
    junk = _chunk(b"iCCP", b"name\x00\x00" + b"not zlib")
    srgb = _chunk(b"sRGB", b"\x00")
    img = np.random.default_rng(5).integers(0, 256, (6, 7, 3))
    assert _check(_png(img, 8, 2, extra=[good]))[2] == prof
    assert _check(_png(img, 8, 2, extra=[bad]))[2] is None
    assert _check(_png(img, 8, 2, extra=[junk]))[2] is None
    assert _check(_png(img, 8, 2, extra=[srgb]))[3] is True


def test_garbage_raises_like_jax():
    img = np.random.default_rng(6).integers(0, 256, (6, 7, 3))
    good = _png(img, 8, 2)
    cases = [b"", b"GIF89a", good[:8], good[:40], good[:-30],
             good.replace(b"IHDR", b"IHDX"),
             _png(np.zeros((4, 4, 1), int), 8, 3),          # no PLTE
             _png(img, 8, 2)[:33] + _chunk(b"IDAT", zlib.compress(
                 b"\x07" + bytes(21) * 6)) + _chunk(b"IEND", b""),
             _png(np.zeros((4, 4, 1), int) + 9, 8, 3,
                  palette=np.zeros((3, 3), np.uint8))]       # bad index
    for data in cases:
        _check(data)
    with pytest.raises(ValueError):
        tpng.read_png(b"\x89PNG\r\n\x1a\n")
