"""GIF read/write (rdgif.c / wrgif.c semantics).

Reading expands the image through its colormap to RGB -- or, when every
colormap entry is gray, to a single grayscale channel (rdgif.c
ReadColorMap).  Writing emits a GIF87a with a global color table and
either real LZW (djpeg -gif) or the uncompressed always-Clear variant
(djpeg -gif0), byte-exact against the reference writer. A copy of
mozjpeg_tpu/utils/gif.py on the port's native library (imageio.cpp).
"""
from __future__ import annotations

import numpy as np

from ..native import lib, u8p

# interlace pass layout (rdgif.c get_interlaced_row): rows are stored in
# pass order 0,8,16... then 4,12... then 2,6,10... then 1,3,5...
_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def read_gif(data: bytes):
    """-> (img, is_gray): (H, W, 3) RGB uint8, or (H, W) when the
    colormap is entirely gray (cjpeg then encodes grayscale)."""
    if len(data) < 13 or data[:3] != b"GIF":
        raise ValueError("Not a GIF file")
    width = data[6] | (data[7] << 8)
    height = data[8] | (data[9] << 8)
    if width == 0 or height == 0:
        raise ValueError("Empty GIF image")
    flags = data[10]
    pos = 13
    colormap = np.zeros((256, 3), np.uint8)
    if flags & 0x80:
        n = 2 << (flags & 7)
        colormap[:n] = np.frombuffer(data[pos:pos + 3 * n],
                                     np.uint8).reshape(n, 3)
        pos += 3 * n

    interlaced = False
    while True:
        if pos >= len(data):
            raise ValueError("GIF image not found")
        c = data[pos]
        pos += 1
        if c == 0x3B:                        # ';' terminator
            raise ValueError("GIF image not found")
        if c == 0x21:                        # '!' extension: skip blocks
            pos += 1
            while pos < len(data) and data[pos]:
                pos += 1 + data[pos]
            pos += 1
            continue
        if c != 0x2C:                        # not an image separator
            continue
        width = data[pos + 4] | (data[pos + 5] << 8)
        height = data[pos + 6] | (data[pos + 7] << 8)
        lflags = data[pos + 8]
        pos += 9
        interlaced = bool(lflags & 0x40)
        if lflags & 0x80:
            n = 2 << (lflags & 7)
            colormap[:n] = np.frombuffer(data[pos:pos + 3 * n],
                                         np.uint8).reshape(n, 3)
            pos += 3 * n
        ics = data[pos]
        pos += 1
        if not 2 <= ics <= 8:
            raise ValueError("bad GIF code size %d" % ics)
        break

    seg = np.frombuffer(data[pos:], np.uint8)
    idx = np.empty(width * height, np.uint8)
    lib().mj_gif_lzw_decode(
        np.ascontiguousarray(seg).ctypes.data_as(u8p), len(seg), ics,
        idx.ctypes.data_as(u8p), width * height)
    idx = idx.reshape(height, width)
    if interlaced:
        out = np.empty_like(idx)
        srow = 0
        for start, step in _PASSES:
            rows = range(start, height, step)
            for r in rows:
                out[r] = idx[srow]
                srow += 1
        idx = out

    gray = bool(np.all(colormap[:, 0] == colormap[:, 1])
                and np.all(colormap[:, 1] == colormap[:, 2]))
    if gray:
        return colormap[idx, 0], True
    return colormap[idx], False


def write_gif(indices: np.ndarray, colormap, num_colors: int,
              lzw: bool = True) -> bytes:
    """wrgif.c emit_header + LZW stream.

    indices: (H, W) uint8 palette indices (or raw gray samples with
    colormap=None). colormap: (n, 3) RGB, (n,) gray, or None for the
    synthesized linear gray map of num_colors entries."""
    h, w = indices.shape
    bits_per_pixel = 1
    while num_colors > (1 << bits_per_pixel):
        bits_per_pixel += 1
    cmap_size = 1 << bits_per_pixel
    init_code_size = max(2, bits_per_pixel)

    out = bytearray(b"GIF87a")
    out += bytes([w & 0xFF, w >> 8, h & 0xFF, h >> 8])
    out.append(0x80 | ((bits_per_pixel - 1) << 4) | (bits_per_pixel - 1))
    out += b"\x00\x00"
    for i in range(cmap_size):
        if i < num_colors:
            if colormap is not None:
                cm = np.asarray(colormap)
                if cm.ndim == 2:
                    out += bytes(int(v) for v in cm[i])
                else:
                    out += bytes([int(cm[i])] * 3)
            else:
                d = max(num_colors - 1, 1)   # single-color map: index 0
                v = (i * 255 + d // 2) // d
                out += bytes([v] * 3)
        else:
            out += bytes([128] * 3)          # CENTERJSAMPLE fill
    out += b"," + bytes([0, 0, 0, 0, w & 0xFF, w >> 8, h & 0xFF, h >> 8])
    out += bytes([0x00, init_code_size])

    pix = np.ascontiguousarray(indices.reshape(-1), dtype=np.uint8)
    n = pix.size
    cap = 2 * n + 4096
    buf = np.empty(cap, np.uint8)
    ln = lib().mj_gif_lzw_encode(pix.ctypes.data_as(u8p), n,
                                 init_code_size, 1 if lzw else 0,
                                 buf.ctypes.data_as(u8p), cap)
    if ln > cap:
        buf = np.empty(ln, np.uint8)
        ln = lib().mj_gif_lzw_encode(pix.ctypes.data_as(u8p), n,
                                     init_code_size, 1 if lzw else 0,
                                     buf.ctypes.data_as(u8p), ln)
    out += bytes(buf[:ln])
    out += b"\x00;"
    return bytes(out)
