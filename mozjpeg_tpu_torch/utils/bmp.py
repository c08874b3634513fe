"""BMP read/write (rdbmp.c / wrbmp.c semantics).

Reading supports OS/2 1.x (12-byte) and Windows (40/64-byte) headers with
8-bit colormapped, 24-bit and 32-bit uncompressed data, bottom-up row
order, and propagates pels-per-meter density to JFIF fields. Writing
emits Windows (-bmp) or OS/2 (-os2) files: 24-bit BGR, or 8-bit
colormapped/grayscale with a 256-entry palette, byte-exact against the
reference writer. A copy of mozjpeg_tpu/utils/bmp.py.
"""
from __future__ import annotations

import numpy as np


def read_bmp(data: bytes):
    """-> (rgb (H, W, 3) uint8, density (unit, xd, yd) or None)."""
    if len(data) < 26 or data[0] != 0x42 or data[1] != 0x4D:
        raise ValueError("Not a BMP file")
    bfOffBits = int.from_bytes(data[10:14], "little")
    header_size = int.from_bytes(data[14:18], "little")
    density = None
    mapentrysize = 0
    if header_size == 12:
        width = int.from_bytes(data[18:20], "little")
        height = int.from_bytes(data[20:22], "little")
        planes = int.from_bytes(data[22:24], "little")
        bpp = int.from_bytes(data[24:26], "little")
        if bpp == 8:
            mapentrysize = 3
        elif bpp not in (24, 32):
            raise ValueError("unsupported BMP depth %d" % bpp)
    elif header_size in (40, 64, 108, 124):
        width = int.from_bytes(data[18:22], "little", signed=True)
        height = int.from_bytes(data[22:26], "little", signed=True)
        planes = int.from_bytes(data[26:28], "little")
        bpp = int.from_bytes(data[28:30], "little")
        compression = int.from_bytes(data[30:34], "little")
        xppm = int.from_bytes(data[38:42], "little", signed=True)
        yppm = int.from_bytes(data[42:46], "little", signed=True)
        if bpp == 8:
            mapentrysize = 4
        elif bpp not in (24, 32):
            raise ValueError("unsupported BMP depth %d" % bpp)
        if compression != 0:
            raise ValueError("compressed BMP not supported")
        if xppm > 0 and yppm > 0:
            # 100 cm per meter (rdbmp.c:515-519)
            density = (2, xppm // 100, yppm // 100)
    else:
        raise ValueError("bad BMP header size %d" % header_size)
    if width <= 0 or height <= 0:
        raise ValueError("empty BMP image")
    if planes != 1:
        raise ValueError("bad BMP planes")

    pos = 14 + header_size
    cmap = None
    if mapentrysize:
        ncolors = 256
        if header_size != 12:
            bcu = int.from_bytes(data[46:50], "little")
            if bcu > 0:
                ncolors = bcu
            if ncolors > 256:
                raise ValueError("bad BMP colormap")
        raw = np.frombuffer(data[pos:pos + ncolors * mapentrysize],
                            np.uint8).reshape(ncolors, mapentrysize)
        cmap = raw[:, [2, 1, 0]]            # BGR(A) -> RGB
        pos += ncolors * mapentrysize
    if bfOffBits < pos:
        raise ValueError("bad BMP bfOffBits")
    pos = bfOffBits

    bytes_pp = bpp // 8
    row_w = width * bytes_pp
    row_stride = (row_w + 3) & ~3
    need = row_stride * height
    body = np.frombuffer(data[pos:pos + need], np.uint8)
    if body.size < need:
        raise ValueError("premature EOF in BMP")
    rows = body.reshape(height, row_stride)[::-1, :row_w]   # bottom-up
    if bpp == 8:
        idx = rows
        if cmap is None:
            raise ValueError("8-bit BMP without colormap")
        if len(cmap) < 256 and np.any(idx >= len(cmap)):
            raise ValueError("BMP colormap index out of range")
        return cmap[idx], density
    px = rows.reshape(height, width, bytes_pp)
    return px[:, :, [2, 1, 0]].copy(), density              # BGR(A) -> RGB


def write_bmp(img: np.ndarray, os2: bool = False,
              colormap: np.ndarray = None, density=None) -> bytes:
    """img: (H, W, 3) RGB for 24-bit, or (H, W) uint8 for 8-bit output
    (gray samples with colormap=None -> linear palette; palette indices
    with colormap=(n, 3) RGB or (n,) gray)."""
    h, w = img.shape[:2]
    eight_bit = img.ndim == 2
    if eight_bit:
        bpp, cmap_entries = 8, 256
        row_w = (w + 3) & ~3
    else:
        bpp, cmap_entries = 24, 0
        row_w = (w * 3 + 3) & ~3
    entry = 3 if os2 else 4
    headersize = 14 + (12 if os2 else 40) + cmap_entries * entry
    bf_size = headersize + row_w * h

    out = bytearray()
    out += b"BM" + bf_size.to_bytes(4, "little") + b"\x00\x00\x00\x00"
    out += headersize.to_bytes(4, "little")
    if os2:
        core = bytearray(12)
        core[0:2] = (12).to_bytes(2, "little")   # bcSize (high bytes 0)
        core[4:6] = w.to_bytes(2, "little")
        core[6:8] = h.to_bytes(2, "little")
        core[8:10] = (1).to_bytes(2, "little")
        core[10:12] = bpp.to_bytes(2, "little")
        out += core
    else:
        info = bytearray(40)
        info[0:4] = (40).to_bytes(4, "little")
        info[4:8] = w.to_bytes(4, "little")
        info[8:12] = h.to_bytes(4, "little")
        info[12:14] = (1).to_bytes(2, "little")
        info[14:16] = bpp.to_bytes(2, "little")
        if density and density[0] == 2:      # dots/cm -> pels/meter
            info[24:28] = (density[1] * 100).to_bytes(4, "little")
            info[28:32] = (density[2] * 100).to_bytes(4, "little")
        info[32:34] = cmap_entries.to_bytes(2, "little")
        out += info

    if eight_bit:
        pal = bytearray()
        if colormap is not None:
            cm = np.asarray(colormap)
            n = len(cm)
            for i in range(n):
                if cm.ndim == 2:
                    pal += bytes([int(cm[i, 2]), int(cm[i, 1]),
                                  int(cm[i, 0])])
                else:
                    pal += bytes([int(cm[i])] * 3)
                if entry == 4:
                    pal += b"\x00"
        else:
            n = 256
            for i in range(256):
                pal += bytes([i, i, i] + ([0] if entry == 4 else []))
        for i in range(n, 256):
            pal += b"\x00" * entry
        out += pal

    if eight_bit:
        rows = np.zeros((h, row_w), np.uint8)
        rows[:, :w] = img
    else:
        rows = np.zeros((h, row_w), np.uint8)
        rows[:, :w * 3] = img[:, :, [2, 1, 0]].reshape(h, w * 3)
    out += rows[::-1].tobytes()              # bottom-up
    return bytes(out)
