"""Targa read/write (rdtarga.c / wrtarga.c semantics).

Reading supports subtypes 1/2/3 (colormapped, RGB, grayscale) plus their
RLE variants (9/10/11), 8/16/24/32-bit pixels, bottom-up or top-down row
order. Writing emits top-down uncompressed files: 24-bit BGR, 8-bit
grayscale, or 8-bit colormapped with a BGR palette -- byte-exact against
the reference writer. A copy of mozjpeg_tpu/utils/targa.py on the port's
native library (imageio.cpp).
"""
from __future__ import annotations

import numpy as np

from ..native import lib, u8p

# 5-bit -> 8-bit expansion (rdtarga.c:73-78)
_C5TO8 = np.array([
    0, 8, 16, 25, 33, 41, 49, 58,
    66, 74, 82, 90, 99, 107, 115, 123,
    132, 140, 148, 156, 165, 173, 181, 189,
    197, 206, 214, 222, 230, 239, 247, 255], np.uint8)


def read_targa(data: bytes):
    """-> (img, is_gray): (H, W, 3) RGB or (H, W) grayscale uint8."""
    if len(data) < 18:
        raise ValueError("Invalid Targa file")
    idlen = data[0]
    cmaptype = data[1]
    subtype = data[2]
    maplen = data[5] | (data[6] << 8)
    mapentry = data[7]
    width = data[12] | (data[13] << 8)
    height = data[14] | (data[15] << 8)
    bits = 16 if data[16] == 15 else data[16]
    flags = data[17]
    pixel_size = bits >> 3
    bottom_up = (flags & 0x20) == 0
    if (cmaptype > 1 or pixel_size < 1 or pixel_size > 4
            or (bits & 7) != 0 or (flags >> 6) != 0
            or width == 0 or height == 0):
        raise ValueError("Invalid Targa parameters")
    rle = False
    if subtype > 8:
        rle = True
        subtype -= 8
    if subtype == 1:
        if not (pixel_size == 1 and cmaptype == 1):
            raise ValueError("Invalid colormapped Targa")
    elif subtype == 2:
        if pixel_size not in (2, 3, 4):
            raise ValueError("Invalid RGB Targa")
    elif subtype == 3:
        if pixel_size != 1:
            raise ValueError("Invalid grayscale Targa")
    else:
        raise ValueError("Invalid Targa subtype")

    pos = 18 + idlen
    cmap = None
    if maplen > 0:
        if maplen > 256 or (data[3] | (data[4] << 8)) != 0:
            raise ValueError("Invalid Targa colormap")
        if mapentry != 24:
            raise ValueError("unsupported Targa colormap depth")
        raw = np.frombuffer(data[pos:pos + maplen * 3],
                            np.uint8).reshape(maplen, 3)
        cmap = raw[:, [2, 1, 0]]            # BGR -> RGB
        pos += maplen * 3
    elif cmaptype:
        raise ValueError("Targa colormap promised but missing")

    npix = width * height
    if rle:
        raw = np.empty(npix * pixel_size, np.uint8)
        seg = np.frombuffer(data[pos:], np.uint8)
        r = lib().mj_tga_rle_decode(
            np.ascontiguousarray(seg).ctypes.data_as(u8p), len(seg),
            pixel_size, raw.ctypes.data_as(u8p), npix)
        if r < 0:
            raise ValueError("premature EOF in Targa")
    else:
        need = npix * pixel_size
        raw = np.frombuffer(data[pos:pos + need], np.uint8)
        if raw.size < need:
            raise ValueError("premature EOF in Targa")
    px = raw.reshape(height, width, pixel_size)
    if bottom_up:
        px = px[::-1]

    if subtype == 3:
        return px[:, :, 0].copy(), True
    if subtype == 1:
        idx = px[:, :, 0]
        if len(cmap) < 256 and np.any(idx >= len(cmap)):
            raise ValueError("Targa colormap index out of range")
        return cmap[idx], False
    if pixel_size == 2:
        t = px[:, :, 0].astype(np.uint16) | (px[:, :, 1].astype(
            np.uint16) << 8)
        out = np.empty((height, width, 3), np.uint8)
        out[:, :, 2] = _C5TO8[t & 0x1F]
        out[:, :, 1] = _C5TO8[(t >> 5) & 0x1F]
        out[:, :, 0] = _C5TO8[(t >> 10) & 0x1F]
        return out, False
    return px[:, :, [2, 1, 0]].copy(), False   # BGR(A) -> RGB


def write_targa(img: np.ndarray, colormap: np.ndarray = None,
                num_colors: int = 0) -> bytes:
    """img: (H, W, 3) RGB -> type 2; (H, W) gray -> type 3;
    (H, W) indices + colormap -> type 1 (wrtarga.c write_header)."""
    h, w = img.shape[:2]
    hdr = bytearray(18)
    if colormap is not None:
        hdr[1] = 1
        hdr[5] = num_colors & 0xFF
        hdr[6] = num_colors >> 8
        hdr[7] = 24
    hdr[12], hdr[13] = w & 0xFF, w >> 8
    hdr[14], hdr[15] = h & 0xFF, h >> 8
    hdr[17] = 0x20                           # top-down
    gray = img.ndim == 2 and colormap is None
    if gray:
        hdr[2], hdr[16] = 3, 8
    elif colormap is not None:
        hdr[2], hdr[16] = 1, 8
    else:
        hdr[2], hdr[16] = 2, 24
    out = bytearray(hdr)
    if colormap is not None:
        cm = np.asarray(colormap)
        for i in range(num_colors):
            if cm.ndim == 2:
                out += bytes([int(cm[i, 2]), int(cm[i, 1]), int(cm[i, 0])])
            else:
                out += bytes([int(cm[i])] * 3)
    if img.ndim == 3:
        out += np.ascontiguousarray(img[:, :, [2, 1, 0]]).tobytes()
    else:
        out += np.ascontiguousarray(img).tobytes()
    return bytes(out)
