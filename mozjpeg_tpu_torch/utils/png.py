"""PNG reading (rdpng.c semantics).

Matches the reference's libpng transform stack (rdpng.c:93-118):
palette -> RGB, 1/2/4-bit gray expanded to 8, alpha stripped, Adam7
interlace handled, 16-bit stripped to the high byte.  Gray and
gray+alpha map to a 1-component grayscale source; everything else to
RGB (rdpng.c:109-115).  An embedded iCCP profile is returned inflated
so the encoder can emit it as APP2 ICC_PROFILE chunks (rdpng.c:146-165);
a bare sRGB chunk is reported as ``srgb=True`` (the reference embeds a
canned minimal sRGB profile in that case, rdpng.c:140-144).

Decompression is stdlib zlib; row unfiltering is the native
``mj_png_unfilter`` (imageio.cpp, in the port's library). A copy of
mozjpeg_tpu/utils/png.py.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..native import lib, u8p

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Adam7 pass layout: (x_start, y_start, x_step, y_step)
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, nrows: int, rowbytes: int, bpp: int) -> np.ndarray:
    out = np.empty(nrows * rowbytes, np.uint8)
    if nrows == 0 or rowbytes == 0:
        return out
    need = nrows * (rowbytes + 1)
    if len(raw) < need:
        raise ValueError("Truncated PNG image data")
    rawbuf = np.frombuffer(raw, np.uint8, count=need)
    r = lib().mj_png_unfilter(
        rawbuf.ctypes.data_as(u8p), out.ctypes.data_as(u8p),
        nrows, rowbytes, bpp)
    if r != 0:
        raise ValueError("Invalid PNG filter type")
    return out


def _unpack_bits(row: np.ndarray, depth: int, width: int) -> np.ndarray:
    """Expand packed 1/2/4-bit samples to one sample per byte (raw values)."""
    if depth == 8:
        return row[:width]
    if depth == 16:
        return row[: 2 * width : 2]  # png_set_strip_16: keep high byte
    per = 8 // depth
    idx = np.arange(width)
    byte = row[idx // per].astype(np.uint16)
    shift = (per - 1 - (idx % per)) * depth
    return ((byte >> shift) & ((1 << depth) - 1)).astype(np.uint8)


def _scale_gray(v: np.ndarray, depth: int) -> np.ndarray:
    """png_set_expand_gray_1_2_4_to_8: replicate bits to full 8-bit range."""
    if depth == 1:
        return (v * 255).astype(np.uint8)
    if depth == 2:
        return (v * 85).astype(np.uint8)
    if depth == 4:
        return (v * 17).astype(np.uint8)
    return v.astype(np.uint8)


def _decode_subimage(raw: bytes, width: int, height: int, depth: int,
                     ctype: int) -> np.ndarray:
    """Reconstruct one (sub)image -> (H, W, channels) uint8 raw samples."""
    ch = _CHANNELS[ctype]
    sample_bytes = 2 if depth == 16 else 1
    if depth < 8:
        rowbytes = (width * depth + 7) // 8
        bpp = 1
    else:
        rowbytes = width * ch * sample_bytes
        bpp = ch * sample_bytes
    flat = _unfilter(raw, height, rowbytes, bpp)
    rows = flat.reshape(height, rowbytes)
    if depth < 8:
        out = np.empty((height, width), np.uint8)
        for y in range(height):
            out[y] = _unpack_bits(rows[y], depth, width)
        return out[:, :, None]
    if depth == 16:
        return rows.reshape(height, width, ch, 2)[:, :, :, 0]
    return rows.reshape(height, width, ch)


def _icc_plausible(p: bytes) -> bool:
    """libpng png_icc_check_length/header essentials: 132-byte minimum,
    internal length field matching the stream, 'acsp' signature."""
    if len(p) < 132:
        return False
    (size,) = struct.unpack(">I", p[:4])
    return size == len(p) and p[36:40] == b"acsp"


def read_png(data: bytes):
    """-> (img, is_gray, icc, srgb): (H, W, 3) RGB or (H, W) gray uint8."""
    if not data.startswith(SIGNATURE):
        raise ValueError("Not a PNG file")
    pos = len(SIGNATURE)
    idat = []
    ihdr = None
    palette = None
    icc = None
    srgb = False
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError("Truncated PNG chunk")
        pos += 12 + length  # incl. CRC (not validated, like libpng default)
        if ctag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctag == b"PLTE":
            palette = np.frombuffer(body, np.uint8)
            palette = palette[: 3 * (len(palette) // 3)].reshape(-1, 3)
        elif ctag == b"IDAT":
            idat.append(body)
        elif ctag == b"iCCP":
            nul = body.find(b"\x00")
            if nul >= 0 and len(body) > nul + 2:
                try:
                    icc = zlib.decompress(body[nul + 2:])
                except zlib.error:
                    icc = None
                if icc is not None and not _icc_plausible(icc):
                    # libpng 1.6 rejects malformed profiles with a
                    # warning, so the reference never embeds them
                    icc = None
        elif ctag == b"sRGB":
            srgb = True
        elif ctag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG missing IHDR")
    width, height, depth, ctype, comp, filt, interlace = ihdr
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError("Unsupported PNG compression/filter/interlace")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError("Unsupported PNG color type/bit depth")
    if width == 0 or height == 0 or width > 65535 or height > 65535:
        raise ValueError("Image too large")  # rdpng.c:104-107
    if ctype == 3 and palette is None:
        raise ValueError("PNG palette image missing PLTE")

    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        samples = _decode_subimage(raw, width, height, depth, ctype)
    else:
        samples = np.zeros((height, width, _CHANNELS[ctype]), np.uint8)
        off = 0
        sample_bytes = 2 if depth == 16 else 1
        ch = _CHANNELS[ctype]
        for (x0, y0, dx, dy) in _ADAM7:
            pw = (width - x0 + dx - 1) // dx
            ph = (height - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            if depth < 8:
                rowbytes = (pw * depth + 7) // 8
            else:
                rowbytes = pw * ch * sample_bytes
            nbytes = ph * (rowbytes + 1)
            sub = _decode_subimage(raw[off:off + nbytes], pw, ph, depth,
                                   ctype)
            off += nbytes
            samples[y0::dy, x0::dx] = sub

    if ctype == 3:  # palette -> RGB (png_set_palette_to_rgb)
        idx = samples[:, :, 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[idx], False, icc, srgb
    if ctype in (0, 4):  # gray / gray+alpha -> grayscale, alpha stripped
        gray = _scale_gray(samples[:, :, 0], depth)
        return gray, True, icc, srgb
    # RGB / RGBA -> RGB (alpha stripped)
    return samples[:, :, :3], False, icc, srgb
