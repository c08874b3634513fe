"""jpegyuv: decode a 4:2:0 JPEG to a raw planar I420 file, on the GPU.

A port of mozjpeg_tpu/cli/jpegyuv.py, which mirrors mozjpeg's
jpegyuv.c: args are `in.jpg out.yuv`; the JPEG is
decoded with jpeg_read_raw_data (no upsampling, no color conversion,
jpegyuv.c:90-92) and the Y / Cb / Cr planes are written cropped to
w*h + 2*ceil(w/2)*ceil(h/2) bytes. The reference assumes 4:2:0 input;
anything else is rejected here instead of producing garbage.
"""
from __future__ import annotations

import sys

import numpy as np

from ..codec.decoder import decode_raw_planes
from ..codec.encoder import _device


def decode_to_i420(jpeg: bytes, device=None) -> tuple[bytes, int, int]:
    planes, width, height, samp = decode_raw_planes(jpeg, device)
    if samp != [(2, 2), (1, 1), (1, 1)]:
        raise ValueError("jpegyuv expects a 4:2:0 YCbCr JPEG")
    cw = (width + 1) >> 1
    ch = (height + 1) >> 1
    out = bytearray()
    out += np.ascontiguousarray(planes[0][:height, :width]).tobytes()
    out += np.ascontiguousarray(planes[1][:ch, :cw]).tobytes()
    out += np.ascontiguousarray(planes[2][:ch, :cw]).tobytes()
    return bytes(out), width, height


def main(argv=None, device=None):
    """Run jpegyuv with `argv` (sys.argv[1:] by default) on `device`:
    None or "cuda" (the default, the GPU; raises RuntimeError without
    one) or "cpu". Returns the exit code."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        sys.stderr.write("Required arguments:\n"
                         "1. Path to JPG input file\n"
                         "2. Path to YUV output file\n")
        return 1
    try:
        with open(argv[0], "rb") as f:
            jpeg = f.read()
    except OSError:
        sys.stderr.write("Invalid path to JPEG file!\n")
        return 1
    dev = _device(device)
    try:
        yuv, _, _ = decode_to_i420(jpeg, dev)
    except ValueError as e:
        sys.stderr.write("%s\n" % e)
        return 1
    try:
        with open(argv[1], "wb") as f:
            f.write(yuv)
    except OSError:
        sys.stderr.write("Invalid path to YUV output file!\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
