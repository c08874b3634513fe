"""yuvjpeg: encode a raw I420 (YUV 4:2:0) file to JPEG.

Port of mozjpeg_tpu/cli/yuvjpeg.py; the encode runs on the GPU (main's
device argument; "cpu" for the kernels' plain versions).

Mirrors mozjpeg yuvjpeg.c: args are `quality WxH in.yuv out.jpg`;
the input must be exactly w*h + 2*ceil(w/2)*ceil(h/2) bytes of planar
Y, Cb, Cr; encoding runs jpeg_write_raw_data with mozjpeg defaults
(JCP_MAX_COMPRESSION: progressive + trellis + scan search), 4:2:0
sampling, optimize_coding, and force-baseline quant clamping
(jpeg_set_quality(..., TRUE), yuvjpeg.c:236). The reference's
extend_edge padding (yuvjpeg.c:44-93, replicate right column then
bottom row) matches the raw pipeline's own block padding.
"""
from __future__ import annotations

import sys

import numpy as np

from ..codec.encoder import _device


def encode_i420(yuv: bytes, width: int, height: int, quality: int,
                device=None) -> bytes:
    from ..codec.config import EncoderConfig
    from ..codec.encoder import encode_raw_yuv
    cw = (width + 1) >> 1
    ch = (height + 1) >> 1
    need = width * height + 2 * cw * ch
    if len(yuv) != need:
        raise ValueError("Unexpected input format!")
    buf = np.frombuffer(yuv, np.uint8)
    y = buf[:width * height].reshape(height, width)
    cb = buf[width * height:width * height + cw * ch].reshape(ch, cw)
    cr = buf[width * height + cw * ch:].reshape(ch, cw)
    cfg = EncoderConfig(quality=float(quality), force_baseline=True,
                        subsampling=(2, 2))
    return encode_raw_yuv([y, cb, cr], width, height,
                          [(2, 2), (1, 1), (1, 1)], cfg, device=device)


def main(argv=None, device=None):
    """Run yuvjpeg with `argv` (sys.argv[1:] by default) on `device`:
    None or "cuda" (the default, the GPU; raises RuntimeError without
    one) or "cpu". Returns the exit code."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 4:
        sys.stderr.write("Required arguments:\n"
                         "1. JPEG quality value, 0-100\n"
                         "2. Image size (e.g. '512x512')\n"
                         "3. Path to YUV input file\n"
                         "4. Path to JPG output file\n")
        return 1
    try:
        quality = int(argv[0])
        assert 0 <= quality <= 100
    except (ValueError, AssertionError):
        sys.stderr.write("Invalid JPEG quality value!\n")
        return 1
    try:
        w, h = (int(v) for v in argv[1].split("x"))
        assert w > 0 and h > 0
    except (ValueError, AssertionError):
        sys.stderr.write("Invalid image size input!\n")
        return 1
    try:
        with open(argv[2], "rb") as f:
            yuv = f.read()
    except OSError:
        sys.stderr.write("Invalid path to YUV file!\n")
        return 1
    dev = _device(device)
    try:
        data = encode_i420(yuv, w, h, quality, dev)
    except ValueError as e:
        sys.stderr.write("%s\n" % e)
        return 1
    try:
        with open(argv[3], "wb") as f:
            f.write(data)
    except OSError:
        sys.stderr.write("Invalid path to JPEG file!\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
