"""djpeg-compatible command line (the flag surface of mozjpeg's djpeg.c),
a port of mozjpeg_tpu/cli/djpeg.py: the same flags, output rules and exit
codes (0; 1 on an error; 2 when the stream raised corrupt-data warnings),
on the port's decoder, at the stream's precision (a 12-bit stream writes
a PPM with maxval 4095; lossless streams decode on the host). It runs on
the GPU; there is no CPU fallback.

Usage: python -m mozjpeg_tpu_torch.cli.djpeg [switches] [inputfile]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..codec import decoder, marker
from ..codec.encoder import _device
from ..native import lib
from ..utils import bmp, gif, ppm, targa


def build_parser():
    p = argparse.ArgumentParser(prog="djpeg",
                                description="JPEG decoder on the GPU")
    p.add_argument("-grayscale", "-greyscale", action="store_true",
                   dest="grayscale")
    p.add_argument("-scale", type=str, default=None,
                   help="M/N scaling (1/8..2/1 in 1/8 steps)")
    p.add_argument("-colors", "-colours", "-quantize", "-quantise",
               type=int, default=None,
                   dest="colors", help="quantize to N colors")
    p.add_argument("-onepass", action="store_true",
                   help="one-pass (fixed palette) quantization")
    p.add_argument("-dither", default="fs",
                   choices=["fs", "ordered", "none"])
    p.add_argument("-rgb565", action="store_true",
                   help="force RGB565 output (BMP formats only)")
    p.add_argument("-map", type=str, default=None, dest="mapfile",
                   help="quantize to the colors of this GIF/PPM file")
    p.add_argument("-nosmooth", action="store_true",
                   help="box-filter upsampling (merged upsample path)")
    p.add_argument("-dct", default="int", choices=["int", "fast", "float"])
    p.add_argument("-outfile", type=str, default=None)
    fmt = p.add_mutually_exclusive_group()
    fmt.add_argument("-pnm", "-ppm", action="store_const", const="pnm",
                     dest="fmt", default="pnm")
    fmt.add_argument("-bmp", action="store_const", const="bmp", dest="fmt")
    fmt.add_argument("-os2", action="store_const", const="os2", dest="fmt")
    fmt.add_argument("-gif", action="store_const", const="gif", dest="fmt")
    fmt.add_argument("-gif0", action="store_const", const="gif0",
                     dest="fmt")
    fmt.add_argument("-targa", action="store_const", const="targa",
                     dest="fmt")
    p.add_argument("-crop", type=str, default=None,
                   help="WxH+X+Y partial decode")
    p.add_argument("-skip", type=str, default=None,
                   help="Y0,Y1 drop rows Y0..Y1 inclusive")
    p.add_argument("-rgb", action="store_true", dest="force_rgb",
                   help="force RGB output")
    p.add_argument("-fast", action="store_true",
                   help="low-quality processing (fast DCT, box upsample, "
                        "1-pass ordered-dither quantization)")
    p.add_argument("-icc", type=str, default=None, dest="iccfile",
                   help="extract ICC profile to FILE")
    p.add_argument("-maxscans", type=int, default=0,
                   help="abort if the input has more scans than this")
    p.add_argument("-strict", action="store_true",
                   help="treat all warnings as fatal")
    p.add_argument("-maxmemory", type=str, default=None)   # accepted, no-op
    p.add_argument("-memsrc", action="store_true")         # always memory src
    p.add_argument("-report", action="store_true")
    p.add_argument("-verbose", "-debug", action="store_true", dest="verbose")
    p.add_argument("-version", action="store_true")
    p.add_argument("input", nargs="?", default=None)
    return p


def _write_output(a, img, maxval, density):
    """Serialize per the selected format with djpeg's quantization rules:
    GIF forces palette output (wrgif.c:402-407); BMP/Targa go colormapped
    only when -colors quantization is active."""
    fmt = a.fmt
    gray_in = img.ndim == 2
    colors = a.colors
    if fmt in ("gif", "gif0") and not gray_in and not colors \
            and not a.mapfile:
        colors = 256                     # forced quantization, <=256
    idx = cmap = None
    if a.mapfile:
        with open(a.mapfile, "rb") as f:
            cmap = decoder.read_color_map(f.read())
        idx, cmap = decoder.quantize_to_map(img, cmap, a.dither)
    elif colors:
        idx, cmap = decoder.quantize_colors(img, colors, a.dither,
                                            two_pass=not a.onepass)

    if fmt == "pnm":
        out_img = cmap[idx] if idx is not None else img
        if a.outfile:
            ppm.write(a.outfile, out_img, maxval=maxval)
        else:
            import tempfile
            with tempfile.NamedTemporaryFile(suffix=".ppm") as f:
                ppm.write(f.name, out_img, maxval=maxval)
                sys.stdout.buffer.write(open(f.name, "rb").read())
        return

    if fmt in ("bmp", "os2"):
        os2 = fmt == "os2"
        if idx is not None:
            data = bmp.write_bmp(idx, os2=os2, colormap=cmap,
                                 density=density)
        elif gray_in:
            data = bmp.write_bmp(img, os2=os2, colormap=None,
                                 density=density)
        else:
            data = bmp.write_bmp(img, os2=os2, density=density)
    elif fmt in ("gif", "gif0"):
        lzw = fmt == "gif"
        if idx is not None:
            n = len(cmap)
            # grayscale-quantized colormaps stay gray triples
            data = gif.write_gif(idx, cmap, n, lzw=lzw)
        else:
            data = gif.write_gif(img, None, 256, lzw=lzw)
    else:                                # targa
        if idx is not None:
            if gray_in:
                # Targa has no mapped grayscale: demap (wrtarga.c:163-167)
                data = targa.write_targa(cmap[idx][..., 0]
                                         if cmap.ndim == 2 else cmap[idx])
            else:
                data = targa.write_targa(idx, colormap=cmap,
                                         num_colors=len(cmap))
        else:
            data = targa.write_targa(img)
    if a.outfile:
        with open(a.outfile, "wb") as f:
            f.write(data)
    else:
        sys.stdout.buffer.write(data)


def main(argv=None, device=None):
    """Run djpeg with `argv` (sys.argv[1:] by default) on `device`: None
    or "cuda" (the default, the GPU; raises RuntimeError without one) or
    "cpu". Returns the exit code."""
    a = build_parser().parse_args(argv)
    if a.version:
        from .. import __version__
        print("mozjpeg_tpu_torch version %s" % __version__, file=sys.stderr)
        return 0
    dev = _device(device)
    if a.fast:
        # djpeg.c:285-292: quick-and-dirty processing profile. Later
        # switches win (reference parse order): only fill values the
        # user did not set explicitly after -fast.
        if "-dct" not in (argv or sys.argv):
            a.dct = "fast"
        a.nosmooth = True
        a.onepass = True
        if "-dither" not in (argv or sys.argv):
            a.dither = "ordered"
        if a.colors is None and (a.fmt in ("gif", "gif0")):
            a.colors = 216
    lib().mj_set_warnings(0)
    if a.input:
        with open(a.input, "rb") as f:
            data = f.read()
    else:
        data = sys.stdin.buffer.read()
    jp0 = marker.parse(data)
    maxval = (1 << jp0.precision) - 1
    if a.maxscans and len(jp0.scans) > a.maxscans:
        # cdjpeg.c:33-40: abort when the scan count exceeds -maxscans
        print("Scan number %d exceeds maximum scans (%d)"
              % (len(jp0.scans), a.maxscans), file=sys.stderr)
        return 1
    if a.crop and not a.skip:
        wh, x, y = a.crop.split("+")
        w, h = (int(v) for v in wh.split("x"))
        x, y = int(x), int(y)
        if a.scale or a.rgb565 or a.colors is not None:
            print("djpeg: -crop cannot be combined with -scale/-rgb565/"
                  "-colors here", file=sys.stderr)
            return 1
        img, ax, w2 = decoder.decode_cropped(
            data, x, w, fancy_upsample=not a.nosmooth,
            colorspace="grayscale" if a.grayscale else None, device=dev)
        if y < 0 or h <= 0 or y + h > img.shape[0]:
            print("djpeg: crop region exceeds image height %d"
                  % img.shape[0], file=sys.stderr)
            return 1
        img = img[y:y + h]
    elif a.scale:
        num, den = (int(v) for v in a.scale.split("/"))
        # -nosmooth only suppresses fancy upsampling (djpeg.c:366-368);
        # block smoothing stays on (jdapimin.c:221)
        img = decoder.decode_scaled(
            data, num, den, fancy_upsample=not a.nosmooth,
            colorspace="grayscale" if a.grayscale else None, device=dev)
    elif a.grayscale:
        img = decoder.decode_grayscale(data, fancy_upsample=not a.nosmooth,
                                       device=dev)
    elif a.rgb565:
        px = decoder.decode_rgb565(data, fancy_upsample=not a.nosmooth,
                                   device=dev)
        # wrbmp expands LE RGB565 to 24-bit (wrbmp.c:127-140)
        img = np.stack([((px >> 8) & 0xF8).astype(np.uint8),
                        ((px >> 3) & 0xFC).astype(np.uint8),
                        ((px << 3) & 0xF8).astype(np.uint8)], axis=-1)
    else:
        img = decoder.decode(data, fancy_upsample=not a.nosmooth,
                             dct_method={"int": "islow", "fast": "ifast",
                                         "float": "float"}[a.dct],
                             device=dev)
    if a.skip:
        # djpeg.c:403-412,718-737: drop rows Y0..Y1 of the (scaled) output
        try:
            y0, y1 = (int(v) for v in a.skip.split(","))
        except ValueError:
            y0, y1 = -1, -1
        if y0 < 0 or y1 < 0 or y0 > y1:
            build_parser().print_usage(sys.stderr)
            return 1
        if y1 > img.shape[0] - 1:
            print("djpeg: skip region exceeds image height %d"
                  % img.shape[0], file=sys.stderr)
            return 1
        img = np.concatenate([img[:y0], img[y1 + 1:]])

    if a.force_rgb and img.ndim == 2:
        # out_color_space=JCS_RGB on a grayscale image: replicate
        # (gray_rgb_convert, jdcolor.c)
        img = np.stack([img] * 3, axis=-1)
    jp = jp0
    # wrbmp only writes pels-per-meter when density_unit is dots/cm
    density = jp.density if jp.density[0] == 2 else None
    warnings = decoder.last_warnings()
    if a.strict and warnings:
        # -strict: first warning is fatal (djpeg.c:581, my_emit_message)
        print("djpeg: corrupt data encountered (warnings treated as "
              "fatal)", file=sys.stderr)
        return 1
    if a.iccfile is not None:
        # djpeg.c:897-917: extract the ICC profile; warn if absent
        if jp.icc_profile:
            with open(a.iccfile, "wb") as f:
                f.write(jp.icc_profile)
        else:
            print("djpeg: no ICC profile data in JPEG file",
                  file=sys.stderr)
    _write_output(a, img, maxval, density)
    # djpeg.c:941: exit status 2 when corrupt-data warnings occurred
    return 2 if warnings else 0


if __name__ == "__main__":
    sys.exit(main())
