"""jpegtran-compatible CLI (the flag surface of mozjpeg jpegtran.c).

Lossless transforms + jpegrescan re-optimization (mozjpeg default).
Port of mozjpeg_tpu/cli/jpegtran.py, the same switches, outputs, messages
and exit codes. Host-only, as there: a transcode reads, moves and
writes coefficients on the host (codec/transcode.py), so main takes no
device.

Usage: python -m mozjpeg_tpu_torch.cli.jpegtran [switches] [inputfile]
"""
from __future__ import annotations

import argparse
import sys

from ..codec.config import EncoderConfig, Profile


def build_parser():
    p = argparse.ArgumentParser(prog="jpegtran",
                                description="lossless JPEG transformer")
    p.add_argument("-flip", choices=["horizontal", "vertical"], default=None)
    p.add_argument("-rotate", type=int, choices=[90, 180, 270], default=None)
    p.add_argument("-transpose", action="store_true")
    p.add_argument("-transverse", action="store_true")
    p.add_argument("-crop", type=str, default=None,
                   help="W[fr]xH[fr]{+-}X{+-}Y (f=flat, r=reflect fill)")
    p.add_argument("-wipe", type=str, default=None, help="WxH+X+Y")
    p.add_argument("-drop", type=str, nargs=2, default=None,
                   metavar=("+X+Y", "FILE"),
                   help="insert FILE's image at +X+Y")
    p.add_argument("-optimize", "-optimise", action="store_true",
                   dest="optimize", default=None)
    p.add_argument("-progressive", action="store_true", default=None)
    p.add_argument("-fastcrush", action="store_true")
    p.add_argument("-revert", action="store_true")
    p.add_argument("-arithmetic", action="store_true")
    p.add_argument("-copy", choices=["none", "comments", "icc", "all",
                                     "all_except_icc"], default="comments")
    p.add_argument("-perfect", action="store_true")
    p.add_argument("-trim", action="store_true",
                   help="drop non-transformable edge blocks")
    p.add_argument("-icc", type=str, default=None, dest="iccfile",
                   help="embed the ICC profile contained in FILE")
    p.add_argument("-grayscale", "-greyscale", action="store_true",
                   dest="grayscale",
                   help="reduce to grayscale (omit color data)")
    p.add_argument("-restart", type=str, default=None,
                   help="restart interval in MCU rows, or blocks with B")
    p.add_argument("-scans", type=str, default=None,
                   help="scan script file")
    p.add_argument("-strict", action="store_true",
                   help="treat all warnings as fatal")
    p.add_argument("-maxmemory", type=str, default=None)   # accepted, no-op
    p.add_argument("-report", action="store_true")
    p.add_argument("-verbose", "-debug", action="store_true", dest="verbose")
    p.add_argument("-version", action="store_true")
    p.add_argument("-maxscans", type=int, default=None)
    p.add_argument("-outfile", type=str, default=None)
    p.add_argument("input", nargs="?", default=None)
    return p


def main(argv=None):
    """Run jpegtran with `argv` (sys.argv[1:] by default); returns the
    exit code."""
    a = build_parser().parse_args(argv)
    if a.version or a.verbose:
        from .. import __version__
        print("mozjpeg_tpu_torch version %s" % __version__, file=sys.stderr)
        if a.version:
            return 0
    from ..codec import transcode
    icc_profile = None
    if a.iccfile is not None:
        # jpegtran.c:576-604: read the profile up front; -copy all drops
        # the source's own ICC markers, -copy icc becomes -copy none
        try:
            icc_profile = open(a.iccfile, "rb").read()
        except OSError:
            sys.stderr.write("jpegtran: can't open %s\n" % a.iccfile)
            return 1
        if not icc_profile:
            sys.stderr.write("jpegtran: can't determine size of %s\n"
                             % a.iccfile)
            return 1
        if a.copy == "all":
            a.copy = "all_except_icc"
        elif a.copy == "icc":
            a.copy = "none"
    data = (open(a.input, "rb").read() if a.input
            else sys.stdin.buffer.read())
    img = transcode.read_coefficients(data)
    if a.maxscans is not None and len(img.jp.scans) > a.maxscans:
        # cdjpeg.c:39 exit(EXIT_FAILURE)
        sys.stderr.write("jpegtran: scan count exceeds -maxscans\n")
        return 1
    ops = []
    if a.flip == "horizontal":
        ops.append("flip_h")
    if a.flip == "vertical":
        ops.append("flip_v")
    if a.transpose:
        ops.append("transpose")
    if a.transverse:
        ops.append("transverse")
    if a.rotate:
        ops.append("rot%d" % a.rotate)
    if len(ops) > 1:
        # jpegtran.c select_transform: one image transformation at a time
        sys.stderr.write("jpegtran: can only do one image transformation "
                         "at a time\n")
        return 1
    if a.perfect:
        for op in ops:
            if not transcode.perfect_possible(img.jp, op):
                sys.stderr.write("jpegtran: transformation is not "
                                 "perfect\n")
                return 1
    # jpegtran default (no -trim) preserves partial edge iMCUs
    # untransformed (transupp.c no-crop variants); -trim drops them
    trim = a.trim
    if a.flip == "horizontal":
        img = transcode.flip_h(img, trim)
    elif a.flip == "vertical":
        img = transcode.flip_v(img, trim)
    if a.transpose:
        img = transcode.transpose(img)
    if a.transverse:
        img = transcode.transverse(img, trim)
    if a.rotate == 90:
        img = transcode.rot90(img, trim)
    elif a.rotate == 180:
        img = transcode.rot180(img, trim)
    elif a.rotate == 270:
        img = transcode.rot270(img, trim)
    if a.crop:
        img = transcode.crop_spec(img, transcode.parse_crop_spec(a.crop))
    if a.wipe:
        img = transcode.wipe_spec(img, transcode.parse_crop_spec(a.wipe))
    if a.drop:
        cs = transcode.parse_crop_spec(a.drop[0])
        src = transcode.read_coefficients(open(a.drop[1], "rb").read())
        xo, yo = transcode.resolve_drop_offsets(img.jp, src.jp, cs)
        img = transcode.drop(img, src, xo, yo, trim_requant=a.trim)
    if a.grayscale:
        # applied after the geometric transforms: the reference computes
        # all trim/crop geometry from the source sampling factors and only
        # drops chroma at write time (transupp.c:2048-2071)
        img = transcode.to_grayscale(img)

    restart_interval = restart_in_rows = 0
    if a.restart:
        # jpegtran.c:359-375: N = MCU rows, NB = MCUs
        if a.restart.lower().endswith("b"):
            restart_interval = int(a.restart[:-1])
        else:
            restart_in_rows = int(a.restart)
    scan_script = None
    if a.scans:
        from . import rdswitch
        try:
            with open(a.scans) as f:
                scan_text = f.read()
        except OSError as e:
            sys.stderr.write("jpegtran: can't open scans file %s: %s\n"
                             % (a.scans, e.strerror))
            return 1
        scan_script = rdswitch.read_scan_script(scan_text)

    profile = Profile.FASTEST if a.revert else Profile.MAX_COMPRESSION
    cfg = EncoderConfig(
        profile=profile,
        progressive=a.progressive,
        optimize_coding=a.optimize,
        optimize_scans=False if (a.fastcrush or a.revert) else None,
        trellis_quant=False,   # jpegtran never requantizes
        overshoot_deringing=False,
        arithmetic=a.arithmetic,
        restart_interval=restart_interval,
        restart_in_rows=restart_in_rows,
        scan_script=scan_script,
    )
    warnings = getattr(img.jp, "warnings", 0)
    if a.strict and warnings:
        # jpegtran.c:537-538: -strict makes decode warnings fatal
        sys.stderr.write("jpegtran: corrupt data encountered (warnings "
                         "treated as fatal)\n")
        return 1
    out = transcode.write_coefficients(img, cfg, a.copy, icc=icc_profile)
    if a.outfile:
        with open(a.outfile, "wb") as f:
            f.write(out)
    else:
        sys.stdout.buffer.write(out)
    # jpegtran.c:819-825: exit status 2 when corrupt-data warnings occurred
    return 2 if warnings else 0


if __name__ == "__main__":
    sys.exit(main())
