"""Rate-distortion harness, the mozjpeg rd_collect workflow (reference
contrib/rd_collect.sh): sweep qualities over a corpus, record bytes, bpp,
PSNR and SSIM per image per setting, write TSV or JSON.

Port of the repo's root rd_collect.py, the same flags, rows, TSV, JSON
and SVG; each image and quality is one encode() and one decode() on the
GPU (main's device argument; "cpu" for the kernels' plain versions and
the host engine).

Usage: python -m mozjpeg_tpu_torch.cli.rd_collect corpus/*.ppm
       [-q 50,60,...,95] [-o out.tsv] [-profile max|fast]
       [-subsamp 420|422|444] [-json] [-average] [-plot curve.svg]

-average emits per-quality corpus means (the rd_average.sh analog);
-plot writes a dependency-free SVG RD curve (the rd_plot.sh analog).
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from ..codec.config import EncoderConfig, Profile
from ..codec.encoder import _device
from ..utils import ppm


def psnr(a, b, maxval=255.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(maxval * maxval / mse)


def ssim(a, b):
    """Global SSIM on the luma plane (8x8 windows, standard constants)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 3:
        a = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
        b = 0.299 * b[..., 0] + 0.587 * b[..., 1] + 0.114 * b[..., 2]
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    h, w = a.shape
    h8, w8 = h - h % 8, w - w % 8
    aw = a[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8).transpose(0, 2, 1, 3)
    bw = b[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8).transpose(0, 2, 1, 3)
    mu_a = aw.mean(axis=(2, 3))
    mu_b = bw.mean(axis=(2, 3))
    va = aw.var(axis=(2, 3))
    vb = bw.var(axis=(2, 3))
    cov = (aw * bw).mean(axis=(2, 3)) - mu_a * mu_b
    s = (((2 * mu_a * mu_b + c1) * (2 * cov + c2))
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))
    return float(s.mean())


def average_rows(rows):
    """Per-quality corpus means, pixels-weighted for bpp like
    rd_average.sh's awk aggregation (sums bytes and pixels per quality)."""
    agg = {}
    for r in rows:
        a = agg.setdefault(r["quality"], {
            "n": 0, "bytes": 0, "pixels": 0, "psnr": 0.0, "ssim": 0.0})
        a["n"] += 1
        a["bytes"] += r["bytes"]
        a["pixels"] += int(round(8.0 * r["bytes"] / r["bpp"]))
        a["psnr"] += r["psnr"]
        a["ssim"] += r["ssim"]
    out = []
    for q in sorted(agg):
        a = agg[q]
        out.append({"image": "<average:%d>" % a["n"], "quality": q,
                    "bytes": a["bytes"] // a["n"],
                    "bpp": 8.0 * a["bytes"] / a["pixels"],
                    "psnr": round(a["psnr"] / a["n"], 4),
                    "ssim": round(a["ssim"] / a["n"], 6)})
    return out


def write_svg_plot(path, rows):
    """Dependency-free SVG RD curve: bpp (x) vs PSNR dB (y)."""
    pts = sorted((r["bpp"], r["psnr"]) for r in rows)
    if not pts:
        return
    W, H, M = 640, 420, 48
    x0, x1 = min(p[0] for p in pts), max(p[0] for p in pts)
    y0, y1 = min(p[1] for p in pts), max(p[1] for p in pts)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0

    def sx(x):
        return M + (x - x0) / xr * (W - 2 * M)

    def sy(y):
        return H - M - (y - y0) / yr * (H - 2 * M)

    poly = " ".join("%.1f,%.1f" % (sx(x), sy(y)) for x, y in pts)
    ticks = []
    for i in range(5):
        xv = x0 + xr * i / 4
        yv = y0 + yr * i / 4
        ticks.append('<text x="%.1f" y="%d" font-size="11" '
                     'text-anchor="middle">%.2f</text>'
                     % (sx(xv), H - M + 16, xv))
        ticks.append('<text x="%d" y="%.1f" font-size="11" '
                     'text-anchor="end">%.1f</text>'
                     % (M - 6, sy(yv) + 4, yv))
    svg = ('<svg xmlns="http://www.w3.org/2000/svg" width="%d" height="%d">'
           '<rect width="%d" height="%d" fill="white"/>'
           '<rect x="%d" y="%d" width="%d" height="%d" fill="none" '
           'stroke="#888"/>'
           '<polyline points="%s" fill="none" stroke="#1a6faa" '
           'stroke-width="2"/>'
           '%s'
           '<text x="%d" y="%d" font-size="12" text-anchor="middle">'
           'bits per pixel</text>'
           '<text x="14" y="%d" font-size="12" text-anchor="middle" '
           'transform="rotate(-90 14 %d)">PSNR (dB)</text>'
           '</svg>\n'
           % (W, H, W, H, M, M, W - 2 * M, H - 2 * M, poly,
              "".join(ticks), W // 2, H - 8, H // 2, H // 2))
    with open(path, "w") as f:
        f.write(svg)


def build_parser():
    p = argparse.ArgumentParser(prog="rd_collect")
    p.add_argument("images", nargs="+")
    p.add_argument("-q", default="50,60,70,75,80,85,90,95")
    p.add_argument("-o", default=None)
    p.add_argument("-profile", default="max", choices=["max", "fast"])
    p.add_argument("-subsamp", default=None,
                   choices=[None, "420", "422", "444"])
    p.add_argument("-json", action="store_true", dest="as_json")
    p.add_argument("-average", action="store_true",
                   help="aggregate per-quality means over the corpus "
                        "(rd_average.sh)")
    p.add_argument("-plot", default=None, metavar="SVG",
                   help="write an SVG RD curve (bpp vs PSNR, rd_plot.sh)")
    return p


def config(quality: int, profile: str, subsamp) -> EncoderConfig:
    """The encoder configuration of one quality: mozjpeg's full default
    (max) or the fastest baseline (fast), at the subsampling asked for."""
    kw = {}
    if profile == "fast":
        kw = dict(profile=Profile.FASTEST, progressive=False,
                  optimize_scans=False, trellis_quant=False,
                  overshoot_deringing=False)
    if subsamp:
        kw["subsampling"] = {"420": (2, 2), "422": (2, 1),
                             "444": (1, 1)}[subsamp]
    return EncoderConfig(quality=quality, **kw)


def main(argv=None, device=None):
    """Run rd_collect with `argv` (sys.argv[1:] by default) on `device`:
    None or "cuda" (the default, the GPU; raises RuntimeError without
    one) or "cpu". Returns the exit code."""
    a = build_parser().parse_args(argv)
    dev = _device(device)
    from ..codec.decoder import decode
    from ..codec.encoder import encode

    quals = [int(v) for v in a.q.split(",")]
    rows = []
    for path in a.images:
        img = ppm.read(path)
        h, w = img.shape[:2]
        pixels = w * h
        for q in quals:
            data = encode(img, config(q, a.profile, a.subsamp), device=dev)
            rec = decode(data, device=dev)
            rows.append({
                "image": path, "quality": q, "bytes": len(data),
                "bpp": 8.0 * len(data) / pixels,
                "psnr": round(psnr(img, rec), 4),
                "ssim": round(ssim(img, rec), 6),
            })
            print("%s q%d: %d bytes  %.4f bpp  %.2f dB  ssim %.4f"
                  % (path, q, len(data), rows[-1]["bpp"], rows[-1]["psnr"],
                     rows[-1]["ssim"]), file=sys.stderr)

    if a.average:
        rows = average_rows(rows)
    if a.plot:
        write_svg_plot(a.plot, average_rows(rows) if not a.average else rows)
    out = sys.stdout if a.o is None else open(a.o, "w")
    if a.as_json:
        json.dump(rows, out, indent=1)
        out.write("\n")
    else:
        out.write("image\tquality\tbytes\tbpp\tpsnr\tssim\n")
        for r in rows:
            out.write("%s\t%d\t%d\t%.4f\t%.4f\t%.6f\n"
                      % (r["image"], r["quality"], r["bytes"], r["bpp"],
                         r["psnr"], r["ssim"]))
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
