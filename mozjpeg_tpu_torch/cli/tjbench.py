"""tjbench-compatible benchmark: compress and decompress throughput through
the TurboJPEG API (reference tjbench.c), with the tile modes of its
decompTest through lossless crop transforms.

Port of the repo's root tjbench.py, the same flags, lines and JSON; the
codec runs on the GPU (main's device argument; "cpu" for the kernels'
plain versions and the host engine).

Usage: python -m mozjpeg_tpu_torch.cli.tjbench image.ppm [quality]
       [-subsamp 444|422|420|gray] [-progressive] [-optimize]
       [-arithmetic] [-scale N/D] [-reps N] [-warmup N] [-tile] [-json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import turbojpeg as tj
from ..codec.encoder import _device
from ..utils import ppm

_SUBSAMP = {"444": tj.TJSAMP_444, "422": tj.TJSAMP_422,
            "420": tj.TJSAMP_420, "gray": tj.TJSAMP_GRAY}


def build_parser():
    p = argparse.ArgumentParser(prog="tjbench")
    p.add_argument("image")
    p.add_argument("quality", type=int, nargs="?", default=95)
    p.add_argument("-subsamp", default="420", choices=list(_SUBSAMP))
    p.add_argument("-progressive", action="store_true")
    p.add_argument("-optimize", action="store_true")
    p.add_argument("-arithmetic", action="store_true")
    p.add_argument("-scale", default=None)
    p.add_argument("-reps", type=int, default=8)
    p.add_argument("-warmup", type=int, default=2)
    p.add_argument("-tile", action="store_true",
                   help="decompose into tiles at 8x8..128x128 granularity "
                        "via lossless crop transforms and decode each "
                        "(tjbench.c decompTest tile modes)")
    p.add_argument("-json", action="store_true", dest="as_json")
    return p


def tile_sizes(subsamp: str):
    """The (width, height) tiles of 8..128 pixels, each at least one
    iMCU of the subsampling."""
    imw = 16 if subsamp in ("420", "422") else 8
    imh = 16 if subsamp == "420" else 8
    sizes = []
    for tw in (8, 16, 32, 64, 128):
        mw, mh = max(tw, imw), max(tw, imh)
        if (mw, mh) not in sizes:
            sizes.append((mw, mh))
    return sizes


def main(argv=None, device=None):
    """Run tjbench with `argv` (sys.argv[1:] by default) on `device`:
    None or "cuda" (the default, the GPU; raises RuntimeError without
    one) or "cpu". Returns the exit code."""
    a = build_parser().parse_args(argv)
    dev = _device(device)
    img = ppm.read(a.image)
    h, w = img.shape[:2]
    mp = w * h / 1e6
    t = tj.TJ(device=dev)
    t.set(tj.TJPARAM_QUALITY, a.quality)
    t.set(tj.TJPARAM_SUBSAMP, _SUBSAMP[a.subsamp])
    t.set(tj.TJPARAM_PROGRESSIVE, int(a.progressive))
    t.set(tj.TJPARAM_OPTIMIZE, int(a.optimize))
    t.set(tj.TJPARAM_ARITHMETIC, int(a.arithmetic))

    def bench(fn):
        for _ in range(a.warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(a.reps):
            fn()
        return a.reps * mp / (time.perf_counter() - t0)

    data = t.compress(img)
    comp_mps = bench(lambda: t.compress(img))
    if a.scale:
        num, den = (int(v) for v in a.scale.split("/"))
        t.set_scaling_factor(num, den)
    dec = t.decompress(data)
    dec_mps = bench(lambda: t.decompress(data))

    res = {
        "image": a.image, "width": w, "height": h,
        "quality": a.quality, "subsamp": a.subsamp,
        "jpeg_bytes": len(data),
        "ratio": w * h * (1 if img.ndim == 2 else 3) / len(data),
        "compress_mps": round(comp_mps, 3),
        "decompress_mps": round(dec_mps, 3),
    }
    if a.tile:
        full = t.decompress(data)
        # 420/422 tiles are not pixel-identical to the full decode at tile
        # boundaries (chroma upsampling loses its neighbour context, as in
        # the reference's tiled decompression); 444 and gray tiles are
        # exact
        for mw, mh in tile_sizes(a.subsamp):
            t0 = time.perf_counter()
            out = np.zeros_like(full)
            ntiles = 0
            for y in range(0, h, mh):
                for x in range(0, w, mw):
                    cw = min(mw, w - x)
                    ch = min(mh, h - y)
                    piece = t.transform(data, crop=(x, y, cw, ch))
                    out[y:y + ch, x:x + cw] = t.decompress(piece)
                    ntiles += 1
            dt = time.perf_counter() - t0
            ok = bool((out == full).all())
            res["tile_%dx%d" % (mw, mh)] = {
                "tiles": ntiles, "mps": round(mp / dt, 3), "exact": ok}
            if not a.as_json:
                print("Tile %3dx%-3d --> %8.3f MP/s   (%d tiles%s)"
                      % (mw, mh, mp / dt, ntiles,
                         "" if ok else ", PIXEL MISMATCH"))

    if a.as_json:
        print(json.dumps(res))
    else:
        print(">>>>>  %dx%d  quality %d  %s  <<<<<"
              % (w, h, a.quality, a.subsamp))
        print("Compress    --> %8.3f MP/s   (%d bytes, ratio %.2f:1)"
              % (comp_mps, len(data), res["ratio"]))
        print("Decompress  --> %8.3f MP/s   (output %s)"
              % (dec_mps, "x".join(map(str, dec.shape))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
