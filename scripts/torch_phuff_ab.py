"""The port's progressive AC coders, the bitmap walk (native/entropy.cpp
mj_encode_ac_first, mj_encode_ac_refine) against their plain twins
(mj_encode_ac_{first,refine}_plain), on real and dense planes:

    python3 scripts/torch_phuff_ab.py [--seed N] [--threads 1,8]
        [--device cuda] [--size 4032x3024]

Planes: one 4032x3024 photo of portbench's recipe (core/images.py),
encoded on the CUDA card by the port at mozjpeg's q75 default (its three
components' final coefficients, as the scan search gets them), and one
seeded dense 12-bit plane of 504x378 blocks. Each pass codes every AC
scan of the scan search's script (native/scansearch.cpp build_script)
on each component: a gather, then an emission with the optimal tables
of its counts. A line gives, per plane set, coder and thread count, the
gather and emission CPU ms per megapixel summed over the scans, and the
wall time; with n threads each codes its own copy of the planes at once,
as n images' searches do. Every pass of the walk is checked against the
twin's counts and bytes first. Prints the card, its power limit and the
host's CPU.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mozjpeg_tpu_torch import native  # noqa: E402
from mozjpeg_tpu_torch.entropy.encode import gen_optimal_table  # noqa: E402
from mozjpeg_tpu_torch.entropy.huffman import derive_codes  # noqa: E402

SPLITS = (2, 8, 5, 12, 18)


def scans(luma: bool):
    """(Ss, Se, Ah, Al) of a component's AC scans in build_script."""
    al_max = 3 if luma else 2
    out = [(1, 8, 0, 0), (9, 63, 0, 0)]
    for al in range(al_max):
        out += [(1, 63, al + 1, al), (1, 8, 0, al + 1), (9, 63, 0, al + 1)]
    out.append((1, 63, 0, 0))
    for f in SPLITS:
        out += [(1, f, 0, 0), (f + 1, 63, 0, 0)]
    return out


def photo_planes(seed: int, device: str, w: int, h: int):
    """[(plane, bw, bh, luma)] of one photo's final coefficients."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import scanopt
    from portbench.core import images
    dev = torch.device(device)
    params, noise = images.generators(seed, dev)
    img = images.photo(h, w, params, noise, dev).cpu().numpy()
    got = []
    real = scanopt.encode_optimize_scans_native

    def record(*a, **kw):
        got.append(a)
        return real(*a, **kw)
    scanopt.encode_optimize_scans_native = record
    try:
        mjt.encode_many([img], mjt.EncoderConfig(quality=75), device=dev)
    finally:
        scanopt.encode_optimize_scans_native = real
    _, _, geom, planes = got[0][:4]
    return [(np.ascontiguousarray(p), g.bw, g.bh, ci == 0)
            for ci, (p, g) in enumerate(zip(planes, geom[2]))]


def dense12_plane(seed: int, bh=378, bw=504):
    """[(plane, bw, bh, True)]: ~41 nonzero AC a block, 12-bit range."""
    rng = np.random.default_rng(seed)
    k = np.arange(64)
    scale = 300.0 * np.exp(-k / 14.0)
    p = np.rint(rng.laplace(0, 1, (bh, bw, 64)) * scale)
    p[rng.random((bh, bw, 64)) < 0.3 * (1 + k / 63.0)] = 0
    p = np.clip(p, -16383, 16383).astype(np.int16)
    return [(p, bw, bh, True)]


def comp(p, bw, bh):
    c = native.CompPlane()
    c.coef = p.ctypes.data
    c.bw, c.bh, c.stride = bw, bh, p.shape[1]
    c.h = c.v = 1
    c.dc_tbl = c.ac_tbl = 0
    return c


class Coder:
    """One thread's buffers and the two coders of a plane set."""

    def __init__(self, planes):
        self.planes = planes
        cap = max(bw * bh for _, bw, bh, _ in planes) * 192 + 65536
        self.out = np.empty(cap, np.uint8)
        self.counts = np.zeros((4, 257), np.int64)

    def call(self, fn, plain, c, scan, tables):
        Ss, Se, _, Al = scan
        gather = tables is None
        self.counts[:] = 0
        co, si = tables if tables else (np.zeros(1024, np.uint32),
                                        np.zeros(1024, np.uint8))
        args = [ctypes.byref(c), Ss, Se, Al, 0,
                co.ctypes.data_as(native.u32p),
                si.ctypes.data_as(native.u8p),
                self.out.ctypes.data_as(native.u8p), self.out.size,
                self.counts.ctypes.data_as(native.i64p), int(gather)]
        if not plain:
            args.append(None)
        t0 = time.perf_counter()
        n = fn(*args)
        dt = time.perf_counter() - t0
        if n < 0:
            raise RuntimeError("coder failed on scan %s" % (scan,))
        return dt, n

    def run(self, plain: bool, tables, check=None):
        """Every AC scan of every component -> (gather s, emission s);
        fills `tables` per (component, scan) on the first pass, and with
        check (a dict) keeps each pass's counts and bytes."""
        lib = native.lib()
        tg = te = 0.0
        for ci, (p, bw, bh, luma) in enumerate(self.planes):
            c = comp(p, bw, bh)
            for scan in scans(luma):
                kind = "refine" if scan[2] else "first"
                fn = getattr(lib, "mj_encode_ac_%s%s" % (
                    kind, "_plain" if plain else ""))
                dt, n = self.call(fn, plain, c, scan, None)
                tg += dt
                key = (ci, scan)
                if key not in tables:
                    co = np.zeros(1024, np.uint32)
                    si = np.zeros(1024, np.uint8)
                    co[:256], si[:256] = derive_codes(
                        gen_optimal_table(self.counts[0].copy()))
                    tables[key] = (co, si)
                if check is not None:
                    check[key] = [self.counts[0].copy()]
                dt, n = self.call(fn, plain, c, scan, tables[key])
                te += dt
                if check is not None:
                    check[key].append(bytes(self.out[:n]))
        return tg, te


def measure(label, planes, threads, tables):
    mp = sum(bw * bh for _, bw, bh, luma in planes if luma) * 64 / 1e6
    copies = [planes] + [[(p.copy(), bw, bh, luma)
                          for p, bw, bh, luma in planes]
                         for _ in range(threads - 1)]
    coders = [Coder(c) for c in copies]
    res = {}
    # parent, change, change, parent
    for plain in (True, False, False, True):
        times = [None] * threads

        def work(i):
            times[i] = coders[i].run(plain, tables)
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(threads)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        g = sum(t[0] for t in times) / threads
        e = sum(t[1] for t in times) / threads
        res.setdefault(plain, []).append((g, e, wall))
    for plain in (True, False):
        g = np.mean([r[0] for r in res[plain]])
        e = np.mean([r[1] for r in res[plain]])
        w = np.mean([r[2] for r in res[plain]])
        print("%s %s threads %d: gather %.3f ms/MP, emission %.3f ms/MP "
              "(CPU a thread, %d scans), wall %.3f s" % (
                  label, "plain" if plain else "walk ", threads,
                  1e3 * g / mp, 1e3 * e / mp,
                  sum(len(scans(lu)) for _, _, _, lu in planes), w),
              flush=True)
    gp = np.mean([r[0] for r in res[True]])
    gw = np.mean([r[0] for r in res[False]])
    ep = np.mean([r[1] for r in res[True]])
    ew = np.mean([r[1] for r in res[False]])
    print("%s threads %d: gather %.2fx, emission %.2fx faster" % (
        label, threads, gp / gw, ep / ew), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--threads", default="1,8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="4032x3024")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))
    for cmd in (["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], ["lscpu"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True).stdout
        except OSError:
            out = "(%s not found)\n" % cmd[0]
        keep = ("Model name", "CPU(s):", "Thread(s) per core", "L3")
        print("".join(line + "\n" for line in out.splitlines()
                      if cmd[0] != "lscpu" or line.startswith(keep)),
              end="", flush=True)
    sets = [("photo%dx%d" % (w, h), photo_planes(args.seed, args.device,
                                                  w, h)),
            ("dense12bit", dense12_plane(args.seed))]
    for label, planes in sets:
        nz = np.mean([(p[:bh, :bw, 1:] != 0).sum(-1).mean()
                      for p, bw, bh, _ in planes])
        print("%s: %s, %.2f nonzero AC a block (mean over components)" % (
            label, ", ".join("%dx%d" % (bw, bh) for _, bw, bh, _ in planes),
            nz), flush=True)
        tables = {}
        plain, walk = {}, {}
        Coder(planes).run(True, tables, plain)
        Coder(planes).run(False, tables, walk)
        for key in plain:
            if not (np.array_equal(plain[key][0], walk[key][0])
                    and plain[key][1] == walk[key][1]):
                raise SystemExit("%s: the walk differs from its twin on "
                                 "component %d scan %s" % (label, *key))
        print("%s: every gather and emission equals the twin's" % label,
              flush=True)
        for n in (int(t) for t in args.threads.split(",")):
            measure(label, planes, n, tables)
    return 0


if __name__ == "__main__":
    sys.exit(main())
