"""Build recipe for the port's native host library.

The port keeps its own copy of the C++ host engine: the .cpp files beside
this module, taken byte for byte from the JAX package's mozjpeg_tpu/native
at commit 0d0dbf6, compile into a library of the port's own under
mozjpeg_tpu_torch/_build/. Nothing outside the port's package is read.
Since then the port's scansearch.cpp has gained the search's counters and
the worker threads that every search in flight shares, and its
entropy.cpp codes the progressive AC scans by a per-block nonzero bitmap
(an AVX2 prepare where -march=native offers it, a scalar one otherwise)
beside the old coders as plain twins; the JAX package's copies have
none of these.
The sources:

  entropy.cpp     mj_gen_optimal_table, the scan encoders and decoders,
                  and the transfer codecs' host halves (mj_sparse_expand_flat,
                  mj_transport_decode)
  scansearch.cpp  mj_scan_search (the jpegrescan candidate sweep) and its
                  worker threads (mj_search_workers_new / _free)
  prep.cpp        mj_prep_ycc (RGB -> YCbCr + chroma downsampling)
  hostenc.cpp     the host engine: p1, AC-first histograms, the AC and DC
                  trellis, the arithmetic trellis's row steps, and the
                  host decode render's dequant + islow IDCT (mj_host_render)
  arith.cpp       the arithmetic scan encoders and the coder context the
                  arithmetic trellis trains (rates, restarts, training)
  quant.cpp       the colour quantizers of djpeg -colors and -map (one-
                  and two-pass, and to a supplied colormap)
  imageio.cpp     the GIF LZW codec and the Targa RLE decoder of the
                  image writers and readers (utils/gif.py, utils/targa.py)
  lossless.cpp    the lossless (SOF3) predictor coder and decoder
                  (codec/lossless.py)
  post.cpp        the host decode's upsampling + colour conversion
                  (mj_post_ycc) and the superblock sparse pack
                  (mj_sparse_count, mj_sparse_pack)
  planepack.cpp   the sample-plane pack and expand of the transfer codecs
                  (mj_plane_pack, mj_plane_expand; ops/planepack.py)

The flags are a copy of mozjpeg_tpu/native/build.py's: -ffp-contract=off
keeps every f32 product rounded before it feeds an add, and
MJ_NATIVE_PORTABLE=1 drops -march=native.
"""
from __future__ import annotations

import fcntl
import os
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")

SOURCES = ("entropy.cpp", "scansearch.cpp", "prep.cpp", "hostenc.cpp",
           "arith.cpp", "quant.cpp", "imageio.cpp", "lossless.cpp",
           "post.cpp", "planepack.cpp")
LIB_NAME = "libmjport.so"

BASE_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
              "-ffp-contract=off", "-DNDEBUG"]


def compile_flags() -> list:
    flags = list(BASE_FLAGS)
    if os.environ.get("MJ_NATIVE_PORTABLE") != "1":
        flags.insert(1, "-march=native")
    return flags


def ensure_built(out_name: str, sources, command) -> str:
    """Build BUILD_DIR/out_name from `sources` with command(srcs, out)
    unless it is newer than every source and was built by the same
    command (the command is kept beside it as out_name.cmd, so that a
    changed source list rebuilds). Safe across processes: the build runs
    under a file lock and the output is renamed into place. Returns the
    compiler's output of the build that made the library, kept beside it
    as out_name.log; a failed build raises with it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, out_name)
    log, stamp = out + ".log", out + ".cmd"
    cmd = " ".join(command(list(sources), out))
    with open(os.path.join(BUILD_DIR, out_name + ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not (os.path.exists(out) and os.path.exists(log)
                and os.path.exists(stamp) and _read(stamp) == cmd
                and all(os.path.getmtime(out) >= os.path.getmtime(s)
                        for s in sources)):
            tmp = "%s.%d.tmp" % (out, os.getpid())
            res = subprocess.run(command(list(sources), tmp),
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("building %s failed:\n%s%s"
                                   % (out_name, res.stdout, res.stderr))
            with open(log, "w") as f:
                f.write(res.stdout + res.stderr)
            os.replace(tmp, out)
            with open(stamp, "w") as f:
                f.write(cmd)
        return _read(log)


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def build_native() -> float:
    """Build (if stale) the host library; returns the seconds spent."""
    t0 = time.perf_counter()
    srcs = [os.path.join(SRC_DIR, s) for s in SOURCES]
    ensure_built(LIB_NAME, srcs,
                 lambda s, o: ["g++", *compile_flags(), *s, "-o", o])
    return time.perf_counter() - t0
