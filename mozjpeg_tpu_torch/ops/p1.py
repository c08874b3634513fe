"""p1's islow path as two hand-written CUDA kernels and their plain
PyTorch versions.

Ports of XLA code of mozjpeg_tpu/codec/pipeline_t.py: _p1_raw's islow
branch (deringing, the islow FDCT, quantization, the post-dering clamp,
zigzag), _norm_seq and the AC-first histogram of ops/symbols.py. In eager
PyTorch that is about 640 launches a component (the 64-step dering scan,
the butterflies, the zigzag gathers, 63 serial norm adds, the histogram's
cummax and bincount chain); on the card the wrappers instead launch
csrc/p1.cu twice a component:

  - p1_blocks: eight threads per 8x8 block, 32 blocks a CTA, read the
    component's samples straight from the plane view (a row a thread;
    any strides; uint8, or int32 above 8 bits), run the islow FDCT's rows
    and columns, quantize by a reciprocal multiply, and write q_zz (64,
    N) int16 and raw_zz (64, N) int32 coefficient-major in zigzag order,
    the f32 norm of every block, one flag byte a block (bit 0: a nonzero
    AC in [1, 63]; bit 1: coefficient 63 is zero), and add the
    within-block AC-first symbols (from each block's nonzero mask) into
    the image's (B, 256) histogram. Plain version: p1_blocks_plain,
    today's quantize, norm_seq and symbols.within_block_hist.
  - p1_eob_hist: the cross-block EOB runs of each image's restart
    segments, from the flag bytes, added into that histogram: a warp per
    tile of EOB_TILE blocks, the tiles' runs joined in the same launch
    (a small scratch kept per device and stream). Plain version:
    p1_eob_hist_plain over symbols.eob_run_hist.

The library is built with nvcc at first use into mozjpeg_tpu_torch/_build/
and called through ctypes on PyTorch's current stream. Tensors on the CPU
take the plain versions; anything else the kernels cannot take raises.
"""
from __future__ import annotations

import ctypes
import os
import threading
import time

import numpy as np
import torch

from ..consts import JPEG_ZIGZAG, JPEG_ZIGZAG_INV
from ..native import build as _build
from . import dct, dering, layout, quant, symbols
from .trellis_ac import nvcc_command

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "p1.cu")
LIB_NAME = "libp1.so"
PRECISIONS = (8, 12)
SAMPLE_TYPES = (torch.uint8, torch.int32)

EOB_TILE = 256      # blocks a warp of csrc/p1.cu's EOB kernel walks

_LIB = None
_LOCK = threading.Lock()
# the EOB kernel's scratch per (device, stream): (done, summ), int32
# counters that every launch leaves 0 and the tiles' summaries
_EOB_SCRATCH = {}
# callables given (kernel name, its arguments) just before each launch;
# chip_smoke.py holds every launch it records against the plain version
RECORDERS = []


def build():
    """Compile the kernels (if stale). Returns (seconds spent, the ptxas
    report lines of the build that made the library)."""
    t0 = time.perf_counter()
    out = _build.ensure_built(LIB_NAME, [SOURCE], nvcc_command)
    report = [ln.strip() for ln in out.splitlines()
              if "ptxas" in ln or "spill" in ln]
    return time.perf_counter() - t0, report


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            so = ctypes.CDLL(os.path.join(_build.BUILD_DIR, LIB_NAME))
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            so.mj_p1_blocks.restype = ci
            so.mj_p1_blocks.argtypes = [vp, ci, cl, cl, cl, ci, ci, ci, vp,
                                        ci, ci, vp, vp, vp, vp, vp, vp]
            so.mj_p1_eob_hist.restype = ci
            so.mj_p1_eob_hist.argtypes = [vp, vp, ci, cl, cl, vp, cl, vp, cl,
                                          vp]
            _LIB = so
    return _LIB


def reset_launches():
    """Set both kernels' launch counts to 0."""
    p1_blocks.launches = 0
    p1_eob_hist.launches = 0


def _qtable(qtbl) -> np.ndarray:
    q = np.asarray(qtbl).reshape(64).astype(np.int64)
    if q.min() < 1 or q.max() > 65535:
        raise ValueError("p1: quant values must lie in [1, 65535]")
    return q.astype(np.int32)


def p1_islow(plane: torch.Tensor, bh: int, bw: int, qtbl, dering_on: bool,
             ri: int = 0, precision: int = 8):
    """One component of a group through p1's islow path: plane (B, >=
    bh*8, >= bw*8) samples -> (q_zz (64, B*n) int16, raw_zz (64, B*n)
    int32, norm (B*n,) f32, AC-first histograms (B, 256) int32 over band
    [1, 63], segmented at the restart interval ri)."""
    q_zz, raw_zz, norm, hist, flags = p1_blocks(plane, bh, bw, qtbl,
                                                dering_on, precision)
    return q_zz, raw_zz, norm, p1_eob_hist(flags, hist, plane.shape[0], ri)


def p1_blocks(plane: torch.Tensor, bh: int, bw: int, qtbl, dering_on: bool,
              precision: int = 8):
    """The per-block chain of the bh x bw real blocks of each image of
    plane (B, >= bh*8, >= bw*8), uint8 or int32 samples in [0, 2^16), any
    strides; qtbl the 64 quant values in natural order (numpy) ->
    (q_zz (64, N) int16, raw_zz (64, N) int32, norm (N,) f32, hist (B,
    256) int32 of the within-block AC-first symbols, flags (N,) uint8),
    N = B*bh*bw image-major. On a CUDA tensor one launch (adding one to
    p1_blocks.launches), on the CPU the plain version."""
    dev = plane.device
    if (plane.dim() != 3 or plane.shape[1] < bh * 8 or plane.shape[2] < bw * 8
            or bh < 1 or bw < 1):
        raise ValueError("p1_blocks: plane must be (B, >= %d, >= %d), got %s"
                         % (bh * 8, bw * 8, tuple(plane.shape)))
    if plane.dtype not in SAMPLE_TYPES or precision not in PRECISIONS:
        raise ValueError("p1_blocks: takes uint8 or int32 samples at "
                         "precision 8 or 12, got %s at %d"
                         % (plane.dtype, precision))
    q = _qtable(qtbl)
    if dev.type == "cpu":
        return p1_blocks_plain(plane, bh, bw, q, dering_on, precision)
    if dev.type != "cuda":
        raise ValueError("p1_blocks: no kernel for device %s" % dev)
    b = plane.shape[0]
    n = b * bh * bw
    lib = _lib()
    q_zz = torch.empty((64, n), dtype=torch.int16, device=dev)
    raw_zz = torch.empty((64, n), dtype=torch.int32, device=dev)
    norm = torch.empty((n,), dtype=torch.float32, device=dev)
    hist = torch.zeros((b, 256), dtype=torch.int32, device=dev)
    flags = torch.empty((n,), dtype=torch.uint8, device=dev)
    tab = (ctypes.c_int * 64)(*q.tolist())
    for r in RECORDERS:
        r("p1_blocks", (plane, bh, bw, q, dering_on, precision))
    with torch.cuda.device(dev):
        rc = lib.mj_p1_blocks(
            plane.data_ptr(), plane.element_size(), *plane.stride(), b, bh,
            bw, ctypes.cast(tab, ctypes.c_void_p), int(bool(dering_on)),
            precision, q_zz.data_ptr(), raw_zz.data_ptr(), norm.data_ptr(),
            hist.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("p1_blocks kernel launch failed: CUDA error %d"
                           % rc)
    p1_blocks.launches += 1
    return q_zz, raw_zz, norm, hist, flags


def p1_blocks_plain(plane: torch.Tensor, bh: int, bw: int, qtbl,
                    dering_on: bool, precision: int = 8):
    """p1_blocks' function as PyTorch ops: quantize_islow_plain, norm_seq
    and block_symbols_plain."""
    q = _qtable(qtbl)
    q81 = torch.as_tensor(q.reshape(8, 8, 1), device=plane.device)
    q_zz, raw_zz = quantize_islow_plain(plane, bh, bw, q81, int(q[0]),
                                        dering_on, precision)
    norm = norm_seq(raw_zz)
    hist, flags = block_symbols_plain(q_zz, plane.shape[0])
    return q_zz, raw_zz, norm, hist, flags


def quantize_islow_plain(plane: torch.Tensor, bh: int, bw: int,
                         q81: torch.Tensor, q0: int, dering_on: bool,
                         precision: int = 8):
    """The real blocks of plane (B, >= bh*8, >= bw*8) -> (q_zz (64, N)
    int16, raw_zz (64, N) int32): [dering], islow FDCT, quantization by
    q81 (8, 8, 1) int32 on the plane's device, the post-dering clamp,
    zigzag. Uploads nothing, so a CUDA graph can capture it."""
    blocks = layout.blockify_t(
        plane[:, :bh * 8, :bw * 8].to(torch.int32) - (1 << (precision - 1)))
    # the dering threshold stays 255 - CENTERJSAMPLE's 8-bit literal at
    # every precision (jcdctmgr.c:419)
    if dering_on:
        blocks = layout.from_zigzag_t(
            dering.dering_t(layout.to_zigzag_t(blocks), q0))
    coeffs = dct.fdct_islow_t(blocks, dct.pass1_bits(precision))
    qz = quant.quantize_islow_t(coeffs, q81)
    if dering_on:
        # post-dering clamp (jcdctmgr.c:706,764)
        maxc = (1 << (precision + 2)) - 1
        qz = torch.clamp(qz, -maxc, maxc)
    return layout.to_zigzag_t(qz), layout.to_zigzag_t(coeffs)


def norm_seq(raw_zz: torch.Tensor) -> torch.Tensor:
    """Sequential f32 sum of squared AC coefficients in NATURAL index
    order (63 elementwise adds, the C reference's order)."""
    r = raw_zz.to(torch.float32)
    terms = r * r
    acc = torch.zeros(raw_zz.shape[1], dtype=torch.float32,
                      device=raw_zz.device)
    for zpos in JPEG_ZIGZAG_INV[1:]:
        acc = acc + terms[int(zpos)]
    return acc


def block_symbols_plain(q_zz: torch.Tensor, batch: int):
    """q_zz (64, B*n) -> (hist (B, 256) int32 of each image's
    within-block AC-first symbols over band [1, 63], flags (B*n,) uint8:
    bit 0 a nonzero AC, bit 1 coefficient 63 zero)."""
    band = q_zz[1:]
    hist = symbols.within_block_hist(band.reshape(63, batch, -1))
    nz = band != 0
    flags = nz.any(0).to(torch.uint8) | ((~nz[-1]).to(torch.uint8) << 1)
    return hist.to(torch.int32), flags


def p1_eob_hist(flags: torch.Tensor, hist: torch.Tensor, batch: int,
                ri: int = 0) -> torch.Tensor:
    """The cross-block EOB runs of the AC-first histograms: flags (B*n,)
    uint8 from p1_blocks, hist (B, 256) int32, ri the restart interval in
    blocks (0: one segment an image) -> hist with each image's EOB runs
    added, in place. On a CUDA tensor one launch (adding one to
    p1_eob_hist.launches), on the CPU the plain version."""
    dev = flags.device
    if (flags.dim() != 1 or flags.dtype != torch.uint8 or batch < 1
            or flags.numel() % batch or flags.numel() == 0):
        raise ValueError("p1_eob_hist: flags must be (B*n,) uint8, got %s "
                         "%s for B=%d" % (flags.dtype, tuple(flags.shape),
                                          batch))
    if (tuple(hist.shape) != (batch, 256) or hist.dtype != torch.int32
            or hist.device != dev or not hist.is_contiguous()
            or not flags.is_contiguous() or ri < 0):
        raise ValueError("p1_eob_hist: hist must be contiguous (%d, 256) "
                         "int32 on %s and ri >= 0" % (batch, dev))
    if dev.type == "cpu":
        return p1_eob_hist_plain(flags, hist, batch, ri)
    if dev.type != "cuda":
        raise ValueError("p1_eob_hist: no kernel for device %s" % dev)
    lib = _lib()
    for r in RECORDERS:
        r("p1_eob_hist", (flags, hist, batch, ri))
    n = flags.numel() // batch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        done, summ = _eob_scratch(dev, stream, batch,
                                  batch * -(-n // EOB_TILE))
        rc = lib.mj_p1_eob_hist(flags.data_ptr(), hist.data_ptr(), batch, n,
                                ri, summ.data_ptr(), summ.numel() // 2,
                                done.data_ptr(), done.numel(), stream)
    if rc != 0:
        raise RuntimeError("p1_eob_hist kernel launch failed: CUDA error %d"
                           % rc)
    p1_eob_hist.launches += 1
    return hist


def _eob_scratch(dev, stream, batch: int, tiles: int):
    """The EOB kernel's scratch on dev for launches on `stream` (one
    stream's launches run in turn, so they may share it): at least batch
    counters, zeroed once, and 2 * tiles ints of tile summaries."""
    key = (dev.index, stream)
    with _LOCK:
        done, summ = _EOB_SCRATCH.get(key, (None, None))
        if done is None or done.numel() < batch:
            done = torch.zeros(max(batch, 8), dtype=torch.int32, device=dev)
        if summ is None or summ.numel() < 2 * tiles:
            summ = torch.empty(2 * tiles, dtype=torch.int32, device=dev)
        _EOB_SCRATCH[key] = (done, summ)
    return done, summ


def p1_eob_hist_plain(flags: torch.Tensor, hist: torch.Tensor, batch: int,
                      ri: int = 0) -> torch.Tensor:
    """p1_eob_hist's function as PyTorch ops: symbols.eob_run_hist over
    each image's restart segments."""
    runs = symbols.by_segment(
        lambda f: symbols.eob_run_hist((f & 1) != 0, (f & 2) != 0),
        flags, batch, ri)
    return hist.add_(runs)


EDGE_N = 3 * EOB_TILE + 77     # one image's blocks in edge_flags


def edge_flags(seed: int = 0) -> np.ndarray:
    """Seeded (6, EDGE_N) flag bytes for the EOB kernel's tile edges, for
    tests and the smoke run (all-zero blocks 2, nonzero blocks 3 with a
    zero last coefficient or 1 without): in images 0-2 nonzero blocks at
    k * EOB_TILE + d, d = -1, 0, +1, so that runs end a block before, at
    and after each tile edge; in image 3 a run that starts in a tile's
    last block and one that ends at a tile's first; one nonzero block in
    image 4; image 5 all zero."""
    rng = np.random.default_rng(seed)
    f = np.full((6, EDGE_N), 2, np.uint8)
    for img, d in enumerate((-1, 0, 1)):
        at = [0] + [k * EOB_TILE + d for k in (1, 2, 3)]
        f[img, at] = rng.choice([1, 3], len(at))
    f[3, [EOB_TILE - 1, 2 * EOB_TILE - 1]] = 3
    f[3, [2 * EOB_TILE, 3 * EOB_TILE]] = rng.choice([1, 3], 2)
    f[4, 300] = 3
    return f


def example_plane(b: int, bh: int, bw: int, precision: int = 8,
                  seed: int = 0, ph: int = 0, pw: int = 0) -> np.ndarray:
    """Seeded numpy samples (b, max(ph, bh*8), max(pw, bw*8)), uint8 at 8
    bits and int32 in [0, 4096) at 12, for tests and the smoke run; past
    the bh x bw real blocks they are noise. The real blocks in raster
    order cycle through kinds: flat (all-zero AC, in runs of 1 to 80
    blocks, so that EOB runs cross 32-block chunks), noise, and
    deringing's edge cases in zigzag order: 0, 1, 63 and 64 clipped
    samples, runs at zigzag 0 and 63, one-sample runs, two runs one
    sample apart, a headroom under the caps, and mostly clipped blocks:
    at 12 bits their clipped samples lie far above the threshold (a
    negative headroom, so that the cap falls below 127) and the others
    just under it."""
    rng = np.random.default_rng(seed)
    top = (1 << precision) - 1
    clip = (1 << (precision - 1)) + 127   # the dering threshold
    n = b * bh * bw
    blocks = np.empty((n, 64), np.int64)

    def hi(k):
        return (rng.integers(clip, top + 1, k) if precision > 8
                else np.full(k, top))

    i = kind = 0
    while i < n:
        if kind % 3 == 0:           # a run of flat blocks
            run = min(int(rng.integers(1, 81)), n - i)
            blocks[i:i + run] = rng.integers(0, top + 1, (run, 1))
            i += run
        else:
            zz = rng.integers(0, clip, 64)
            case = int(rng.integers(0, 11))
            if case == 1:
                zz[int(rng.integers(0, 64))] = hi(1)[0]
            elif case == 2:
                zz[:] = hi(64)
                zz[int(rng.integers(0, 64))] = rng.integers(0, clip)
            elif case == 3:
                zz[:] = hi(64)
            elif case == 4:
                k = int(rng.integers(1, 20))
                zz[:k] = hi(k)
            elif case == 5:
                k = int(rng.integers(1, 20))
                zz[64 - k:] = hi(k)
            elif case == 6:
                zz[::2] = hi(32)
            elif case == 7:
                a = int(rng.integers(2, 40))
                zz[a:a + 3] = hi(3)
                zz[a + 4:a + 9] = hi(5)
            elif case == 8:
                zz[:] = hi(64)
                low = rng.random(64) < 0.2
                zz[low] = rng.integers(max(0, clip - 400), clip, low.sum())
            elif case == 9:
                zz[:] = rng.integers(clip - 6, clip, 64)
                zz[rng.random(64) < 0.5] = clip
            blocks[i][np.asarray(JPEG_ZIGZAG)] = zz
            i += 1
        kind += 1
    blocks = blocks.reshape(b, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4)
    plane = rng.integers(0, top + 1, (b, max(ph, bh * 8), max(pw, bw * 8)))
    plane[:, :bh * 8, :bw * 8] = blocks.reshape(b, bh * 8, bw * 8)
    return plane.astype(np.uint8 if precision == 8 else np.int32)


def adversarial_plane(kind: str, b: int, bh: int, bw: int,
                      precision: int = 12, seed: int = 0) -> np.ndarray:
    """Seeded numpy planes (b, bh*8, bw*8) built to break p1_blocks, for
    tests and the smoke run.

    wrap: int32 samples whose FDCT wraps int32, block kinds in turn: flat
    at 2^(precision-1) + 2^24 (at 12 bits the DC's column sum is 2^31,
    which wraps to INT_MIN and descales to -2^30, the largest |c| the
    FDCT can give: its pass-2 descale of at least one bit keeps |c| <=
    2^30, so |c| + 4q never reaches 2^31 and the quantizer's s < 0 branch
    is unreachable from samples), flat at the negated offset, any int32,
    and rows alternating INT_MIN and INT_MAX. Deringing is defined for
    samples of the precision only (the plain version sums them in f32),
    so these planes go with deringing off.
    clipped: samples of the precision, block kinds in turn: every sample
    clipped (at or above the dering threshold), half the zigzag positions
    clipped (even ones), the top four rows clipped, and noise below the
    threshold."""
    rng = np.random.default_rng(seed)
    n = b * bh * bw
    blocks = np.empty((n, 64), np.int64)
    center = 1 << (precision - 1)
    top = (1 << precision) - 1
    clip = center + 127
    for i in range(n):
        k = i % 4
        if kind == "wrap":
            if k == 0:
                blocks[i] = center + (1 << 24)
            elif k == 1:
                blocks[i] = center - (1 << 24)
            elif k == 2:
                blocks[i] = rng.integers(-2 ** 31, 2 ** 31, 64)
            else:
                blocks[i] = np.repeat(np.where(np.arange(8) % 2, 2 ** 31 - 1,
                                               -2 ** 31), 8)
        else:
            zz = rng.integers(0, clip, 64)
            if k == 0:
                zz[:] = rng.integers(clip, top + 1, 64)
            elif k == 1:
                zz[::2] = rng.integers(clip, top + 1, 32)
            elif k == 2:
                zz[:] = 0
                nat = np.zeros(64, np.int64)
                nat[:32] = rng.integers(clip, top + 1, 32)
                nat[32:] = rng.integers(0, clip, 32)
                zz = nat[np.asarray(JPEG_ZIGZAG)]
            blocks[i][np.asarray(JPEG_ZIGZAG)] = zz
    plane = blocks.reshape(b, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4)
    plane = plane.reshape(b, bh * 8, bw * 8)
    if kind == "wrap":
        return plane.astype(np.int32)
    return plane.astype(np.uint8 if precision == 8 else np.int32)


reset_launches()
