#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # about eleven minutes

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. the card's name and power limit (nvidia-smi);
  2. build the native host library and the CUDA kernels from the
     checkout, in parallel, with their build times, and the report of
     ptxas from the builds that made the kernels (registers, spills,
     shared memory);
  3. the AC trellis kernel against its plain PyTorch version on the card,
     exactly: on the inputs that one 768x512 group and the 1021x683 group
     give it, on a seeded tie-stress input and on bands (1, 8) and
     (9, 63), on an all-zero input, a fully dense one, ragged tiles with an
     odd N (B = 3, n_img = 1,001) and N = 1; the DC trellis kernel
     (csrc/trellis_rows.cu) against its plain version, exactly, on both
     groups' launches, a tie-stress input, 12-bit inputs that wrap int32
     and clamp at 16383, the delta weight at v = 2 with an odd bh, a
     2048-block row, every candidate tied at nc 1, 2, 8 and 9 with bw 1
     and 33, a 260-block row (past one tile of the per-row pass) and a
     12 MP luma component; the EOB-run DP kernel on seeded strips (all-zero
     rows, runs past 16, BIG costs); p1's two kernels (csrc/p1.cu) on
     every launch of both groups and on ops/p1.example_plane's seeded
     planes (deringing's edge cases, long flat runs; uint8 and int32
     samples; views into one buffer and a channel view; B = 8 and 1;
     deringing on and off; restart intervals 0, 1, 5, n - 1, n, n + 3),
     and p1_eob_hist on runs that end beside and on its tile edges, one
     nonzero block and an all-zero image (restart intervals 0, 1, 5, 255,
     256, 257, n - 1, n, n + 3) and on a 12 MP plane's flags (745 tiles,
     a run past 0x7FFF; intervals 0, 504, 0x7FFF), p1_blocks on
     ops/p1.adversarial_plane's planes (int32 samples whose FDCT wraps,
     the DC at -2^30, at quant values 1, 65535 and a ramp; all-, half-
     and top-half-clipped blocks with deringing) and a view with a column
     stride at an odd offset, each output exactly equal to the plain
     version's; the EOB-run DP on adversarial rows (every cost tied, all
     zero, every other block all zero, keep-heavy) at L = 1, 31, 32, 33,
     96, 504, 513 and 1,024; the card's lambda
     of both groups against the CPU's and numpy's, exactly;
  4. the slice: encode_many of sixteen 768x512 and three 1021x683 seeded
     photo-like images on the card, warm-up first, on the device-tablegen
     route (3 trellis_ac, 3 trellis_dc, 3 of each p1 kernel and 1
     tablegen launches a group, no EOB-run DP), every p1 launch of the
     warm-up held against the plain versions; every output
     starts with SOI and ends with EOI, and the first and last image of
     each shape are byte-equal to the port's device="cpu" path;
  5. decode of the nineteen JPEGs of phase 4 on the card, warm-up first:
     decode_many's RGB for images 0, 7, 16 and 18 equals the port's
     device="cpu" path, every image's PSNR against its source photo is
     at least 25 dB; decode() of image 0, decode_many of image 0 cut to
     two thirds of its bytes plus EOI (block smoothing) and decode_many's
     YUV output of the first eight equal the CPU path; decode_many's
     median MP/s over 3 reps, the stage times of one 8x768x512 group
     (parse and entropy on the host, upload, render, download;
     synchronised), and the render's time per group, as the sum of its
     device kernels (torch.profiler) and between CUDA events (held, and
     with the host's launch gaps), beside its bytes bound;
  6. encode timings: median MP/s over 3 reps, per-stage times of one
     group (synchronised instrumented pass), and with MJ_DEV_FIRST 1 and 0
     in turns (same bytes), the kernel's time per group
     beside its plain version's and its bound, and the same on the dense
     input; each kernel time both with the card's queue held (device time
     alone) and without (the host's launch gaps counted too); the DC
     trellis stage of one group (its 3 launches) with the kernel and with
     the plain version in turns, the kernel's time held and with gaps,
     the plain version's, the bound and the chain's steps, and
     torch.profiler's device time, kernel count and top kernels of the
     stage both ways and of the group's p1; where the DC kernel's time
     goes (the luma launch through the instantiation that counts SM
     cycles: the per-row pass, the chain, the walk back, the output);
     each p1 kernel over the
     group's 3 launches, held, with gaps, its plain version and its bound
     (bytes, or integer operations at the INT32 rate); the p1 stage with
     the kernels and with the plain versions in turns (synchronised) and
     under torch.profiler, split by kernel name; the
     plain p1 without its histogram replayed as one CUDA graph (a
     yardstick only); an empty kernel's launch, held and with gaps (the
     practical floor beside each bytes bound);
  7. the config matrix: for each configuration family of the batched
     encode surface (grayscale from 2-D planes and from RGB, RGB, CMYK
     and YCCK from seeded 4-channel images, device prep, smoothing, the
     ifast and float DCTs, restarts, sequential, standard tables,
     FASTEST, the simple script, the trellis options, quant tables and
     markers) one 768x512 and one 1021x683 corpus image on the card, with
     SOI/EOI and the same bytes twice, and the card's bytes equal to the
     CPU path's on a 256x192 and a 131x97 crop; the trellis kernel
     against its plain version, exactly with `ei`, on the launches of the
     grayscale, CMYK, use_scans_in_trellis and trellis_eob_opt groups,
     and the row-scan kernels on their DC and EOB launches; every p1
     launch of each family's first full-size encode and of the recorded
     groups against the plain versions (both p1 kernels on islow, none
     on ifast or float);
     encode_many median MP/s over 3 reps of the 19-image corpus for nine
     families beside the default's, with the stage times of one
     8x768x512 group for the three slowest, with the row-scan kernels'
     and p1 launches of each timed family; the EOB-run DP of the
     trellis_eob_opt
     group (3 launches) with the kernel and the plain version in turns,
     held, with gaps and bound; the device time and kernel count of the
     EOB-run DP (kernel and plain), the device prep and the float DCT per
     group (torch.profiler);
  8. the per-image routes: serial encode() of a 768x512 and the 1021x683
     image on the card against encode(..., device="cpu") (the host
     engine), byte-equal, with the median of 5 warm calls each way; the
     families the batched route does not carry (the arithmetic trellis,
     on one full-size image, sequential with restarts too, trellis_q_opt
     and qslots) and arithmetic coding without the trellis, checked as
     in phase 7 (p1 too), the serial calls' p1 launches held against the
     plain versions, with the kernel exactly against its plain version on the
     trellis_q_opt and qslots groups' launches and MP/s for three of
     them; the arithmetic trellis's seconds per 768x512 image, split into
     the row trellis on the card and the coder on the host; the device
     time and kernel count of its AC and DC parts per iMCU row
     (torch.profiler); and the row
     trellis on the card exactly against the CPU on a real iMCU row and
     a tie-heavy one;
  9. decode of the port's own streams on the card: the default 768x512
     and 1021x683 JPEGs of phase 4, phase 8's arithmetic ones (with and
     without the trellis) and phase 7's RGB, CMYK and YCCK ones; decode
     and decode_many (RGB and YUV) equal the CPU path and reach 25 dB
     PSNR against their RGB or CMYK sources; the ifast and float IDCTs on
     the default JPEGs and the float IDCT on a corrupt one, and both on
     int16 extremes with 16-bit tables, equal the CPU; decode_grayscale,
     decode_cropped at an unaligned x and every BufferedImage pass of a
     progressive JPEG equal the CPU; decode_many's median MP/s over 3
     reps of eight 768x512 arithmetic and CMYK JPEGs beside eight Huffman
     YCbCr ones, in turns; the device time and kernels of one float-IDCT
     and one YCCK render (torch.profiler);
 10. the djpeg surface on the card (the default 768x512 and 1021x683
     JPEGs, phase 8's arithmetic one and phase 7's RGB, CMYK and YCCK
     ones): decode_scaled at every M/8, M = 1..16, equal to the CPU path
     and at 8/8 to decode; decode_rgb565 with and without the dither and
     decode_many(output="rgb565") equal to the CPU; the port's djpeg,
     in-process, with six flag sets (-scale 1/2 -bmp, -scale 13/8,
     -rgb565 -bmp, -colors 256 -gif, -onepass -dither ordered -colors 27
     -targa, -grayscale -os2) and jpegyuv writing the CPU path's bytes;
     no trellis_ac launch over those checks; the median MP/s (of output
     and of input) of decode_scaled at 1/8, 1/2 and 2/1 beside decode on
     eight 768x512 photos, one at a time, 3 reps in turns; the device
     time and kernels of one 1/2 and one 16/8 render (torch.profiler);
 11. precision: eight seeded 768x512 12-bit photos (phase 4's generator
     shifted left 4, seeded low bits) through encode_many with
     EncoderConfig(quality=75, precision=12) on the card, twice with the
     same bytes, and the card's bytes equal to the CPU path's on a
     192x128 and a 131x97 crop, one launch of each p1 kernel a component;
     the AC kernel's <14, 16383> instantiation and the p1 kernels (int32
     samples) exactly against their plain versions on every launch of
     the group and
     on the shared generator's dense, all-zero, tie, ragged (B = 3,
     n_img = 1,001) and N = 1 inputs at maxq 16383; its time per group,
     held and with the host's launch gaps, beside its plain version, its
     bounds and the measured nonzero AC coefficients per block (and the
     dense input's); encode_many MP/s of the 12-bit default beside the
     8-bit default on phase 4's first eight photos, 3 reps in turns, and
     the stage times of one 12-bit group (synchronised);
     decode_many of the 12-bit JPEGs equal to the CPU path, PSNR against
     the sources at 12 bits, and MP/s beside the 8-bit Huffman YCbCr
     JPEGs of phase 4, in turns; lossless round trips at 8, 12 and 16
     bits (encode_lossless, then decode and decode_many on the card's
     entry points) equal to the CPU path and to the input;
 12. the remaining surfaces on one seeded 4032x3024 photo (12.2 MP, a
     phone camera's frame, MCU-aligned at 4:2:0), written as a PPM and a
     PNG: the port's cjpeg, in-process on the card with -report and
     -verbose, on both files, equal to each other and to encode() of the
     image with the same configuration on the CPU (the host engine), its
     SCAN trace lines equal to the CPU's, 3 trellis_dc launches, every
     trellis_dc and p1 launch of the checked calls (cjpeg, yuvjpeg,
     encode_raw_yuv) exactly against the plain versions, the DC stage
     of the 12 MP group with the kernel and the plain version in turns
     and where the DC kernel's luma launch spends its cycles, and
     p1_eob_hist and p1_blocks over the image's three components (held,
     with gaps, plain, bound); encode() of the image with trellis_eob_opt,
     its 3 EOB-run DP launches (a luma row of 504 blocks) exactly against
     the plain version and timed as phase 7 times a group's (held, with
     gaps, plain, bound, us a step); yuvjpeg on the image's I420
     planes (made on the card with rgb_to_ycc and downsample_h2v2) equal
     to encode() of the image at yuvjpeg's configuration on the CPU, and
     encode_raw_yuv of the planes at quality 75 equal to encode() of the
     image; the stage times of the 12 MP image's group on the card; on a
     768x512 photo, encode_many's progress sequence and trace lines on
     the card equal to the CPU's, and the TurboJPEG API (TJ on the card
     against TJ on the CPU: compress at RGB and BGRX and at 4:2:0 and
     4:4:0, decompress at 1/2, transform rot90, encode_yuv / decode_yuv,
     compress_from_yuv, decompress_to_yuv); jpegtran (host-only) on the
     12 MP JPEG: -rot90, -crop 1024x768+512+256, -grayscale, -copy all
     and -optimize -progressive, each output's coefficients equal to the
     source's rotated, sliced or unchanged as numpy computes them here,
     and the jpegrescan output decoding to the source's pixels; then the
     median wall time of 3 reps (and MP/s) of cjpeg on the card beside
     the host engine's encode(), encode_raw_yuv on the card and jpegtran
     -rot90 and -optimize -progressive, each line with the card's name
     and power limit;
 13. the device engines (PR 10): the Annex-K tablegen kernel exactly
     against its plain version (bits, values, ok and code lengths) on the
     tables of phase 3's two recorded groups, on adversarial histograms
     (ties, one symbol, sparse, length-limited, Fibonacci, 2^26 counts)
     and on one sizes pass of the device scan search, with its time per
     call held and with launch gaps, its plain version's, the native
     host Annex K's on the same tables and its bound (the bytes and the
     integer operations Annex K needs, at the INT32 rate); also on the
     kernel's edges (live sums at 2^23 - 1, 2^23 and
     2^23 + 1, where its keys switch from 32 to 64 bits; all 257 counts
     equal; sums and counts at 2^30) and on the step sweep, T = 24
     tables of 2, 17, 65, 129, 193 and 257 present symbols, whose held
     times give the time a merge step (the slope);
     encode_many(device_entropy=True) of a 768x512 and the 1021x683
     image equal to the host emission (sequential, with restart_in_rows,
     the simple progressive script, a custom script with AC refinement,
     the 12-bit default and simple script on a 12-bit photo);
     encode_many(device_scanopt=True) of the sixteen 768x512 photos
     (q75 4:2:0 and q92 4:4:4, dc_scan_opt_mode 0-2) equal to the host
     search, each run launching tablegen twice (its trellis loop, its
     search) and trellis_ac three times a group; the sizes pass's peak
     memory and wall time on a group and on a 4032x3024 photo, and its
     kernels and device time per group (torch.profiler); the crossover
     for a group of eight 768x512 photos and the 12 MP photo (MP/s,
     median of 3 in turns, process CPU seconds, stage times, every
     engine's bytes equal to the host's) with the engines off, with
     device_scanopt and with both; the device search of an 8000x6000
     photo (48 MP, the batch limit) equal to the host search, with two
     tablegen launches and its peak memory under 40 GiB; no engine host
     route taken over these photos; sync_latency_ms();
 14. the host render and the transfer codecs: encode_many of
     phase 4's corpus with sparse_download, plane_pack, coef_transport
     and all three, each equal to the dense route's bytes, with 3
     trellis_ac and 1 tablegen launches a group and the packs each codec
     must make (encoder.codec_routes), every launch of the all-codecs
     run against its plain version (the p1 launches of its first group); the 12-bit transport on phase 11's
     photos (its <14, 16383> launches against the plain version); dense
     noise at q95 reaching the transport's repack at capacity 32 and its
     fall to the sparse pack (the route counts logged); the bytes each
     codec moves (utils/xfer.py), the device time and kernels of each
     pack on one group (torch.profiler) and of the download stage, and
     encode_many MP/s beside the dense route (median of 3 in turns);
     decode() and decode_many of a 768x512 and a 4032x3024 JPEG on the
     card's render and through the host render (MJ_DEPLOYMENT=remote),
     equal, median of 3 in turns; decode_many of eight 768x512 JPEGs and
     the 12 MP one through the card, the host render and the packed
     route with MJ_PLANEPACK 0 and 1, RGB and YUV equal to the card's,
     with their bytes, MP/s, device time and kernels;
 15. multi-device encode (mozjpeg_tpu_torch/parallel/) on one card, a
     mesh of four "cuda:0" entries: the dry run; encode_batch of eight
     768x512 photos with the host and the device entropy, equal to the
     one-entry mesh's bytes; encode_row_sharded, _trellis, _progressive
     and _scanopt of a 768x512 photo, each equal to encode() of its
     configuration with restart_in_rows=1 on the card; the full width,
     one 8192x6144 photo (50.3 MP, over the 48 MP batch limit) through
     encode_row_sharded_scanopt, equal to encode_many of it (the
     per-image route on one card); every trellis_ac launch of each
     row-sharded call held exact against its plain version and counted
     (4 shards x 3 components), and so every p1 launch; wall s, MP/s and peak memory of the
     sharded and the per-image encode; a one-rank NCCL group running
     encode_row_sharded_scanopt_multihost, and two gloo processes on
     cuda:0 (tests/torch_multihost_worker.py) running
     encode_row_sharded_multihost and _scanopt_multihost, each equal to
     the one-process bytes;
 16. the port on its own and its two tools: a copy of mozjpeg_tpu_torch/
     (without _build/) in a temp dir, run by
     tests/torch_standalone_worker.py in a child whose sys.path holds
     only the copy and the interpreter's own paths, the JAX package not
     findable, an audit hook failing any open, listdir, scandir, dlopen
     or Popen naming a path under the checkout's mozjpeg_tpu/: it builds
     the host library and the four CUDA libraries from the copy (build
     seconds logged) and encodes a 768x512 photo on the card, byte-equal
     to this process, with 3 trellis_ac, 3 trellis_dc, 1 tablegen and 3
     of each p1 launches, every p1 launch held against the plain
     versions in the child; the port's
     tjbench on a 4032x3024 photo at q95 4:2:0, plain and -progressive
     -optimize (compress and decompress MP/s, no kernel launch), and
     -tile on a 384x256 crop at 4:4:4 (every tile size exact, the
     JPEG's size equal to the same call without -tile on the CPU); the
     port's rd_collect over that photo and phase 4's sixteen 768x512
     ones at -q 50,75,95 -average -plot (3 trellis_ac and 1 tablegen
     launches an encode), its 768x512 rows equal to the CPU's, every
     launch of its first (4032x3024) encode against the plain versions;
 17. the script's time, the kernels line (both instantiations of the AC
     kernel, the tablegen kernel, the DC trellis, the EOB-run DP and p1's
     two kernels), then {"ok": true, "device": ...} as the last line.
Launch counts are set to 0 just before each timed run of a path (phase
4's main path, each timed family of phases 7 and 8, the serial calls of
phase 8, phase 11's 12-bit main path, each of phase 12's calls, each of
phase 14's encode runs, each of phase 15's row-sharded calls, each of
phase 16's tool runs) and read just after it; the kernels line carries
phase 4's count of the <10, 1023> instantiation with phase 12's, phase
14's, phase 15's and phase 16's rd_collect counts beside it, and phase
11's of the <14, 16383> one with phase 14's, and phase 4's count of
tablegen with phase 13's per device-search group, phase 14's and phase
16's beside it; trellis_dc carries phase 4's count and trellis_eob the
count of phase 7's timed trellis_eob_opt runs (the path it lies on),
p1_blocks and p1_eob_hist phase 4's counts, each with the launches held
against its plain version over the whole run. It needs no network and
imports no JAX.
"""
import contextlib
import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_F32_OPS = 67e12       # FP32 peak outside the tensor cores (data sheet)
H100_BYTES = 3.35e12       # HBM3 bytes/s (data sheet)
# INT32 peak: 132 SMs x 64 INT32 lanes x 1.98 GHz (the SM layout of the
# Hopper whitepaper at the clock behind the data sheet's FP32 peak)
H100_INT32_OPS = 16.7e12
KERNEL_REPLACES = "mozjpeg_tpu/ops/pallas_trellis.py:242"
KERNEL_SOURCE = "mozjpeg_tpu_torch/csrc/trellis_ac.cu"


def log(*a):
    print(*a, flush=True)


def photo(h, w, seed):
    """Seeded photo-like RGB: smooth gradients, hard edges, a saturated
    white patch (drives the deringing) and sensor-like noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    fx, fy = r.uniform(0.5, 3.0, 2)
    img = np.stack([
        127 + 100 * np.sin(fx * np.pi * xx / w + r.uniform(0, 6)),
        127 + 100 * np.cos(fy * np.pi * yy / h + r.uniform(0, 6)),
        255 * (xx + yy) / (w + h)], -1)
    for _ in range(6):                       # flat-coloured rectangles
        y0, x0 = r.integers(0, h - 8), r.integers(0, w - 8)
        img[y0:y0 + r.integers(8, h // 3), x0:x0 + r.integers(8, w // 3)] = \
            r.uniform(0, 255, 3)
    y0, x0 = r.integers(0, h // 2), r.integers(0, w // 2)
    img[y0:y0 + h // 5, x0:x0 + w // 6] = 255   # clipped highlight
    img += r.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cuda_ms(fn, reps, hold=True):
    """Device ms per call of fn, between CUDA events. With `hold`, a sleep
    kernel first holds the card while the host queues the calls, so that
    short kernels run back to back and the host's launch time is not
    counted; without it, the gaps between the host's launches count. The
    sleep lasts at least twice as long as the host takes to queue the
    calls (one call's queueing time, timed here, at up to 2 GHz)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if hold:
        tq = time.perf_counter()
        fn()
        queue_s = time.perf_counter() - tq
        torch.cuda.synchronize()
        torch.cuda._sleep(int(max(50_000_000, 4e9 * queue_s * reps)))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def example_trellis(kind, b, n_img, dev, seed, precision=8):
    """trellis_ac arguments on `dev` from the shared seeded generator,
    band (1, 63), for the instantiation of `precision`."""
    import torch
    from mozjpeg_tpu_torch.codec import trellis
    return tuple(torch.as_tensor(a, device=dev) for a in
                 trellis.ac_example_inputs(kind, b, n_img, seed, precision)) \
        + (1, 63, n_img) + trellis.kmax_maxq(precision)


def bound(nbytes, ops, op_rate=H100_F32_OPS):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over their peak rate
    (f32 unless op_rate says otherwise)."""
    t_b, t_o = nbytes / H100_BYTES, ops / op_rate
    return max(t_b, t_o) * 1e3, ("operations" if t_o >= t_b else "bytes")


def trellis_bound(args):
    """(bytes, f32 operations) the AC trellis needs on these inputs: each
    input read once and output written once; per block, for every in-band
    i with qval_i != 0, each valid predecessor j < i and each of the nc_i
    bit lengths costs 3 ops (two adds, one compare), each (i, j) pair 2
    (the tail) and each (i, k) pair 2 (the distortion products)."""
    import torch
    from mozjpeg_tpu_torch.ops.symbols import nbits
    raw, qtbl, ltbl, luts, lam, ss, se = args[:7]
    maxq = args[9] if len(args) > 9 else 1023
    n = raw.shape[1]
    nbytes = (raw.numel() * 4 + lam.numel() * 4 + luts.numel() * 4
              + 64 * 8 + n * 64 * 4 + n * 8 * 4)
    q8 = (qtbl << 3)[:, None]
    qval = torch.clamp_max((raw.abs() + (q8 >> 1)) // q8, maxq)
    pos = torch.arange(64, device=raw.device)[:, None]
    in_band = (pos >= ss) & (pos <= se)
    jvalid = ((qval != 0) & in_band) | (pos == ss - 1)
    nj = torch.cumsum(jvalid.to(torch.int64), 0) - jvalid.to(torch.int64)
    live = (qval != 0) & in_band
    nc = nbits(qval).to(torch.int64)
    ops = torch.where(live, 3 * nj * nc + 2 * nj + 2 * nc, 0).sum()
    return nbytes, float(ops)


DC_REPLACES = "mozjpeg_tpu/codec/trellis.py:89 (XLA, no pallas_call)"
EOB_REPLACES = "mozjpeg_tpu/codec/trellis.py:319 (XLA, no pallas_call)"
ROWS_SOURCE = "mozjpeg_tpu_torch/csrc/trellis_rows.cu"
# per row-scan kernel: [largest difference from the plain version, the
# launches held against it] over the whole run
ROWS_CHECK = {"trellis_dc": [0.0, 0], "trellis_eob": [0.0, 0]}
# the row-scan kernels' launches of each timed family of phases 7 and 8
ROWS_LAUNCHES = {}


def rows_vs_plain(kind, args, label):
    """One launch of a row-scan kernel (ops/trellis_rows.py: "trellis_dc"
    or "trellis_eob", the keys of trellis_all's record) against its plain
    version on the card, exactly (its launch is not counted) -> the
    largest difference."""
    import torch
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    kernel, plain = {"trellis_dc": (trw.trellis_dc, trw.trellis_dc_plain),
                     "trellis_eob": (trw.eob_dp, trw.eob_dp_plain)}[kind]
    counts = trw.trellis_dc.launches, trw.eob_dp.launches
    got = kernel(*args)
    trw.trellis_dc.launches, trw.eob_dp.launches = counts
    want = plain(*args)
    torch.cuda.synchronize()
    exact = torch.equal(got, want)
    err = float((got.to(torch.int32) - want.to(torch.int32)).abs().max()) \
        if got.numel() else 0.0
    log("%s kernel vs plain [%s] %s: exact=%s max_abs_err=%g"
        % (kind, label, "x".join(map(str, got.shape)), exact, err))
    if not exact:
        raise SystemExit("%s kernel disagrees with its plain version (%s)"
                         % (kind, label))
    ROWS_CHECK[kind][0] = max(ROWS_CHECK[kind][0], err)
    ROWS_CHECK[kind][1] += 1
    return err


def check_rows(rec, label, first=None):
    """Each recorded row-scan launch of a trellis_all record (the first
    `first` of each kind) against its plain version."""
    for kind in ("trellis_dc", "trellis_eob"):
        for i, args in enumerate(rec.get(kind, [])[:first]):
            rows_vs_plain(kind, args, "%s launch %d" % (label, i))


P1_SOURCE = "mozjpeg_tpu_torch/csrc/p1.cu"
P1_BLOCKS_REPLACES = "mozjpeg_tpu/codec/pipeline_t.py:413 (XLA, no pallas_call)"
P1_EOB_REPLACES = "mozjpeg_tpu/ops/symbols.py:146 (XLA, no pallas_call)"
# per p1 kernel: [largest difference from the plain version, the launches
# held against it] over the whole run
P1_CHECK = {"p1_blocks": [0.0, 0], "p1_eob_hist": [0.0, 0]}


@contextlib.contextmanager
def p1_recording(rec):
    """p1's kernel launches inside record into rec["p1_blocks"] and
    rec["p1_eob_hist"] (ops/p1.RECORDERS): each launch's arguments, the
    EOB kernel's histogram as it was before the launch added into it."""
    from mozjpeg_tpu_torch.ops import p1 as tp1

    def record(kind, args):
        if kind == "p1_eob_hist":
            args = (args[0], args[1].clone()) + tuple(args[2:])
        rec.setdefault(kind, []).append(args)
    tp1.RECORDERS.append(record)
    try:
        yield
    finally:
        tp1.RECORDERS.remove(record)


def p1_vs_plain(kind, args):
    """One launch of a p1 kernel ("p1_blocks" or "p1_eob_hist") against
    its plain version on the card (its launch is not counted; the EOB
    kernel and its plain version each add into a copy of the recorded
    histogram) -> (every output equal in type and value, the largest
    difference)."""
    import torch
    from mozjpeg_tpu_torch.ops import p1 as tp1
    kernel, plain = {"p1_blocks": (tp1.p1_blocks, tp1.p1_blocks_plain),
                     "p1_eob_hist": (tp1.p1_eob_hist,
                                     tp1.p1_eob_hist_plain)}[kind]
    counts = tp1.p1_blocks.launches, tp1.p1_eob_hist.launches
    if kind == "p1_eob_hist":
        got = (kernel(args[0], args[1].clone(), *args[2:]),)
        want = (plain(args[0], args[1].clone(), *args[2:]),)
    else:
        got, want = kernel(*args), plain(*args)
    tp1.p1_blocks.launches, tp1.p1_eob_hist.launches = counts
    torch.cuda.synchronize()
    exact, err = True, 0.0
    for g, w in zip(got, want):
        exact = exact and g.dtype == w.dtype and torch.equal(g, w)
        if g.numel() and g.shape == w.shape:
            err = max(err, float((g.to(torch.float64)
                                  - w.to(torch.float64)).abs().max()))
    return exact, err


def check_p1(rec, label, first=None):
    """Each recorded p1 launch of rec (the first `first` of each kernel)
    against its plain version; one line with the counts, and a failure
    at the first difference."""
    n, worst = {}, 0.0
    for kind in ("p1_blocks", "p1_eob_hist"):
        calls = rec.get(kind, [])[:first]
        n[kind] = len(calls)
        for i, args in enumerate(calls):
            exact, err = p1_vs_plain(kind, args)
            if not exact:
                raise SystemExit("%s kernel disagrees with its plain version "
                                 "(%s launch %d): max_abs_err=%g"
                                 % (kind, label, i, err))
            P1_CHECK[kind][0] = max(P1_CHECK[kind][0], err)
            P1_CHECK[kind][1] += 1
            worst = max(worst, err)
    log("p1 kernels vs plain [%s]: p1_blocks %d launches, p1_eob_hist %d "
        "launches: exact=True max_abs_err=%g"
        % (label, n["p1_blocks"], n["p1_eob_hist"], worst))
    return n


def p1_seeded(qt, dev, bh=64, bw=96):
    """Phase 3's seeded p1 launches against the plain versions:
    ops/p1.example_plane's planes (deringing's edge cases, long flat
    runs), uint8 and int32 samples, B = 8 and 1, deringing on and off; a
    luma plane and a chroma plane (wider than its blocks) as views into
    one buffer, and a channel view with a column stride; the EOB kernel
    at restart intervals 0, 1, 5, n - 1, n and n + 3."""
    import torch
    from mozjpeg_tpu_torch.ops import p1 as tp1
    qt = qt.reshape(64).astype(np.int32)
    ch, cw = bh // 2, bw // 2
    for prec, b, dering_on in ((8, 8, True), (8, 1, False), (12, 8, True),
                               (12, 1, False)):
        luma = tp1.example_plane(b, bh, bw, prec, b + prec)
        chroma = tp1.example_plane(b, ch, cw, prec, b + prec + 1,
                                   ch * 8 + 8, cw * 8 + 8)
        buf = torch.as_tensor(np.concatenate(
            [luma.reshape(b, -1), chroma.reshape(b, -1)], 1), device=dev)
        rgb = torch.as_tensor(np.stack([luma[:, :, :cw * 8]] * 3, -1),
                              device=dev)
        rec = {"p1_blocks": [], "p1_eob_hist": []}
        for plane, pbh, pbw in (
                (buf[:, :luma[0].size].reshape(luma.shape), bh, bw),
                (buf[:, luma[0].size:].reshape(chroma.shape), ch, cw),
                (rgb[..., 2], bh, cw)):
            rec["p1_blocks"].append((plane, pbh, pbw, qt, dering_on, prec))
            out = tp1.p1_blocks_plain(plane, pbh, pbw, qt, dering_on, prec)
            n = pbh * pbw
            for ri in (0, 1, 5, n - 1, n, n + 3):
                rec["p1_eob_hist"].append((out[4], out[3], b, ri))
        check_p1(rec, "seeded %d-bit B=%d dering=%s" % (prec, b, dering_on))


def p1_bound(kind, args):
    """(bytes, integer operations) of one p1 launch on these arguments.
    p1_blocks: each block reads its 64 samples and writes 64 int16 and 64
    int32 coefficients, its f32 norm and a flag byte, plus the image's
    histogram; about 1,700 integer operations a block (16 FDCT passes of
    42, 64 coefficients of 14 for quantization, zigzag and symbols, the
    norm's 126), and 16 for each clipped sample when deringing is on (a
    curve point where its block is deringed).
    p1_eob_hist: each block's flag byte is read, each histogram read and
    written; about 8 operations a block."""
    if kind == "p1_eob_hist":
        flags, hist = args[0], args[1]
        return flags.numel() + 2 * hist.numel() * 4, 8.0 * flags.numel()
    plane, bh, bw = args[:3]
    nblk = plane.shape[0] * bh * bw
    runs = 0
    if args[4]:
        import torch
        top = plane[:, :bh * 8, :bw * 8].to(torch.int32) \
            - (1 << (args[5] - 1))
        runs = int((top >= 127).sum())
    return (nblk * (64 * plane.element_size() + 64 * 2 + 64 * 4 + 4 + 1)
            + plane.shape[0] * 256 * 4, 1700.0 * nblk + 16.0 * runs)


def dc_bound(args):
    """(bytes, f32 operations) of the DC trellis on these arguments: each
    block reads its raw DC and lambda and writes its choice (12 bytes),
    plus the 17 code lengths; per block nc^2 predecessor pairs of 3
    operations (two adds and a compare) and per candidate 6 for its
    distortion (12 with the vertical gradient)."""
    raw, nc, delta_w = args[0], args[5], args[7]
    n = raw.numel()
    per_cand = 12 if delta_w > 0 else 6
    return 12 * n + 17 * 4, float(n * (3 * nc * nc + per_cand * nc))


def eob_bound(args):
    """(bytes, f32 operations) of the EOB-run DP on these arguments: each
    block reads czero, skip and has_eob and writes its keep flag (13
    bytes), plus 16 EOBn lengths an image; at step b of a row whose block
    is not all zero, the b + 1 earlier states cost 5 operations each
    (four adds and a compare), and the final run 3 for each of the L + 1
    states (this run's data: all-zero blocks take no step)."""
    import torch
    ei, ac_si, bh, bw = args
    he = ei[2].reshape(-1, bw)
    b = torch.arange(bw, device=ei.device)
    steps = ((he != 2) * (b + 1)).sum().item()
    rows = he.shape[0]
    return (13 * ei.shape[1] + 64 * ac_si.shape[0],
            float(5 * steps + 3 * rows * (bw + 1)))


def dc_clock_split(args, label, smi):
    """Where one DC trellis launch's time goes: the kernel's instantiation
    that counts SM cycles (ops/trellis_rows.trellis_dc_clocks) on the
    launch's arguments, its output held equal to the wrapper's -> {the
    share of the chains' cycles in the per-row pass, the chain, the walk
    back and the output; cycles a chain step (a block); the slowest
    chain's cycles}."""
    import torch
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    trw.trellis_dc_clocks(*args)                       # warm
    out, clocks = trw.trellis_dc_clocks(*args)
    want = trw.trellis_dc_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise SystemExit("trellis_dc's clock instantiation disagrees with "
                         "the plain version (%s)" % label)
    c = clocks.to(torch.float64)
    tot = c.sum(0)
    names = ("row_pass", "chain", "walk_back", "output")
    share = {k: float(tot[i] / tot.sum()) for i, k in enumerate(names)}
    res = {"clock_share": share, "walk_back_share": share["walk_back"],
           "chain_cycles_a_step": float(tot[1]) / args[0].numel(),
           "slowest_chain_cycles": float(c.sum(1).max())}
    log("trellis_dc clocks [%s] on %s: shares of the chains' SM cycles %s; "
        "%.1f cycles a chain step; the slowest chain %.0f cycles"
        % (label, smi, json.dumps({k: round(v, 4) for k, v in share.items()}),
           res["chain_cycles_a_step"], res["slowest_chain_cycles"]))
    return res


def empty_ms(dev, smi, reps=200):
    """The launch floor: a kernel that does nothing, launched through
    ctypes as the wrappers launch theirs -> (ms held, ms with the host's
    launch gaps)."""
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    held = cuda_ms(lambda: trw.empty_launch(dev), reps)
    gaps = cuda_ms(lambda: trw.empty_launch(dev), reps, hold=False)
    log("empty kernel on %s: %.5f ms a launch held, %.5f ms with the "
        "host's launch gaps (the floor beside each bytes bound)"
        % (smi, held, gaps))
    return held, gaps


def is_kernel(e):
    """Whether a torch.profiler event is a kernel or copy on the card, and
    not the span of a record_function range on the card's timeline."""
    import torch
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def sync_ms(fn, reps):
    """Synchronised host ms per call of fn (after one warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profiled_top(fn, reps=3, top=8):
    """profiled() and the top device ops of one call: [(kernel name, ms,
    launches)] by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if is_kernel(e):
            t = by.setdefault(e.name[:90], [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3 / reps
            t[1] += 1
    total = sum(t[0] for t in by.values())
    n = sum(t[1] for t in by.values()) // reps
    ops = sorted(((k, round(t[0], 4), t[1] // reps) for k, t in by.items()),
                 key=lambda x: -x[1])[:top]
    return total, n, ops


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def same(a, b):
    """Equal arrays, or equal lists of arrays (YUV planes), dtype too."""
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def decode_phase(images, outs, dev):
    """Phase 5: the port's decode on the card against its CPU path."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import decoder, marker, smooth
    mp = sum(im.shape[0] * im.shape[1] for im in images) / 1e6
    mjt.decode_many(outs)                               # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        decs = mjt.decode_many(outs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    checked = (0, 7, 16, len(images) - 1)
    cpus = mjt.decode_many([outs[i] for i in checked], device="cpu")
    for i, cpu in zip(checked, cpus):
        ok = same(decs[i], cpu)
        log("decode card vs cpu [image %d, %dx%d]: equal=%s"
            % (i, images[i].shape[1], images[i].shape[0], ok))
        if not ok:
            raise SystemExit("decode on the card differs from the CPU path")
    ps = [psnr(d, im) for d, im in zip(decs, images)]
    log("decode PSNR vs source (dB): %s" % ", ".join("%.2f" % p for p in ps))
    if min(ps) < 25.0 or any(d.shape != im.shape
                             for d, im in zip(decs, images)):
        raise SystemExit("decoded image far from its source")

    trunc = outs[0][:len(outs[0]) * 2 // 3] + b"\xff\xd9"
    jp = marker.parse(trunc)
    decoder.decode_coefficients(jp, trunc)
    if not smooth.smoothing_ok(jp, jp.coef_bits):
        raise SystemExit("the truncated stream does not take smoothing")
    for label, card, cpu in (
            ("decode() image 0", lambda: mjt.decode(outs[0]),
             lambda: mjt.decode(outs[0], device="cpu")),
            ("decode_many truncated image 0 (block smoothing)",
             lambda: mjt.decode_many([trunc]),
             lambda: mjt.decode_many([trunc], device="cpu")),
            ("decode_many yuv images 0-7",
             lambda: mjt.decode_many(outs[:8], output="yuv"),
             lambda: mjt.decode_many(outs[:8], output="yuv",
                                     device="cpu"))):
        ok = same(card(), cpu())
        log("decode card vs cpu [%s]: equal=%s" % (label, ok))
        if not ok:
            raise SystemExit("decode on the card differs from the CPU path")
    mps = [mp / w for w in walls]
    log("decode_many MP/s: median %.3f (reps %s)"
        % (statistics.median(mps), ", ".join("%.3f" % v for v in mps)))

    # stage times of one 8x768x512 group, synchronised
    datas = outs[:8]
    times = {}
    t0 = time.perf_counter()
    jps = [marker.parse(d) for d in datas]
    with ThreadPoolExecutor(min(8, max(2, os.cpu_count() or 4))) as pool:
        planes = list(pool.map(decoder.decode_coefficients, jps, datas))
    times["parse_entropy"] = time.perf_counter() - t0
    key = decoder.group_key(jps[0], planes[0])
    if key is None or any(decoder.group_key(j, p) != key
                          for j, p in zip(jps, planes)):
        raise SystemExit("the 768x512 images do not share a render group")
    rec = {}
    t0 = time.perf_counter()
    decoder.render_group(key, jps, planes, dev, times=times, record=rec)
    group_s = time.perf_counter() - t0 + times["parse_entropy"]
    log("decode stages of one 8x768x512 group (ms): %s; total %.1f"
        % (json.dumps({k: round(v * 1e3, 3) for k, v in times.items()}),
           group_s * 1e3))
    args = rec["render_ycc_batch"]
    out = decoder.render_ycc_batch(*args)
    nbytes = sum(a.numel() * a.element_size() for a in args[:5]) \
        + out.numel() * out.element_size()
    # a render call queues hundreds of launches, and its held time moves
    # with the host's load from run to run, so the device's own time is
    # the sum of its kernels' durations in the profiler's trace; the held
    # time stays beside it
    r_held = cuda_ms(lambda: decoder.render_ycc_batch(*args), 10)
    r_un = cuda_ms(lambda: decoder.render_ycc_batch(*args), 10, hold=False)
    b_ms, _ = bound(nbytes, 0)
    from torch.profiler import ProfilerActivity, profile
    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            decoder.render_ycc_batch(*args)
        torch.cuda.synchronize()
    dev_evs = [e for e in prof.events()
               if is_kernel(e)]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_evs) / 1e3 / reps
    log("decode render per group: %.4f ms of device kernels (torch.profiler, "
        "%d kernels); between CUDA events %.4f ms held, %.4f ms with the "
        "host's launch gaps (card busy %.0f%%); bound %.4f ms (%d bytes, by "
        "bytes), %.2f%% of the bound"
        % (busy_ms, len(dev_evs) // reps, r_held, r_un, 100 * busy_ms / r_un,
           b_ms, nbytes, 100 * b_ms / busy_ms))


def profiled(fn, reps=3):
    """(device ms of fn's kernels per call, kernels per call, wall ms per
    call synchronised) from torch.profiler over `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    evs = [e for e in prof.events()
           if is_kernel(e)]
    return (sum(e.time_range.elapsed_us() for e in evs) / 1e3 / reps,
            len(evs) // reps, wall * 1e3)


# (name, input channels, EncoderConfig fields) per family of phase 7;
# channels 1 = 2-D planes, 4 = seeded CMYK
FAMILIES = [
    ("grayscale", 1, dict(gray_sample=(1, 2))),
    ("gray-from-rgb", 3, dict(grayscale=True)),
    ("rgb", 3, dict(colorspace="rgb")),
    ("cmyk", 4, dict()),
    ("ycck", 4, dict(colorspace="ycck")),
    ("device-prep-1x2", 3, dict(host_prep=False, subsampling=(1, 2))),
    ("smoothing", 3, dict(smoothing_factor=30)),
    ("ifast", 3, dict(dct_method="ifast")),
    ("float", 3, dict(dct_method="float")),
    ("float-no-dering", 3, dict(dct_method="float",
                                overshoot_deringing=False)),
    ("restart_interval=4", 3, dict(restart_interval=4)),
    ("restart_in_rows=1", 3, dict(restart_in_rows=1)),
    ("progressive=False", 3, dict(progressive=False)),
    ("standard-tables", 3, dict(progressive=False, optimize_coding=False)),
    ("FASTEST", 3, dict(profile="fastest")),
    ("simple-script", 3, dict(optimize_scans=False, dc_scan_opt_mode=1)),
    ("no-trellis", 3, dict(trellis_quant=False)),
    ("no-dc-trellis", 3, dict(trellis_quant_dc=False)),
    ("trellis_eob_opt", 3, dict(trellis_eob_opt=True)),
    ("trellis_num_loops=2", 3, dict(trellis_num_loops=2)),
    ("use_scans_in_trellis", 3, dict(use_scans_in_trellis=True)),
    ("delta-dc-weight", 3, dict(trellis_delta_dc_weight=0.5)),
    ("qualities-icc", 3, dict(quality=[70, 85], icc=bytes(range(256)) * 8,
                              density=(1, 72, 72))),
]
TIMED = ("grayscale", "ifast", "float", "restart_in_rows=1",
         "progressive=False", "FASTEST", "trellis_eob_opt",
         "trellis_num_loops=2", "use_scans_in_trellis")
RECORDED = ("grayscale", "cmyk", "use_scans_in_trellis", "trellis_eob_opt")
# phase 8: the configurations the batched route does not carry (the
# per-image route on the card), and arithmetic coding without the trellis
ROUTE_FAMILIES = [
    ("arithmetic", 3, dict(arithmetic=True)),
    ("arithmetic-notrellis", 3, dict(arithmetic=True, trellis_quant=False)),
    ("arithmetic-seq-restart", 3, dict(arithmetic=True, progressive=False,
                                       restart_interval=2)),
    ("trellis_q_opt", 3, dict(trellis_q_opt=True)),
    ("qslots", 3, dict(qslots=(1, 0, 1))),
]
ROUTE_ONE_IMAGE = ("arithmetic", "arithmetic-seq-restart")
ROUTE_TIMED = ("arithmetic-notrellis", "trellis_q_opt", "qslots")
ROUTE_RECORDED = ("trellis_q_opt", "qslots")


def family_images(images, channels, seed):
    """The corpus as a family's input: 2-D planes, RGB, or RGB with a
    seeded K channel."""
    if channels == 1:
        return [np.ascontiguousarray(im[..., 0]) for im in images]
    if channels == 4:
        return [np.concatenate([im, photo(im.shape[0], im.shape[1],
                                          seed + i)[..., :1]], -1)
                for i, im in enumerate(images)]
    return images


def family_config(kw):
    import mozjpeg_tpu_torch as mjt
    kw = dict(kw)
    if "dct_method" in kw:
        kw["dct_method"] = mjt.DCTMethod(kw["dct_method"])
    if "profile" in kw:
        kw["profile"] = mjt.Profile(kw["profile"])
    kw.setdefault("quality", 75)
    return mjt.EncoderConfig(**kw)


def check_families(families, recorded, timed, kodak, odd, dev, default_mps,
                   compare, t_phase, one_image=(), kept=None):
    """Each family on the card: SOI/EOI and the same bytes twice on one
    768x512 and one 1021x683 corpus image (only the first for the
    families in one_image), the card's bytes equal to the CPU path's on a
    256x192 and a 131x97 crop; the kernel against its plain version on a
    group's launches for the recorded families; encode_many MP/s of the
    corpus for the timed ones, with the kernel's launches counted from 0
    just before their 3 reps. With `kept` (dict), kept[name] gets each
    family's (input images, JPEGs) of the full-size check. -> (MP/s per
    timed family, (ctx, record) per recorded family, largest
    kernel-vs-plain error)."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder
    from mozjpeg_tpu_torch.ops import p1 as tp1
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    corpus = kodak + odd
    mp = sum(im.shape[0] * im.shape[1] for im in corpus) / 1e6
    max_err = 0.0
    rates, recs = {}, {}
    for name, ch, kw in families:
        cfg = family_config(kw)
        big = family_images([kodak[0]] if name in one_image
                            else [kodak[0], odd[0]], ch, 300)
        frec = {}
        with p1_recording(frec):
            outs = mjt.encode_many(big, cfg)
        n1 = check_p1(frec, "%s, first full-size encode" % name)
        islow = cfg.resolved().dct_method.value == "islow"
        if n1["p1_blocks"] != n1["p1_eob_hist"] or (
                (n1["p1_blocks"] > 0) != islow):
            raise SystemExit("%s: p1 launches %s, expected both kernels on "
                             "islow and neither on ifast or float"
                             % (name, json.dumps(n1)))
        again = mjt.encode_many(big, cfg)
        if not all(o[:2] == b"\xff\xd8" and o[-2:] == b"\xff\xd9"
                   for o in outs):
            raise SystemExit("%s: output without SOI/EOI" % name)
        if again != outs:
            raise SystemExit("%s: outputs differ between runs" % name)
        if kept is not None:
            kept[name] = (big, outs)
        crops = [big[0][100:292, 200:456], big[-1][301:398, 17:148]]
        same = mjt.encode_many(crops, cfg) == mjt.encode_many(
            crops, cfg, device="cpu")
        log("config matrix [%s]: %s, deterministic; card vs cpu on 256x192 "
            "and 131x97 crops: equal=%s (phase at %.1f s)"
            % (name, ", ".join("%dx%d %d bytes" % (im.shape[1], im.shape[0],
                                                   len(o))
                               for im, o in zip(big, outs)),
               same, time.perf_counter() - t_phase))
        if not same:
            raise SystemExit("%s: card output differs from the CPU path"
                             % name)
        if name in recorded:
            ctx = encoder.resolve_group(family_images(kodak[:1], ch, 300)[0],
                                        cfg)
            rec = {}
            with ThreadPoolExecutor(8) as pool, p1_recording(rec):
                for f in encoder.encode_group(
                        family_images(kodak[:8], ch, 300), ctx, dev, pool,
                        record=rec):
                    f.result()
            recs[name] = (ctx, rec)
            for i, args in enumerate(rec["trellis_ac"]):
                max_err = max(max_err, compare(
                    args, "%s group launch %d" % (name, i)))
            check_rows(rec, "%s group" % name)
            check_p1(rec, "%s group" % name)
        if name in timed:
            # warm: this family's kernels and shapes just ran above
            imgs = family_images(corpus, ch, 400)
            torch.cuda.synchronize()
            tac.reset_launches()
            trw.reset_launches()
            tp1.reset_launches()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                mjt.encode_many(imgs, cfg)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = tac.trellis_ac.launches
            rows = {"trellis_dc": trw.trellis_dc.launches,
                    "trellis_eob": trw.eob_dp.launches}
            ROWS_LAUNCHES[name] = rows
            p1n = (tp1.p1_blocks.launches, tp1.p1_eob_hist.launches)
            res = cfg.resolved()
            if res.trellis_quant and launches <= 0:
                raise SystemExit("%s never launched the trellis kernel"
                                 % name)
            if res.trellis_quant and not res.arithmetic and (
                    (res.trellis_quant_dc and rows["trellis_dc"] <= 0)
                    or (res.trellis_eob_opt and rows["trellis_eob"] <= 0)):
                raise SystemExit("%s never launched a row-scan kernel it "
                                 "needs" % name)
            if (p1n[0] != p1n[1] or (p1n[0] > 0)
                    != (res.dct_method.value == "islow")):
                raise SystemExit("%s: p1 launches %s in its timed runs"
                                 % (name, p1n))
            rates[name] = [mp / w for w in walls]
            log("config matrix MP/s [%s]: median %.3f (reps %s), "
                "trellis_ac launches=%d, trellis_dc launches=%d, "
                "trellis_eob launches=%d, p1_blocks launches=%d, "
                "p1_eob_hist launches=%d; default %.3f"
                % (name, statistics.median(rates[name]),
                   ", ".join("%.3f" % v for v in rates[name]), launches,
                   rows["trellis_dc"], rows["trellis_eob"], p1n[0], p1n[1],
                   default_mps))
    return rates, recs, max_err


def config_matrix(kodak, odd, dev, default_mps, compare, kept, smi):
    """Phase 7; returns the largest AC kernel-vs-plain error it saw and
    the kernels-line entry of the EOB-run DP, and keeps each family's
    full-size images and JPEGs in `kept`."""
    import torch
    from mozjpeg_tpu_torch.codec import encoder, pipeline_t
    from mozjpeg_tpu_torch.ops import dct, dering, layout
    t_phase = time.perf_counter()
    rates, recs, max_err = check_families(
        FAMILIES, RECORDED, TIMED, kodak, odd, dev, default_mps, compare,
        t_phase, kept=kept)

    slowest = sorted(rates, key=lambda k: statistics.median(rates[k]))[:3]
    for name in slowest:
        ch, kw = next((c, k) for n, c, k in FAMILIES if n == name)
        cfg = family_config(kw)
        group = family_images(kodak[:8], ch, 400)
        ctx = encoder.resolve_group(group[0], cfg)
        times = {}
        with ThreadPoolExecutor(8) as pool:
            t0 = time.perf_counter()
            encoder.encode_group(group, ctx, dev, pool, times=times)
            group_s = time.perf_counter() - t0
        log("config matrix stages of one 8x768x512 group [%s] (ms): %s; "
            "total %.1f" % (name, json.dumps(
                {k: round(v * 1e3, 3) for k, v in times.items()}),
                group_s * 1e3))

    # the EOB-run DP of one group (Y, Cb, Cr): the family's recorded
    # launches, kernel and plain in turns, device times, the bound
    from mozjpeg_tpu_torch.codec.pipeline import geometry
    h, w = kodak[0].shape[:2]
    eob_args = recs["trellis_eob_opt"][1]["trellis_eob"]
    if len(eob_args) != 3:
        raise SystemExit("expected 3 EOB-run DP calls per trellis_eob_opt "
                         "group, saw %d" % len(eob_args))

    nums, eob_group, eob_plain = row_stage("trellis_eob", eob_args,
                                           "one 8x768x512 group", smi)
    k_eob = dict(name="trellis_eob", route="cuda", source=ROWS_SOURCE,
                 replaces=EOB_REPLACES,
                 launches=ROWS_LAUNCHES["trellis_eob_opt"]["trellis_eob"],
                 library_ms=None, **nums)

    # device prep of one group (RGB -> YCbCr, 4:2:0) and the float DCT of
    # its luma (dering, DCT, quantize, rescale)
    group_t = torch.from_numpy(np.stack(kodak[:8])).to(dev)
    geom = geometry(w, h, [(2, 2), (1, 1), (1, 1)])
    planes = pipeline_t.prep_planes(group_t, geom, "ycbcr")
    blocks = layout.blockify_t(planes[0].to(torch.int32) - 128)
    qt = encoder.make_qtables(family_config({}).resolved())[0]
    div = torch.as_tensor(dct.float_divisors(qt).reshape(8, 8, 1),
                          device=dev)
    q0 = int(qt[0, 0])

    def float_dct():
        f = layout.from_zigzag_t(dering.dering_float_t(
            layout.to_zigzag_t(blocks.to(torch.float32)), q0))
        sc = dct.fdct_float_t(f)
        dct.quantize_float_t(sc, div)
        dct.rescale_float_t(sc)

    for label, fn, reps in (("kernel", eob_group, 3),
                            ("plain version", eob_plain, 1)):
        dev_ms, nk, top = profiled_top(fn, reps, top=4)
        log("config matrix per 8x768x512 group [EOB-run DP (Y, Cb, Cr), "
            "%s] on %s: %.4f ms of device kernels (torch.profiler), %d "
            "kernels; top %s" % (label, smi, dev_ms, nk, json.dumps(top)))
    for label, fn, reps in (
            ("device prep (RGB -> YCbCr 4:2:0)",
             lambda: pipeline_t.prep_planes(group_t, geom, "ycbcr"), 3),
            ("float DCT of the luma (dering, DCT, quantize, rescale)",
             float_dct, 3)):
        dev_ms, nk, wall_ms = profiled(fn, reps)
        log("config matrix per 8x768x512 group [%s]: %.4f ms of device "
            "kernels (torch.profiler, %d kernels), %.3f ms synchronised "
            "wall under the profiler" % (label, dev_ms, nk, wall_ms))
    log("config matrix: %.1f s" % (time.perf_counter() - t_phase))
    return max_err, k_eob


def per_image_routes(kodak, odd, dev, default_mps, compare, kept):
    """Phase 8; returns the largest kernel-vs-plain error it saw, and
    keeps each family's full-size images and JPEGs in `kept`."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch import consts
    from mozjpeg_tpu_torch.codec import encoder, trellis
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    t_phase = time.perf_counter()

    # serial encode() on the card against the CPU's host engine
    cfg = mjt.EncoderConfig(quality=75)
    for img in (kodak[0], odd[0]):
        label = "%dx%d" % (img.shape[1], img.shape[0])
        cpu = mjt.encode(img, cfg, device="cpu")
        srec = {}
        with p1_recording(srec):
            card = mjt.encode(img, cfg)
        check_p1(srec, "serial encode() %s" % label)
        ok = card == cpu and card[:2] == b"\xff\xd8" and card[-2:] == \
            b"\xff\xd9"
        ms = {}
        for way, dv in (("card", None), ("cpu host engine", "cpu")):
            walls = []
            tac.reset_launches()
            for _ in range(5):
                t0 = time.perf_counter()
                mjt.encode(img, cfg, device=dv)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            ms[way] = (statistics.median(walls), tac.trellis_ac.launches)
        log("serial encode() [%s]: card %.3f ms (trellis_ac launches=%d in "
            "5 calls), cpu host engine %.3f ms (launches=%d), median of 5 "
            "warm calls; card vs host engine bytes equal=%s (%d bytes)"
            % (label, ms["card"][0], ms["card"][1],
               ms["cpu host engine"][0], ms["cpu host engine"][1], ok,
               len(cpu)))
        if not ok:
            raise SystemExit("serial encode() on the card differs from the "
                             "host engine")
        if ms["card"][1] <= 0 or ms["cpu host engine"][1] != 0:
            raise SystemExit("serial encode() took the wrong route")

    rates, _, max_err = check_families(
        ROUTE_FAMILIES, ROUTE_RECORDED, ROUTE_TIMED, kodak, odd, dev,
        default_mps, compare, t_phase, ROUTE_ONE_IMAGE, kept)

    # the arithmetic trellis of one 768x512 image, its stages synchronised
    acfg = family_config(dict(arithmetic=True))
    ctx = encoder.resolve_group(kodak[0], acfg)
    times = {}
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        encoder.encode_group(kodak[:1], ctx, dev, pool, times=times)
        total = time.perf_counter() - t0
    log("arithmetic per 768x512 image on the card: %.3f s; row trellis on "
        "the card %.3f s, coder on the host with the rows' download %.3f s; "
        "stages (ms): %s" % (total, times["trellis_arith_rows"],
                             times["trellis_arith_coder"], json.dumps(
                                 {k: round(v * 1e3, 3)
                                  for k, v in times.items()})))

    # the row trellis of one iMCU row (two block rows) of that image, its
    # card time and kernels (torch.profiler), and the card against the CPU
    # on it and on a tie-heavy row
    p1 = encoder._batch_p1(kodak[:1], ctx, dev)
    geom, merged, _, norms = p1
    g = geom[2][0]
    qz = np.asarray(ctx.qtables[0]).reshape(64)[consts.JPEG_ZIGZAG] \
        .astype(np.int32)
    q0 = int(qz[0])
    nc = trellis.get_num_dc_candidates(q0)
    lam = trellis.lambda_from_norm_t(norms[0], 14.75, 16.5)
    sl = slice(20 * g.bw, 22 * g.bw)
    with encoder.ArithTrainer(ctx.cfg, 0) as coder:
        for r in range(20):
            coder.train(merged[0][0][:, r * g.bw:(r + 1) * g.bw].t().cpu()
                        .numpy())
        rate_dc, rate_ac = (r.copy() for r in coder.rates())
    ltbl0 = float(np.float32(1.0 / (q0 * q0)))
    row_in = (merged[0][1][:, sl], merged[0][0][:, sl],
              torch.as_tensor(qz, device=dev), lam[sl])
    dc_in = (merged[0][1][0, sl].reshape(2, g.bw), q0, rate_dc, nc,
             (lam[sl] * ltbl0).reshape(2, g.bw))

    for label, fn in (
            ("AC band (1, 63)",
             lambda: trellis.arith_ac_row(*row_in, rate_ac, 1, 63)),
            ("DC, the pair of rows", lambda: trellis.arith_dc_imcu_row(
                *dc_in))):
        dev_ms, nk, wall_ms = profiled(fn, 3)
        log("arithmetic row trellis per iMCU row (2 block rows of %d "
            "blocks) [%s]: %.4f ms of device kernels (torch.profiler, %d "
            "kernels), %.3f ms synchronised wall under the profiler"
            % (g.bw, label, dev_ms, nk, wall_ms))
    rng = np.random.default_rng(12)
    n = 2 * g.bw
    raw = (rng.integers(-6, 7, (64, n)) * 8).astype(np.int32)
    raw[rng.random(raw.shape) < 0.6] = 0
    tie = (raw, (raw // 8).astype(np.int16), np.ones(64, np.int32),
           np.full(n, 1 / 64, np.float32))
    for label, args, dcs in (
            ("768x512 iMCU row 10", [a.cpu().numpy() for a in row_in],
             (dc_in[0].cpu().numpy(), dc_in[4].cpu().numpy())),
            ("tie-heavy row", list(tie), (tie[0][0].reshape(2, g.bw),
                                          tie[3].reshape(2, g.bw)))):
        qq0 = int(args[2][0])
        ncc = trellis.get_num_dc_candidates(qq0)
        for band in ((1, 63), (1, 8)):
            outs = [trellis.arith_ac_row(*(torch.as_tensor(a, device=d)
                                           for a in args), rate_ac, *band)
                    for d in (dev, "cpu")]
            same = torch.equal(outs[0].cpu(), outs[1])
            log("arithmetic AC row trellis card vs cpu [%s, band %s]: "
                "exact=%s" % (label, band, same))
            if not same:
                raise SystemExit("the arithmetic AC row trellis on the card "
                                 "differs from the CPU")
        outs = [trellis.arith_dc_imcu_row(
            torch.as_tensor(dcs[0], device=d), qq0, rate_dc, ncc,
            torch.as_tensor(dcs[1], device=d)) for d in (dev, "cpu")]
        same = torch.equal(outs[0].cpu(), outs[1])
        log("arithmetic DC iMCU-row trellis card vs cpu [%s]: exact=%s"
            % (label, same))
        if not same:
            raise SystemExit("the arithmetic DC row trellis on the card "
                             "differs from the CPU")
    log("per-image routes: %.1f s" % (time.perf_counter() - t_phase))
    return max_err


def flip_scan_bytes(data):
    """The stream with bytes inside each scan's entropy-coded data
    flipped (a corrupt stream; markers and headers left alone)."""
    from mozjpeg_tpu_torch.codec import marker
    b = bytearray(data)
    for scan in marker.parse(data).scans:
        for f in (0.3, 0.5, 0.7):
            i = scan.data_start + int(f * (scan.data_end - scan.data_start))
            if b[i] not in (0xFF, 0x00) and b[i - 1] != 0xFF:
                b[i] ^= 0x5A
    return bytes(b)


def decode_port_streams(kodak, huffman8, kept, dev):
    """Phase 9: the port's decode of its own streams on the card against
    its CPU path, exactly, and their PSNR against the sources; the
    decode_many rates of arithmetic and CMYK streams beside Huffman
    YCbCr ones; the device time of a float-IDCT and a YCCK render."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import decoder, marker
    from mozjpeg_tpu_torch.ops import dct
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    t_phase = time.perf_counter()
    tac.reset_launches()

    def check(label, card, cpu):
        ok = same(card, cpu)
        log("decode of the port's streams card vs cpu [%s]: equal=%s"
            % (label, ok))
        if not ok:
            raise SystemExit("decode on the card differs from the CPU path "
                             "(%s)" % label)

    streams, by = [], {}    # (label, source as decoded, JPEG)
    for name in ("default", "arithmetic", "arithmetic-notrellis", "rgb",
                 "cmyk", "ycck"):
        imgs, jpegs = kept[name]
        by[name] = [("%s %dx%d" % (name, im.shape[1], im.shape[0]), im, d)
                    for im, d in zip(imgs, jpegs)]
        streams += by[name]
    datas = [d for _, _, d in streams]
    cards = [mjt.decode(d) for d in datas]
    for (label, im, data), card in zip(streams, cards):
        check("decode " + label, card, mjt.decode(data, device="cpu"))
        ps = psnr(card, im)
        log("decode PSNR [%s] vs its %s source: %.2f dB"
            % (label, "CMYK" if im.shape[-1] == 4 else "RGB", ps))
        if card.shape != im.shape or ps < 25.0:
            raise SystemExit("decoded image far from its source (%s)"
                             % label)
    check("decode_many of all %d" % len(datas), mjt.decode_many(datas),
          mjt.decode_many(datas, device="cpu"))
    check("decode_many yuv of all %d" % len(datas),
          mjt.decode_many(datas, output="yuv"),
          mjt.decode_many(datas, output="yuv", device="cpu"))
    for label, _, data in by["default"]:
        for method in ("ifast", "float"):
            check("decode %s %s" % (method, label),
                  mjt.decode(data, dct_method=method),
                  mjt.decode(data, dct_method=method, device="cpu"))
    corrupt = flip_scan_bytes(datas[0])
    check("decode float, corrupt " + streams[0][0],
          mjt.decode(corrupt, dct_method="float"),
          mjt.decode(corrupt, dct_method="float", device="cpu"))
    rng = np.random.default_rng(13)
    coef = rng.integers(-32768, 32768, (4, 96, 8, 8)).astype(np.int16)
    coef.reshape(-1)[:4] = [-32768, 32767, -32768, 32767]
    q = rng.integers(1, 65536, (4, 8, 8))
    for name, fn, mult in (("ifast", dct.idct_ifast, dct.ifast_multipliers),
                           ("float", dct.idct_float, dct.float_multipliers)):
        tbl = np.stack([mult(t) for t in q])[:, None]
        check("idct_%s on int16 extremes with 16-bit tables" % name,
              fn(torch.as_tensor(coef, device=dev),
                 torch.as_tensor(tbl, device=dev)).cpu().numpy(),
              fn(torch.as_tensor(coef), torch.as_tensor(tbl)).numpy())
    for label, _, data in (by["default"][0], by["arithmetic"][0],
                           by["rgb"][1]):
        check("decode_grayscale " + label, mjt.decode_grayscale(data),
              mjt.decode_grayscale(data, device="cpu"))
    for label, im, data in (by["default"][1], by["cmyk"][0],
                            by["ycck"][1]):
        w = im.shape[1] // 2 + 1
        card = mjt.decode_cropped(data, 37, w)
        cpu = mjt.decode_cropped(data, 37, w, device="cpu")
        check("decode_cropped x=37 w=%d (aligned x %d, w %d) %s"
              % (w, card[1], card[2], label), card[0], cpu[0])
        if card[1:] != cpu[1:]:
            raise SystemExit("decode_cropped alignment differs")
    label, _, data = by["default"][0]
    bi_card, bi_cpu = mjt.BufferedImage(data), \
        mjt.BufferedImage(data, device="cpu")
    check("BufferedImage, all %d passes, %s" % (bi_card.num_scans, label),
          list(bi_card), list(bi_cpu))
    log("decode of the port's streams: checks %.1f s, trellis_ac "
        "launches=%d (decode reaches no hand kernel)"
        % (time.perf_counter() - t_phase, tac.trellis_ac.launches))
    if tac.trellis_ac.launches:
        raise SystemExit("decode launched the trellis kernel")

    # decode_many rates: Huffman YCbCr, arithmetic and CMYK lists of the
    # same eight 768x512 photos, 3 reps each, in turns
    lists = {
        "huffman ycbcr": huffman8,
        "arithmetic": mjt.encode_many(kodak[:8], family_config(dict(
            arithmetic=True, trellis_quant=False))),
        "cmyk": mjt.encode_many(family_images(kodak[:8], 4, 300),
                                family_config({})),
    }
    mp = sum(im.shape[0] * im.shape[1] for im in kodak[:8]) / 1e6
    walls = {k: [] for k in lists}
    for k, ds in lists.items():
        mjt.decode_many(ds)                       # warm-up
    torch.cuda.synchronize()
    for _ in range(3):
        for k, ds in lists.items():
            t0 = time.perf_counter()
            mjt.decode_many(ds)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    for k in lists:
        rates = [mp / w for w in walls[k]]
        log("decode_many MP/s [8x768x512 %s]: median %.3f (reps %s)"
            % (k, statistics.median(rates),
               ", ".join("%.3f" % v for v in rates)))

    # one render on the card: the float IDCT of a default stream, and a
    # YCCK stream
    for label, data, method in (("float IDCT, default 768x512",
                                 datas[0], "float"),
                                ("YCCK 768x512", by["ycck"][0][2],
                                 "islow")):
        jp = marker.parse(data)
        planes = decoder._entropy(jp, data)
        dev_ms, nk, wall_ms = profiled(lambda: decoder._render_t(
            jp, planes, None, True, method, True, dev))
        log("decode render [%s]: %.4f ms of device kernels "
            "(torch.profiler, %d kernels incl. uploads), %.3f ms "
            "synchronised wall under the profiler" % (label, dev_ms, nk,
                                                      wall_ms))
    log("decode of the port's streams: %.1f s"
        % (time.perf_counter() - t_phase))


# phase 10: djpeg flag sets run in-process on the card and on the CPU
DJPEG_FLAGS = (["-scale", "1/2", "-bmp"], ["-scale", "13/8"],
               ["-rgb565", "-bmp"], ["-colors", "256", "-gif"],
               ["-onepass", "-dither", "ordered", "-colors", "27",
                "-targa"], ["-grayscale", "-os2"])


def djpeg_surface(kept, huffman8, dev):
    """Phase 10: the djpeg surface on the card against the CPU path,
    exactly: decode_scaled at every M/8 (and decode at 8/8), RGB565 with
    and without the dither and through decode_many, the port's djpeg and
    jpegyuv in-process; then decode_scaled's MP/s beside decode's on the
    same eight photos, in turns, and the device time of two scaled
    renders. Launches no hand kernel."""
    import tempfile
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.cli import djpeg, jpegyuv
    from mozjpeg_tpu_torch.codec import decoder, marker
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    t_phase = time.perf_counter()
    tac.reset_launches()

    def check(label, card, cpu):
        ok = same(card, cpu)
        log("djpeg surface card vs cpu [%s]: equal=%s" % (label, ok))
        if not ok:
            raise SystemExit("the card differs from the CPU path (%s)"
                             % label)

    streams = []       # (label, JPEG)
    for name, idx in (("default", 0), ("default", 1), ("arithmetic", 0),
                      ("rgb", 0), ("cmyk", 0), ("ycck", 1)):
        im, data = kept[name][0][idx], kept[name][1][idx]
        streams.append(("%s %dx%d" % (name, im.shape[1], im.shape[0]), data))
    for label, data in streams:
        bad = [m for m in range(1, 17)
               if not same(mjt.decode_scaled(data, m, 8),
                           mjt.decode_scaled(data, m, 8, device="cpu"))]
        log("djpeg surface card vs cpu [decode_scaled M/8, M = 1..16, %s]: "
            "equal=%s%s" % (label, not bad, " (differ at M %s)" % bad
                            if bad else ""))
        if bad:
            raise SystemExit("decode_scaled on the card differs from the "
                             "CPU path (%s)" % label)
        check("decode_scaled 8/8 vs decode, " + label,
              mjt.decode_scaled(data, 8, 8), mjt.decode(data))
    label, data = streams[0]
    check("decode_scaled 3/8 without fancy upsampling, " + label,
          mjt.decode_scaled(data, 3, 8, False),
          mjt.decode_scaled(data, 3, 8, False, device="cpu"))
    for label, data in streams[:3]:
        for dither in (True, False):
            check("decode_rgb565 dither=%s, %s" % (dither, label),
                  mjt.decode_rgb565(data, dither=dither),
                  mjt.decode_rgb565(data, dither=dither, device="cpu"))
    datas = [d for _, d in streams[:3]]
    check("decode_many rgb565 of %d" % len(datas),
          mjt.decode_many(datas, output="rgb565"),
          mjt.decode_many(datas, output="rgb565", device="cpu"))

    label, data = streams[0]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.jpg")
        with open(src, "wb") as f:
            f.write(data)
        for flags in DJPEG_FLAGS:
            outs = []
            for device in (None, "cpu"):
                out = os.path.join(tmp, "out")
                rc = djpeg.main(flags + ["-outfile", out, src], device=device)
                with open(out, "rb") as f:
                    outs.append((rc, f.read()))
                os.remove(out)
            ok = outs[0] == outs[1] and outs[0][0] == 0
            log("djpeg surface card vs cpu [djpeg %s, %s]: exit %d, %d "
                "bytes, equal=%s" % (" ".join(flags), label, outs[0][0],
                                     len(outs[0][1]), ok))
            if not ok:
                raise SystemExit("djpeg on the card differs from the CPU "
                                 "path (%s)" % " ".join(flags))
        yuvs = []
        for device in (None, "cpu"):
            out = os.path.join(tmp, "out.yuv")
            rc = jpegyuv.main([src, out], device=device)
            with open(out, "rb") as f:
                yuvs.append((rc, f.read()))
        ok = yuvs[0] == yuvs[1] and yuvs[0][0] == 0
        log("djpeg surface card vs cpu [jpegyuv, %s]: %d bytes, equal=%s"
            % (label, len(yuvs[0][1]), ok))
        if not ok:
            raise SystemExit("jpegyuv on the card differs from the CPU path")
    log("djpeg surface: checks %.1f s, trellis_ac launches=%d (decode "
        "reaches no hand kernel)"
        % (time.perf_counter() - t_phase, tac.trellis_ac.launches))
    if tac.trellis_ac.launches:
        raise SystemExit("the djpeg surface launched the trellis kernel")

    # MP/s of output and of input: decode_scaled at 1/8, 1/2 and 2/1
    # beside decode, one photo after another, 3 reps in turns
    variants = {"decode": lambda d: mjt.decode(d)}
    for m in (1, 4, 16):
        variants["decode_scaled %d/8" % m] = \
            lambda d, m=m: mjt.decode_scaled(d, m, 8)
    in_mp = sum(jp.width * jp.height
                for jp in map(marker.parse, huffman8)) / 1e6
    out_mp = {k: sum(int(np.prod(fn(d).shape[:2])) for d in huffman8) / 1e6
              for k, fn in variants.items()}              # and warm-up
    torch.cuda.synchronize()
    walls = {k: [] for k in variants}
    for _ in range(3):
        for k, fn in variants.items():
            t0 = time.perf_counter()
            for d in huffman8:
                fn(d)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    for k in variants:
        w = statistics.median(walls[k])
        log("djpeg surface MP/s [%s, 8x768x512 huffman ycbcr, one at a "
            "time]: median %.3f of output, %.3f of input (reps %s s)"
            % (k, out_mp[k] / w, in_mp / w,
               ", ".join("%.4f" % v for v in walls[k])))

    # one scaled render on the card: 1/2 and 2/1 of a 768x512 photo
    data = huffman8[0]
    jp = marker.parse(data)
    planes = decoder._entropy(jp, data)
    for m in (4, 16):
        dev_ms, nk, wall_ms = profiled(lambda: decoder.render_scaled_t(
            jp, planes, m, True, True, None, dev))
        log("djpeg surface render [decode_scaled %d/8, 768x512]: %.4f ms of "
            "device kernels (torch.profiler, %d kernels incl. uploads), "
            "%.3f ms synchronised wall under the profiler"
            % (m, dev_ms, nk, wall_ms))
    log("djpeg surface: %.1f s" % (time.perf_counter() - t_phase))


def precision_phase(kodak8, jpegs8, dev, compare):
    """Phase 11: the 12-bit default on the card (the AC kernel's
    <14, 16383> instantiation), 12-bit decode and lossless at 8, 12 and
    16 bits. -> the kernels-line entry of the 12-bit instantiation."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder, trellis
    from mozjpeg_tpu_torch.ops import p1 as tp1
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    t_phase = time.perf_counter()
    cfg8 = mjt.EncoderConfig(quality=75)
    cfg12 = mjt.EncoderConfig(quality=75, precision=12)
    rng = np.random.default_rng(1200)
    corpus = []
    for i in range(8):
        hi = photo(512, 768, 1200 + i).astype(np.uint16) << 4
        corpus.append(hi | rng.integers(0, 16, hi.shape, dtype=np.uint16))
    mp = sum(im.shape[0] * im.shape[1] for im in corpus) / 1e6

    # every kernel launch of one 12-bit group against the plain version
    ctx = encoder.resolve_group(corpus[0], cfg12)
    rec = {}
    with ThreadPoolExecutor(8) as pool, p1_recording(rec):
        for f in encoder.encode_group(corpus, ctx, dev, pool, record=rec):
            f.result()
    recorded = rec["trellis_ac"]
    if len(recorded) != 3 or any(a[8:] != (14, 16383) for a in recorded):
        raise SystemExit("expected 3 trellis_ac<14, 16383> calls per "
                         "12-bit group")
    max_err = 0.0
    for name, args in zip(("Y", "Cb", "Cr"), recorded):
        max_err = max(max_err, compare(args, "12-bit group %s" % name))
    check_rows(rec, "12-bit group")
    check_p1(rec, "12-bit group")
    dense = example_trellis("dense", 8, 6144, dev, 17, 12)
    for args, label in (
            (dense, "12-bit dense"),
            (example_trellis("zero", 2, 4096, dev, 15, 12), "12-bit zero"),
            (example_trellis("tie", 2, 4096, dev, 14, 12), "12-bit tie"),
            (example_trellis("sparse", 3, 1001, dev, 16, 12),
             "12-bit ragged B=3"),
            (example_trellis("sparse", 1, 1, dev, 18, 12), "12-bit N=1")):
        max_err = max(max_err, compare(args, label))

    # the 12-bit main path, counts from 0
    mjt.encode_many(corpus, cfg12)                      # warm-up
    torch.cuda.synchronize()
    tac.reset_launches()
    tp1.reset_launches()
    outs = mjt.encode_many(corpus, cfg12)
    torch.cuda.synchronize()
    launches = dict(tac.trellis_ac.launches_by_kmax)
    p1n = (tp1.p1_blocks.launches, tp1.p1_eob_hist.launches)
    log("12-bit main path: 8x768x512, trellis_ac launches %s, p1_blocks "
        "launches %d, p1_eob_hist launches %d"
        % (json.dumps({"<%d>" % k: v for k, v in launches.items()}), *p1n))
    if launches[14] <= 0 or launches[10] != 0:
        raise SystemExit("the 12-bit path did not run trellis_ac<14, 16383>"
                         " alone")
    if p1n != (3, 3):
        raise SystemExit("the 12-bit group should launch each p1 kernel "
                         "once a component")
    if mjt.encode_many(corpus, cfg12) != outs:
        raise SystemExit("12-bit outputs differ between runs")
    if not all(o[:2] == b"\xff\xd8" and o[-2:] == b"\xff\xd9"
               for o in outs):
        raise SystemExit("12-bit output without SOI/EOI")
    for crop in (corpus[0][:128, :192], corpus[1][:97, :131]):
        card = mjt.encode_many([crop], cfg12)
        cpu = mjt.encode_many([crop], cfg12, device="cpu")
        log("12-bit card vs cpu bytes [%dx%d crop]: equal=%s (%d bytes)"
            % (crop.shape[1], crop.shape[0], card == cpu, len(cpu[0])))
        if card != cpu:
            raise SystemExit("12-bit card output differs from the CPU path")

    # encode_many MP/s beside the 8-bit default, in turns
    walls = {"8-bit default": [], "12-bit default": []}
    for _ in range(3):
        for label, imgs, cfg in (("8-bit default", kodak8, cfg8),
                                 ("12-bit default", corpus, cfg12)):
            t0 = time.perf_counter()
            mjt.encode_many(imgs, cfg)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
    for label, w in walls.items():
        log("precision encode_many MP/s [%s, 8x768x512]: median %.3f (reps "
            "%s s)" % (label, mp / statistics.median(w),
                       ", ".join("%.4f" % v for v in w)))

    times = {}
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        encoder.encode_group(corpus, ctx, dev, pool, times=times)
        group_s = time.perf_counter() - t0
    log("12-bit stages of one 8x768x512 group (ms): %s; total %.1f"
        % (json.dumps({k: round(v * 1e3, 3) for k, v in times.items()}),
           group_s * 1e3))

    # the <14, 16383> kernel per group, its plain version and bounds
    def group_kernel():
        for a in recorded:
            tac.trellis_ac(*a)

    k_ms, k_un = cuda_ms(group_kernel, 10), cuda_ms(group_kernel, 10,
                                                     hold=False)
    d_ms = cuda_ms(lambda: tac.trellis_ac(*dense), 5)
    p_ms = cuda_ms(lambda: [tac.trellis_ac_plain(*a) for a in recorded], 1)
    nbytes, ops, nnz, nblk = 0, 0.0, 0, 0
    for a in recorded:
        b_, o_ = trellis_bound(a)
        nbytes += b_
        ops += o_
        q8 = (a[1] << 3)[:, None]
        nnz += int(((a[0][1:].abs() + (q8[1:] >> 1)) // q8[1:] != 0).sum())
        nblk += a[0].shape[1]
    bound_ms, bound_by = bound(nbytes, ops)
    d_bytes, d_ops = trellis_bound(dense)
    d_bound, d_by = bound(d_bytes, d_ops)
    log("trellis_ac<14, 16383> per 12-bit group (3 launches, %.2f nonzero "
        "AC coefficients per block): kernel %.4f ms (%.4f ms with the "
        "host's launch gaps), plain %.3f ms, bound %.4f ms (%.3g ops, %d "
        "bytes, by %s), %.1f%% of the bound; dense input (N=%d) %.4f ms, "
        "bound %.4f ms (by %s)"
        % (nnz / nblk, k_ms, k_un, p_ms, bound_ms, ops, nbytes, bound_by,
           100 * bound_ms / k_ms, dense[0].shape[1], d_ms, d_bound, d_by))

    # 12-bit decode on the card against the CPU, MP/s beside 8-bit
    decs = mjt.decode_many(outs)
    cpus = mjt.decode_many(outs[:2], device="cpu")
    for i in range(2):
        ok = same(decs[i], cpus[i])
        log("12-bit decode_many card vs cpu [image %d]: equal=%s (%s)"
            % (i, ok, decs[i].dtype))
        if not ok:
            raise SystemExit("12-bit decode on the card differs from the "
                             "CPU path")
    # the default's deringing keeps the 8-bit threshold (127 above the
    # centre) at 12 bits, as the JAX package does, and reshapes most
    # bright blocks, so the distance to the source is checked without it
    def psnr12(a, b):
        return psnr(a, b) + 20 * np.log10(4095 / 255.0)

    nodr = mjt.decode_many(mjt.encode_many(
        corpus[:2], mjt.EncoderConfig(quality=75, precision=12,
                                      overshoot_deringing=False)))
    ps = [psnr12(d, im) for d, im in zip(nodr, corpus)]
    log("12-bit decode PSNR vs source (dB, peak 4095): default %s; "
        "without deringing %s"
        % (", ".join("%.2f" % psnr12(d, im) for d, im in zip(decs, corpus)),
           ", ".join("%.2f" % p for p in ps)))
    if min(ps) < 20.0:
        raise SystemExit("12-bit decoded image far from its source")
    walls = {"8-bit huffman ycbcr": [], "12-bit": []}
    for _ in range(3):
        for label, datas in (("8-bit huffman ycbcr", jpegs8),
                             ("12-bit", outs)):
            t0 = time.perf_counter()
            mjt.decode_many(datas)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
    for label, w in walls.items():
        log("precision decode_many MP/s [%s, 8x768x512]: median %.3f (reps "
            "%s s)" % (label, mp / statistics.median(w),
                       ", ".join("%.4f" % v for v in w)))

    # lossless round trips through the public entry points
    for prec, img, pred in ((8, kodak8[0], 1), (12, corpus[0], 4),
                            (16, (corpus[1] << 4) | (corpus[2] & 15), 7)):
        data = mjt.encode_lossless(img, pred, 0, prec)
        card = [mjt.decode(data), mjt.decode_many([data])[0]]
        cpu = mjt.decode(data, device="cpu")
        ok = all(same(c, cpu) for c in card) and same(cpu, img)
        log("lossless %d-bit round trip [768x512, predictor %d]: %d bytes, "
            "equal=%s" % (prec, pred, len(data), ok))
        if not ok:
            raise SystemExit("lossless round trip differs")
    log("precision: %.1f s" % (time.perf_counter() - t_phase))
    return {"name": "trellis_ac<14, 16383>", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": launches[14], "max_abs_err": max_err,
            "exact": max_err == 0.0, "ms": k_ms, "kernel_ms": k_ms,
            "ms_with_launch_gaps": k_un, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "nonzero_ac_per_block": nnz / nblk, "dense_ms": d_ms,
            "dense_bound_ms": d_bound}


def write_ppm(path, img):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h) + img.tobytes())
    return path


def write_png(path, img):
    """An 8-bit RGB PNG, every row with filter 0, IDAT at zlib level 1."""
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def zz_to_nat(planes):
    """(bh, bw, 64) zigzag planes -> (bh, bw, 8, 8) natural blocks."""
    from mozjpeg_tpu_torch import consts
    nat = np.empty_like(planes)
    nat[..., consts.JPEG_ZIGZAG] = planes
    return nat.reshape(planes.shape[:2] + (8, 8))


def timed3(fn):
    """Median and the three wall times (s) of fn, synchronised."""
    import torch
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def remaining_surfaces(kodak, dev, smi, compare, h=3024, w=4032):
    """Phase 12: cjpeg, yuvjpeg and encode_raw_yuv on the card at
    4032x3024 (h, w: at least 1024x1536 and MCU-aligned), every AC kernel
    launch of their first calls against the plain version, reporting and
    the TurboJPEG API on a 768x512 photo, jpegtran's transforms on the
    12 MP JPEG, and their times.
    -> (the <10, 1023> launches of each of its card paths, the largest
    kernel-vs-plain difference)."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch import turbojpeg as tj
    from mozjpeg_tpu_torch.cli import cjpeg, jpegtran, wrjpgcom, yuvjpeg
    from mozjpeg_tpu_torch.codec import encoder, transcode
    from mozjpeg_tpu_torch.codec.encoder import encode_raw_yuv
    from mozjpeg_tpu_torch.ops import color, sample
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    t_phase = time.perf_counter()
    mp = h * w / 1e6
    size = "%dx%d" % (w, h)
    big = photo(h, w, 1212)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    d = tmp.name
    ppm_path, png_path = os.path.join(d, "in.ppm"), os.path.join(d, "in.png")
    write_ppm(ppm_path, big)
    write_png(png_path, big)
    launches = {}
    dc_launches = {}
    recs = {}
    max_err = 0.0

    def counted(name, fn, check=False):
        """fn's <10, 1023> launches (and its trellis_dc ones). With check,
        every card path of this phase trellises through encoder._finals,
        which then records each launch's arguments; each is held against
        the plain version."""
        nonlocal max_err
        rec = {}
        torch.cuda.synchronize()
        tac.reset_launches()
        trw.reset_launches()
        with recording(rec) if check else contextlib.nullcontext():
            out = fn()
            torch.cuda.synchronize()
        launches[name] = tac.trellis_ac.launches_by_kmax[10]
        dc_launches[name] = trw.trellis_dc.launches
        if tac.trellis_ac.launches_by_kmax[14]:
            raise SystemExit("%s launched the 12-bit instantiation" % name)
        if check:
            recs[name] = rec
            recorded = rec.get("trellis_ac", [])
            if (len(recorded) != launches[name]
                    or len(rec.get("trellis_dc", [])) != dc_launches[name]):
                raise SystemExit("%s: %d launches recorded of %d"
                                 % (name, len(recorded), launches[name]))
            for i, args in enumerate(recorded):
                max_err = max(max_err, compare(
                    args, "phase 12 %s %s launch %d" % (name, size, i)))
            check_rows(rec, "phase 12 %s %s" % (name, size))
            check_p1(rec, "phase 12 %s %s" % (name, size))
        return out

    # 1. cjpeg on the card, PPM and PNG, against the host engine
    flags = ["-report", "-verbose"]
    cfg_cj = cjpeg.config_from_args(cjpeg.build_parser().parse_args(flags))

    def run_cjpeg(src, out):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cjpeg.main(flags + ["-outfile", out, src], device="cuda")
        if rc != 0:
            raise SystemExit("cjpeg exited with %d" % rc)
        with open(out, "rb") as f:
            return f.read(), err.getvalue()

    cj_path = os.path.join(d, "cjpeg.jpg")
    run_cjpeg(ppm_path, cj_path)                          # warm-up
    jpg, err = counted("cjpeg", lambda: run_cjpeg(ppm_path, cj_path),
                       check=True)
    jpg_png, err_png = run_cjpeg(png_path, os.path.join(d, "png.jpg"))
    cpu_trace = []
    t0 = time.perf_counter()
    host = mjt.encode(big, cfg_cj, trace=cpu_trace.append, device="cpu")
    host_s = time.perf_counter() - t0
    # -report's "\rPass n/m" prints without a newline before the trace
    scan_re = r"SCAN [0-9,]+: \d+ \d+ \d+ \d+"
    scans, scans_png = re.findall(scan_re, err), re.findall(scan_re, err_png)
    passes = [p for p in err.replace("\n", "\r").split("\r") if p]
    ok = (jpg == host and jpg_png == host and scans == cpu_trace
          and scans_png == cpu_trace and len(scans) > 0)
    log("remaining surfaces cjpeg card vs cpu [%s, PPM and PNG, -report "
        "-verbose]: %d bytes, equal=%s, SCAN lines %d equal=%s, last report "
        "%r, trellis_ac<10, 1023> launches=%d"
        % (size, len(jpg), jpg == host and jpg_png == host, len(scans),
           scans == cpu_trace and scans_png == cpu_trace,
           passes[-1].strip() if passes else "", launches["cjpeg"]))
    if not ok or launches["cjpeg"] <= 0 or dc_launches["cjpeg"] != 3:
        raise SystemExit("cjpeg on the card differs from the host engine, "
                         "or did not launch trellis_dc once a component")
    dc12 = {k + "_12mp": v for k, v in row_stage(
        "trellis_dc", recs["cjpeg"]["trellis_dc"], "cjpeg's %s group" % size,
        smi, 10)[0].items() if k != "bound_by"}
    dc12.update({k + "_12mp": v for k, v in dc_clock_split(
        recs["cjpeg"]["trellis_dc"][0], "cjpeg's %s luma" % size,
        smi).items()})
    eob12 = {k + "_12mp": v for k, v in p1_kernel_times(
        "p1_eob_hist", recs["cjpeg"]["p1_eob_hist"],
        "cjpeg's %s image (3 components)" % size, smi, 10).items()
        if k != "bound_by"}
    p1b12 = {k + "_12mp": v for k, v in p1_kernel_times(
        "p1_blocks", recs["cjpeg"]["p1_blocks"],
        "cjpeg's %s image (3 components)" % size, smi, 10).items()
        if k != "bound_by"}
    # the EOB-run DP at 12 MP (a luma row of 504 blocks): encode() with
    # trellis_eob_opt, its launches held against the plain version, timed
    erec = {}
    with recording(erec):
        mjt.encode(big, mjt.EncoderConfig(quality=75, trellis_eob_opt=True),
                   device=dev)
    torch.cuda.synchronize()
    if len(erec.get("trellis_eob", [])) != 3:
        raise SystemExit("expected 3 EOB-run DP launches in encode() of the "
                         "%s photo with trellis_eob_opt" % size)
    check_rows(erec, "phase 12 encode() %s trellis_eob_opt" % size)
    dp12 = {k + "_12mp": v for k, v in row_stage(
        "trellis_eob", erec["trellis_eob"],
        "encode() of the %s photo with trellis_eob_opt" % size, smi,
        10)[0].items() if k != "bound_by"}

    # 2. yuvjpeg and encode_raw_yuv on the card
    ycc = color.rgb_to_ycc(torch.from_numpy(big).to(dev))
    planes = [ycc[..., 0].cpu().numpy()] + [
        sample.downsample_h2v2(ycc[..., c].contiguous()).cpu().numpy()
        for c in (1, 2)]
    yuv_path = os.path.join(d, "in.yuv")
    with open(yuv_path, "wb") as f:
        for pl in planes:
            f.write(pl.tobytes())
    yj_path = os.path.join(d, "yuv.jpg")
    rc = counted("yuvjpeg", lambda: yuvjpeg.main(
        ["75", "%dx%d" % (w, h), yuv_path, yj_path], device="cuda"),
        check=True)
    with open(yj_path, "rb") as f:
        yj = f.read()
    cfg75 = mjt.EncoderConfig(quality=75)
    samp = [(2, 2), (1, 1), (1, 1)]
    raw = counted("encode_raw_yuv", lambda: encode_raw_yuv(
        planes, w, h, samp, cfg75), check=True)
    want_yj = mjt.encode(big, mjt.EncoderConfig(
        quality=75, force_baseline=True, subsampling=(2, 2)), device="cpu")
    want_raw = mjt.encode(big, cfg75, device="cpu")
    log("remaining surfaces yuvjpeg / encode_raw_yuv card vs encode() on "
        "the cpu [%s I420]: rc=%d, %d / %d bytes, equal=%s / %s, "
        "trellis_ac<10, 1023> launches=%d / %d"
        % (size, rc, len(yj), len(raw), yj == want_yj, raw == want_raw,
           launches["yuvjpeg"], launches["encode_raw_yuv"]))
    if rc != 0 or yj != want_yj or raw != want_raw \
            or not launches["yuvjpeg"] or not launches["encode_raw_yuv"]:
        raise SystemExit("yuvjpeg / encode_raw_yuv differ from encode()")

    # the stage times of the 12 MP image's group on the card
    times = {}
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        encoder.encode_group([big], encoder.resolve_group(big, cfg_cj), dev,
                             pool, times=times)[0].result()
        group_s = time.perf_counter() - t0
    log("remaining surfaces stages of cjpeg's %s group (ms): %s; "
        "total %.1f" % (size, json.dumps({k: round(v * 1e3, 3)
                                    for k, v in times.items()}),
                        group_s * 1e3))

    # 3. reporting on the card against the CPU, one 768x512 photo
    rep = {}
    for device in ("cuda", "cpu"):
        ev, tr = [], []
        out = mjt.encode_many([kodak[0]], cfg75, device=device,
                              progress=lambda *a: ev.append(a),
                              trace=tr.append)
        rep[device] = (out, ev, tr)
    ok = rep["cuda"] == rep["cpu"]
    log("remaining surfaces reporting card vs cpu [encode_many 768x512]: "
        "passes %s, %d SCAN lines, equal=%s"
        % ([e[2] for e in rep["cuda"][1]], len(rep["cuda"][2]), ok))
    if not ok:
        raise SystemExit("reporting on the card differs from the CPU")

    # 4. the TurboJPEG API on the card against the CPU
    img = kodak[1]
    card, cpu = tj.TJ(device="cuda"), tj.TJ(device="cpu")
    bgrx = np.concatenate([img[..., ::-1], img[..., :1]], -1)
    checks = {}

    def both(fn):
        return fn(card), fn(cpu)

    tac.reset_launches()
    for sname, sv in (("4:2:0", tj.TJSAMP_420), ("4:4:0", tj.TJSAMP_440)):
        for t in (card, cpu):
            t.set(tj.TJPARAM_SUBSAMP, sv)
        a, b = both(lambda t: t.compress(img))
        checks["compress RGB " + sname] = a == b
        data = a
        a, b = both(lambda t: t.compress(bgrx, tj.TJPF_BGRX))
        checks["compress BGRX " + sname] = a == b
        yuv_a, yuv_b = both(lambda t: t.encode_yuv(img, align=4))
        checks["encode_yuv " + sname] = yuv_a == yuv_b
        a, b = both(lambda t: t.decode_yuv(yuv_a, img.shape[1],
                                           img.shape[0], align=4))
        checks["decode_yuv " + sname] = same(a, b)
        a, b = both(lambda t: t.compress_from_yuv(yuv_a, img.shape[1],
                                                  img.shape[0], align=4))
        checks["compress_from_yuv " + sname] = a == b
        a, b = both(lambda t: t.decompress_to_yuv(data))
        checks["decompress_to_yuv " + sname] = a == b
    a, b = both(lambda t: t.transform(data, tj.TJXOP_ROT90))
    checks["transform rot90"] = a == b
    for t in (card, cpu):
        t.set_scaling_factor(1, 2)
    a, b = both(lambda t: t.decompress(data))
    checks["decompress 1/2"] = same(a, b)
    tj_launches = tac.trellis_ac.launches
    log("remaining surfaces TurboJPEG card vs cpu [768x512]: %s; "
        "trellis_ac launches=%d" % (", ".join(
            "%s equal=%s" % kv for kv in checks.items()), tj_launches))
    if not all(checks.values()) or tj_launches:
        raise SystemExit("the TurboJPEG API on the card differs from the "
                         "CPU, or launched the trellis")

    # 5. jpegtran on the 12 MP JPEG (host-only)
    src_path = os.path.join(d, "src.jpg")
    with open(src_path, "wb") as f:
        f.write(wrjpgcom.insert_comment(jpg, b"chip smoke", False))
    src = transcode.read_coefficients(open(src_path, "rb").read())
    sp = src.planes

    def tran(flags):
        out = os.path.join(d, "tran.jpg")
        rc = jpegtran.main(flags + ["-outfile", out, src_path])
        if rc != 0:
            raise SystemExit("jpegtran %s exited with %d" % (flags, rc))
        with open(out, "rb") as f:
            return f.read()

    sign = np.where(np.arange(8) % 2 == 1, -1, 1)[None, None, None, :]
    results = {}
    tac.reset_launches()
    out = tran(["-rotate", "90"])
    got = transcode.read_coefficients(out)
    results["-rotate 90"] = (got.jp.width, got.jp.height) == (h, w) and all(
        np.array_equal(zz_to_nat(g), np.transpose(zz_to_nat(p)[::-1],
                                                  (1, 0, 3, 2)) * sign)
        for g, p in zip(got.planes, sp))
    out = tran(["-crop", "1024x768+512+256"])
    got = transcode.read_coefficients(out)
    results["-crop 1024x768+512+256"] = (
        (got.jp.width, got.jp.height) == (1024, 768) and all(
            np.array_equal(g, p[256 * c.v // 16:256 * c.v // 16 + 96 * c.v
                                // 2, 512 * c.h // 16:512 * c.h // 16
                                + 128 * c.h // 2])
            for g, p, c in zip(got.planes, sp, src.jp.components)))
    out = tran(["-grayscale"])
    got = transcode.read_coefficients(out)
    results["-grayscale"] = (len(got.planes) == 1
                             and np.array_equal(got.planes[0], sp[0]))
    out = tran(["-copy", "all"])
    got = transcode.read_coefficients(out)
    results["-copy all"] = (b"chip smoke" in out and all(
        np.array_equal(g, p) for g, p in zip(got.planes, sp)))
    rescan = tran(["-optimize", "-progressive"])
    got = transcode.read_coefficients(rescan)
    results["-optimize -progressive"] = (
        all(np.array_equal(g, p) for g, p in zip(got.planes, sp))
        and same(mjt.decode(rescan), mjt.decode(jpg)))
    log("remaining surfaces jpegtran [%s, %d bytes, jpegrescan %d bytes]: "
        "%s; trellis_ac launches=%d"
        % (size, len(jpg), len(rescan), ", ".join(
            "%s equal=%s" % kv for kv in results.items()),
           tac.trellis_ac.launches))
    if not all(results.values()) or tac.trellis_ac.launches:
        raise SystemExit("jpegtran's coefficients are not as expected")

    # 6. times: median of 3 reps each, with the card's name and limit
    for name, fn in (
            ("cjpeg on the card", lambda: counted(
                "cjpeg (timed)", lambda: run_cjpeg(ppm_path, cj_path))),
            ("encode() host engine on the cpu", lambda: mjt.encode(
                big, cfg_cj, device="cpu")),
            ("encode_raw_yuv on the card", lambda: counted(
                "encode_raw_yuv (timed)", lambda: encode_raw_yuv(
                    planes, w, h, samp, cfg75))),
            ("jpegtran -rotate 90 (host)", lambda: tran(["-rotate", "90"])),
            ("jpegtran -optimize -progressive (host)", lambda: tran(
                ["-optimize", "-progressive"]))):
        med, walls = timed3(fn)
        log("remaining surfaces time [%s, %s] on %s: median %.4f s "
            "(reps %s), %.3f MP/s" % (name, size, smi, med, ", ".join(
                "%.4f" % v for v in walls), mp / med))
    log("remaining surfaces: first host-engine encode %.3f s; launches %s; "
        "trellis_dc launches %s; %.1f s"
        % (host_s, json.dumps(launches), json.dumps(dc_launches),
           time.perf_counter() - t_phase))
    tmp.cleanup()
    return launches, max_err, dc12, eob12, p1b12, dp12


def row_stage(kind, recorded, label, smi, reps=20):
    """A row-scan kernel's stage over its recorded launches (kind
    "trellis_dc" or "trellis_eob"): the stage with the kernel and with the
    plain version in turns (synchronised wall ms), the kernel's device ms
    held and with the host's launch gaps, the first launch's held, the
    plain version's, the bound, and the first launch's serial chain (v*bw
    steps a DC chain, bw an EOB row) -> (those numbers, the kernel's and
    the plain version's stage functions)."""
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    kernel_fn, plain_fn, bound_fn = {
        "trellis_dc": (trw.trellis_dc, trw.trellis_dc_plain, dc_bound),
        "trellis_eob": (trw.eob_dp, trw.eob_dp_plain, eob_bound)}[kind]

    def kernel():
        for a in recorded:
            kernel_fn(*a)

    def plain():
        for a in recorded:
            plain_fn(*a)

    turns = {kernel: [], plain: []}
    for fn in (kernel, plain, plain, kernel):
        turns[fn].append(sync_ms(fn, 3))
    k_ms, k_un = cuda_ms(kernel, reps), cuda_ms(kernel, reps, hold=False)
    first_ms = cuda_ms(lambda: kernel_fn(*recorded[0]), reps)
    p_ms = cuda_ms(plain, max(1, reps // 10))
    nbytes, ops = (sum(x) for x in zip(*(bound_fn(a) for a in recorded)))
    bound_ms, bound_by = bound(nbytes, ops)
    a0 = recorded[0]
    steps = a0[6] * a0[0].shape[2] if kind == "trellis_dc" else a0[3]
    log("%s of %s (%d launches) on %s: kernel %.4f ms (%.4f ms with the "
        "host's launch gaps), plain %.3f ms, bound %.6f ms (%.3g ops, %d "
        "bytes, by %s), %.2f%% of the bound; first launch %.4f ms, its "
        "serial chain %d steps, %.3f us a step; the stage in turns "
        "(synchronised wall ms): kernel %s, plain %s"
        % (kind, label, len(recorded), smi, k_ms, k_un, p_ms, bound_ms, ops,
           nbytes, bound_by, 100 * bound_ms / k_ms, first_ms, steps,
           first_ms * 1e3 / steps, ["%.3f" % t for t in turns[kernel]],
           ["%.3f" % t for t in turns[plain]]))
    return ({"ms": k_ms, "kernel_ms": k_ms, "ms_with_launch_gaps": k_un,
             "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "first_launch_ms": first_ms, "chain_steps": steps,
             "stage_wall_ms": statistics.median(turns[kernel]),
             "stage_wall_ms_plain": statistics.median(turns[plain])},
            kernel, plain)


def dc_stage(recorded, group, ctx, dev, smi, launches):
    """Phase 6's DC trellis of one 8x768x512 group (its three recorded
    launches): row_stage, then torch.profiler's device time, kernel count
    and top kernels of the stage with the plain version and with the
    kernel, and of the group's p1. -> the kernels-line entry of
    trellis_dc (launches: phase 4's count)."""
    import torch
    from mozjpeg_tpu_torch.codec import encoder, pipeline_t
    nums, kernel, plain = row_stage("trellis_dc", recorded,
                                    "one 8x768x512 group", smi)
    cfg = ctx.cfg
    geom, bufs = pipeline_t.prep_ycc_batch(group, ctx.samp)
    bufs_t = torch.from_numpy(bufs).to(dev)
    ris = encoder.trellis_ris(cfg, geom[2])
    slots = encoder.qt_slots(cfg, ctx.cs, ctx.ncomps)

    def p1():
        pipeline_t.p1_batch_pre(bufs_t, tuple(geom[2]), ctx.qtables,
                                cfg.overshoot_deringing,
                                cfg.dct_method.value, ris, slots)

    for label, fn in (("DC stage, plain version (before)", plain),
                      ("DC stage, kernel (after)", kernel), ("p1", p1)):
        dev_ms, nk, top = profiled_top(fn, 3)
        log("profile of one 8x768x512 group [%s] on %s: %.4f ms of device "
            "kernels (torch.profiler), %d kernels; top %s"
            % (label, smi, dev_ms, nk, json.dumps(top)))
    return dict(name="trellis_dc", route="cuda", source=ROWS_SOURCE,
                replaces=DC_REPLACES, launches=launches, library_ms=None,
                **nums)


@contextlib.contextmanager
def plain_p1():
    """p1's wrappers replaced by their plain versions inside (the route
    p1 took on the card before its kernels), for the stage comparison and
    profile of phase 6."""
    from mozjpeg_tpu_torch.ops import p1 as tp1
    blocks, eob = tp1.p1_blocks, tp1.p1_eob_hist
    tp1.p1_blocks, tp1.p1_eob_hist = tp1.p1_blocks_plain, tp1.p1_eob_hist_plain
    try:
        yield
    finally:
        tp1.p1_blocks, tp1.p1_eob_hist = blocks, eob


def p1_graph_ms(blocks, reps=20):
    """The plain p1 of a group's recorded p1_blocks launches without its
    histogram (whose bincount synchronises): dering, FDCT, quantization
    and the norm of each component, captured as one CUDA graph -> (device
    ms a replay, held), or None where the capture fails (with the
    reason). A yardstick only: no route of the port replays it."""
    import torch
    from mozjpeg_tpu_torch.ops import p1 as tp1
    tabs = [tp1._qtable(a[3]) for a in blocks]
    q81s = [torch.as_tensor(t.reshape(8, 8, 1), device=blocks[0][0].device)
            for t in tabs]

    def body():
        for a, q81, t in zip(blocks, q81s, tabs):
            plane, bh, bw, _, dering_on, precision = a
            _, raw = tp1.quantize_islow_plain(plane, bh, bw, q81, int(t[0]),
                                              dering_on, precision)
            tp1.norm_seq(raw)
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]
    return cuda_ms(graph.replay, reps), ""


def p1_kernel_times(kind, recorded, label, smi, reps=20):
    """A p1 kernel over a group's recorded launches (the EOB kernel adding
    into scratch histograms): its device ms held and with the host's
    launch gaps, its first (luma) launch's held, its plain version's and
    its bound -> those numbers."""
    import torch
    from mozjpeg_tpu_torch.ops import p1 as tp1
    if kind == "p1_blocks":
        def kernel():
            for a in recorded:
                tp1.p1_blocks(*a)

        def plain():
            for a in recorded:
                tp1.p1_blocks_plain(*a)

        def first():
            tp1.p1_blocks(*recorded[0])
    else:
        scratch = [torch.zeros_like(a[1]) for a in recorded]

        def kernel():
            for a, h in zip(recorded, scratch):
                tp1.p1_eob_hist(a[0], h, *a[2:])

        def plain():
            for a, h in zip(recorded, scratch):
                tp1.p1_eob_hist_plain(a[0], h, *a[2:])

        def first():
            tp1.p1_eob_hist(recorded[0][0], scratch[0], *recorded[0][2:])
    k_ms, k_un = cuda_ms(kernel, reps), cuda_ms(kernel, reps, hold=False)
    first_ms = cuda_ms(first, reps)
    p_ms = cuda_ms(plain, 3, hold=False)
    nbytes, ops = (sum(x) for x in zip(*(p1_bound(kind, a)
                                         for a in recorded)))
    bound_ms, bound_by = bound(nbytes, ops, H100_INT32_OPS)
    log("%s of %s (%d launches) on %s: kernel %.4f ms (%.4f ms with the "
        "host's launch gaps), plain %.3f ms, bound %.6f ms (%.4g integer "
        "ops, %d bytes, by %s), %.2f%% of the bound; first (luma) launch "
        "%.4f ms" % (kind, label, len(recorded), smi, k_ms, k_un, p_ms,
                     bound_ms, ops, nbytes, bound_by, 100 * bound_ms / k_ms,
                     first_ms))
    return dict(ms=k_ms, kernel_ms=k_ms, ms_with_launch_gaps=k_un,
                plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                first_launch_ms=first_ms)


def p1_stage(rec, group, ctx, dev, smi, launches, reps=20):
    """Phase 6's p1 of one 8x768x512 group from its recorded launches
    (3 of each kernel): each kernel's device ms held and with the host's
    launch gaps, its plain version's, the bound; the stage (p1_batch_pre)
    with the kernels and with the plain versions in turns (synchronised
    wall ms) and under torch.profiler, split by p1's ranges; the plain p1
    without its histogram as one CUDA graph. launches: phase 4's counts.
    -> the kernels-line entries of p1_blocks and p1_eob_hist."""
    import torch
    from mozjpeg_tpu_torch.codec import encoder, pipeline_t
    blocks, eobs = rec["p1_blocks"], rec["p1_eob_hist"]
    if len(blocks) != 3 or len(eobs) != 3:
        raise SystemExit("expected 3 launches of each p1 kernel per group, "
                         "saw %d and %d" % (len(blocks), len(eobs)))
    replaces = {"p1_blocks": P1_BLOCKS_REPLACES,
                "p1_eob_hist": P1_EOB_REPLACES}
    entries = []
    for kind, recorded in (("p1_blocks", blocks), ("p1_eob_hist", eobs)):
        entries.append(dict(
            name=kind, route="cuda", source=P1_SOURCE,
            replaces=replaces[kind], launches=launches[kind],
            library_ms=None, **p1_kernel_times(
                kind, recorded, "one 8x768x512 group", smi, reps)))

    # the stage, kernels and plain versions in turns, and its profile
    cfg = ctx.cfg
    geom, bufs = pipeline_t.prep_ycc_batch(group, ctx.samp)
    bufs_t = torch.from_numpy(bufs).to(dev)
    ris = encoder.trellis_ris(cfg, geom[2])
    slots = encoder.qt_slots(cfg, ctx.cs, ctx.ncomps)

    def stage():
        pipeline_t.p1_batch_pre(bufs_t, tuple(geom[2]), ctx.qtables,
                                cfg.overshoot_deringing,
                                cfg.dct_method.value, ris, slots)

    walls = {"kernels": [], "plain": []}
    for way in ("kernels", "plain", "plain", "kernels"):
        with plain_p1() if way == "plain" else contextlib.nullcontext():
            walls[way].append(sync_ms(stage, 3))
    prof = {}
    for way in ("plain", "kernels"):
        with plain_p1() if way == "plain" else contextlib.nullcontext():
            prof[way] = profiled_top(stage, 3)
        log("p1 stage of one 8x768x512 group [%s] on %s: synchronised wall "
            "%s ms; %.4f ms of device kernels (torch.profiler), %d kernels; "
            "top [kernel, device ms, kernels] %s"
            % ("the plain versions (the route before the kernels)"
               if way == "plain" else "the kernels", smi,
               ["%.3f" % t for t in walls[way]], prof[way][0], prof[way][1],
               json.dumps(prof[way][2])))
    g_ms, why = p1_graph_ms(blocks, reps)
    log("p1 plain version without its histogram (dering, FDCT, quantize, "
        "norm of 3 components) as one CUDA graph on %s: %s; p1_blocks "
        "kernel (the same work and the histogram) %.4f ms"
        % (smi, "%.4f ms a replay, held" % g_ms if g_ms is not None
           else "not measured (%s)" % why, entries[0]["ms"]))
    stage_nums = {"stage_wall_ms": statistics.median(walls["kernels"]),
                  "stage_wall_ms_plain": statistics.median(walls["plain"]),
                  "stage_device_ms": prof["kernels"][0],
                  "stage_kernels": prof["kernels"][1],
                  "stage_device_ms_plain": prof["plain"][0],
                  "stage_kernels_plain": prof["plain"][1],
                  "plain_graph_ms": g_ms}
    entries[0].update(stage_nums)
    return entries


def dev_first_routes(group, ctx, dev):
    """Phase 6's stage times of one group with the device-tablegen route
    (MJ_DEV_FIRST=1, the default) and the host route (0), in turns, with
    the same bytes."""
    import torch
    from mozjpeg_tpu_torch.codec import encoder
    outs = {}
    for flag in ("1", "0", "0", "1"):
        os.environ["MJ_DEV_FIRST"] = flag
        times = {}
        with ThreadPoolExecutor(8) as pool:
            t0 = time.perf_counter()
            got = [f.result() for f in encoder.encode_group(
                group, ctx, dev, pool, times=times)]
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        if outs.setdefault(flag, got) != got or got != outs["1"]:
            raise SystemExit("MJ_DEV_FIRST=%s changed the bytes" % flag)
        log("stages with MJ_DEV_FIRST=%s (ms): trellis_tables %.3f, "
            "trellis_ac %.3f, total %.1f; %s" % (
                flag, times.get("trellis_tables", 0) * 1e3,
                times.get("trellis_ac", 0) * 1e3, total * 1e3,
                json.dumps({k: round(v * 1e3, 3)
                            for k, v in times.items()})))
    del os.environ["MJ_DEV_FIRST"]


def tablegen_vs_plain(f, label):
    """The tablegen kernel on the (T, 257) counts f against its plain
    version, exactly (bits, values, ok and code lengths); raises where
    they differ. -> the largest difference (0)."""
    import torch
    from mozjpeg_tpu_torch.ops import tablegen as tg
    got = tg.gen_optimal_tables(f, sizes=True)
    bits, vals, ok = tg.gen_optimal_tables_plain(f)
    want = (bits, vals, ok, tg.derive_codes(bits, vals)[1])
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    log("tablegen kernel vs plain [%s] T=%d: exact=%s max_abs_err=%d"
        % (label, f.shape[0], exact, err))
    if not exact:
        raise SystemExit("tablegen kernel disagrees with its plain "
                         "version (%s)" % label)
    return err


def adversarial_freqs():
    """(T, 257) int32 histograms on which Annex-K implementations split:
    heavy ties, one symbol, 2-17 sparse symbols, skewed counts that force
    the length limiting, Fibonacci depth, counts of 2^26, dense random;
    then the kernel's edges (tablegen.edge_freqs: live sums at 2^23 - 1,
    2^23 and 2^23 + 1 with ties at the least count, where the kernel
    switches from 32-bit to 64-bit keys; all 257 counts equal; a sum of
    2^30 - 1, a merge reaching 2^30, a count past it)."""
    from mozjpeg_tpu_torch.ops import tablegen as tg
    rng = np.random.default_rng(7)
    cases = []
    for _ in range(8):
        cases.append(rng.integers(0, 1000, 257))
    for n in (2, 3, 5, 9, 17):
        f = np.zeros(257, np.int64)
        f[rng.choice(256, n, replace=False)] = rng.integers(1, 50, n)
        cases.append(f)
    for sl, v in ((slice(0, 100), 7), (slice(0, 256, 2), 1),
                  (slice(42, 43), 10), (slice(0, 8), 1 << 26)):
        f = np.zeros(257, np.int64)
        f[sl] = v
        cases.append(f)
    f = np.zeros(257, np.int64)
    f[:40] = [2 ** min(i, 25) for i in range(40)]
    cases.append(f)
    f = np.zeros(257, np.int64)
    a, b = 1, 1
    for i in range(30):
        f[i] = a
        a, b = b, min(a + b, 1 << 29)
    cases.append(f)
    out = np.stack(cases).astype(np.int32)
    out[:, 256] = 0
    return np.concatenate([out, tg.edge_freqs()])


SWEEP_N = (2, 17, 65, 129, 193, 257)


def sweep_freqs(n, t=24, seed=1200):
    """(t, 257) int32 tables for the step sweep, each with n - 1 of the
    256 symbols present (the pseudo-symbol is the n-th, so n - 1 merges),
    seeded counts 1-4,999."""
    rng = np.random.default_rng(seed + n)
    f = np.zeros((t, 257), np.int32)
    for i in range(t):
        f[i, rng.choice(256, n - 1, replace=False)] = rng.integers(
            1, 5000, n - 1)
    return f


def tablegen_bound(freqs):
    """(bytes, integer operations) that Annex K needs on these counts, not
    what the kernel does: the counts read once, bits, values, ok and code
    lengths written once; per table with n present symbols, n - 1 merges
    on a binary heap (two pops and a push, ceil(log2 n) compares each),
    the code sizes and their counts from the tree (2n), the length
    limiting over the 33 size bins, and the bucket sort of the values
    by size (two passes over the 257 entries)."""
    t = freqs.shape[0]
    n = ((freqs[:, :256] > 0).sum(1) + 1).double()     # + pseudo-symbol
    depth = n.log2().ceil().clamp_min(1)
    ops = float(((n - 1).clamp_min(0) * 3 * depth + 2 * n + 33
                 + 2 * 257).sum())
    return t * 257 * 4 + t * (17 + 256 + 256) * 4 + t, ops


# custom script with AC refinement scans (phase 13's device entropy)
REFINE_SCRIPT = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                 ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                 ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                 ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


def device_engines(kodak, odd, rec_k, rec_o, dev, smi, launches,
                   h=3024, w=4032, hh=6000, ww=8000):
    """Phase 13: the tablegen kernel against its plain version and its
    times, device entropy and the device scan search against the host's
    bytes (with their kernel launches), the sizes pass's peak memory, the
    host-versus-card crossover (h, w: the large photo, MCU-aligned), and
    the device search on a photo about four times as large (hh <= 2h,
    ww <= 2w, MCU-aligned; 48 MP, the batch limit, by default).
    -> the kernels-line entry of tablegen (launches: phase 4's count)."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder
    from mozjpeg_tpu_torch.codec import scanopt_dev as sd
    from mozjpeg_tpu_torch.entropy import encode as entenc
    from mozjpeg_tpu_torch.ops import tablegen as tg
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    from mozjpeg_tpu_torch.utils import attachment
    t_phase = time.perf_counter()
    cfg = mjt.EncoderConfig(quality=75)
    ctx = encoder.resolve_group(kodak[0], cfg)
    p1 = encoder._batch_p1(kodak[:8], ctx, dev)
    finals, _ = encoder._finals(p1, ctx, dev, 8, loop_ris=False)
    cand = sd.get_candidates(3, 0)
    sizes_freqs = torch.nn.functional.pad(
        sd._Pass(cand, finals, p1[0], 8).histograms().to(torch.int32),
        (0, 1))
    trellis_freqs = rec_k["tablegen"][0]

    # the kernel against its plain version, exactly
    max_err = 0
    for label, f in (
            ("phase 3 768x512 group", trellis_freqs),
            ("phase 3 1021x683 group", rec_o["tablegen"][0]),
            ("adversarial", torch.as_tensor(adversarial_freqs(),
                                            device=dev)),
            ("sizes pass of one group of 8", sizes_freqs)):
        max_err = max(max_err, tablegen_vs_plain(f, label))

    # times: the kernel held and with launch gaps, the plain version on
    # the card, the native host Annex K on the same tables, the bound
    timing = {}
    for label, f in (("trellis route, one group", trellis_freqs),
                     ("sizes pass, one group", sizes_freqs)):
        k_ms = cuda_ms(lambda: tg.gen_optimal_tables(f, sizes=True), 20)
        k_un = cuda_ms(lambda: tg.gen_optimal_tables(f, sizes=True), 20,
                       hold=False)
        p_ms = cuda_ms(lambda: tg.gen_optimal_tables_plain(f), 1,
                       hold=False)
        fh = f.cpu().numpy().astype(np.int64)
        t0 = time.perf_counter()
        for row in fh:
            entenc.gen_optimal_table(row)
        host_ms = (time.perf_counter() - t0) * 1e3
        nbytes, ops = tablegen_bound(f)
        b_ms, b_by = bound(nbytes, ops, H100_INT32_OPS)
        timing[label] = (k_ms, k_un, p_ms, b_ms, b_by, host_ms)
        log("tablegen per call [%s] T=%d: kernel %.4f ms (%.4f ms with the "
            "host's launch gaps), plain %.3f ms, native host Annex K %.3f "
            "ms, bound %.5f ms (%.3g ops, %d bytes, by %s), %.2f%% of the "
            "bound; %s" % (label, f.shape[0], k_ms, k_un, p_ms, host_ms,
                           b_ms, ops, nbytes, b_by, 100 * b_ms / k_ms, smi))

    # the step latency: T = 24 tables of n present symbols make n - 1
    # merges each; the slope of the held time over n - 1
    sweep = {}
    for n in SWEEP_N:
        f = torch.as_tensor(sweep_freqs(n), device=dev)
        max_err = max(max_err, tablegen_vs_plain(f, "sweep n=%d" % n))
        sweep[n] = cuda_ms(lambda: tg.gen_optimal_tables(f, sizes=True), 20)
    step_ms, zero_ms = np.polyfit([n - 1 for n in SWEEP_N],
                                  [sweep[n] for n in SWEEP_N], 1)
    log("tablegen step sweep (T=24, held ms by present symbols n): %s; "
        "%.4f us a merge step, %.4f ms at 0 merges; %s"
        % (", ".join("n=%d %.4f" % (n, sweep[n]) for n in SWEEP_N),
           step_ms * 1e3, zero_ms, smi))

    # device entropy: the host emission's bytes
    encoder.reset_host_routes()
    rng = np.random.default_rng(1200)
    p12 = photo(*kodak[0].shape[:2], 1200).astype(np.uint16) << 4
    p12 |= rng.integers(0, 16, p12.shape, dtype=np.uint16)
    cases = [("sequential", {"progressive": False}, None),
             ("sequential restart_in_rows=1",
              {"progressive": False, "restart_in_rows": 1}, None),
             ("simple progressive", {"optimize_scans": False}, None),
             ("custom script with AC refine", {"scan_script": REFINE_SCRIPT},
              None),
             ("12-bit default", {"precision": 12}, p12),
             ("12-bit simple progressive",
              {"precision": 12, "optimize_scans": False}, p12)]
    for name, kw, img in cases:
        for im in ([img] if img is not None else [kodak[0], odd[0]]):
            t0 = time.perf_counter()
            on = mjt.encode_many([im], mjt.EncoderConfig(
                quality=75, device_entropy=True, **kw))[0]
            t1 = time.perf_counter()
            off = mjt.encode_many([im], mjt.EncoderConfig(quality=75,
                                                          **kw))[0]
            t2 = time.perf_counter()
            log("device entropy vs host [%s %dx%d]: equal=%s (%d bytes; "
                "%.1f ms against %.1f ms)" % (name, im.shape[1], im.shape[0],
                                             on == off, len(on),
                                             (t1 - t0) * 1e3,
                                             (t2 - t1) * 1e3))
            if on != off:
                raise SystemExit("device entropy changed the bytes (%s)"
                                 % name)

    # the device scan search: the host search's bytes, and the kernels it
    # launches (each group: tablegen once for its trellis loop and once
    # for its search, trellis_ac three times)
    ngroups = -(-len(kodak) // encoder.GROUP)
    search_launches = None
    for q, sub in ((75, (2, 2)), (92, (1, 1))):
        for mode in (0, 1, 2):
            kw = dict(quality=q, subsampling=sub, dc_scan_opt_mode=mode)
            torch.cuda.synchronize()
            tg.reset_launches()
            tac.reset_launches()
            on = mjt.encode_many(kodak, mjt.EncoderConfig(
                device_scanopt=True, **kw))
            n_tg, n_tac = tg.launches, tac.trellis_ac.launches_by_kmax[10]
            off = mjt.encode_many(kodak, mjt.EncoderConfig(**kw))
            log("device scan search vs host [16x%dx%d q%d %dx%d "
                "dc_scan_opt_mode=%d]: equal=%s; launches tablegen %d, "
                "trellis_ac<10, 1023> %d (%d groups)" % (
                    kodak[0].shape[1], kodak[0].shape[0], q, sub[0], sub[1],
                    mode, on == off, n_tg, n_tac, ngroups))
            if on != off:
                raise SystemExit("the device scan search changed the bytes")
            if n_tg != 2 * ngroups or n_tac != 3 * ngroups:
                raise SystemExit("the device scan search should launch "
                                 "tablegen twice and trellis_ac 3 times a "
                                 "group")
            search_launches = search_launches or n_tg // ngroups

    # the sizes pass: peak memory (its lanes built a chunk of blocks at a
    # time), kernels and device time
    big = photo(h, w, 1212)
    ctx_big = encoder.resolve_group(big, cfg)
    p1_big = encoder._batch_p1([big], ctx_big, dev)
    finals_big, _ = encoder._finals(p1_big, ctx_big, dev, 1, loop_ris=False)
    for label, fin, geom, b in (("one group of 8", finals, p1[0], 8),
                                ("%dx%d image" % (w, h), finals_big,
                                 p1_big[0], 1)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sd.sizes_pass(cand, fin, geom, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        prof = ""
        if b > 1:
            dms, nk, pwall = profiled(
                lambda: sd.sizes_pass(cand, fin, geom, b), reps=1)
            prof = ("; %d kernels, %.3f ms device time, %.1f ms wall under "
                    "torch.profiler" % (nk, dms, pwall))
        log("device scan search sizes pass [%s]: peak %.1f MiB above its "
            "input, %.1f ms wall%s; %s" % (label, peak, wall, prof, smi))
    del p1_big, finals_big

    # the crossover (the analog of scripts/engine_tradeoff.py), which also
    # holds the engines' bytes to the host's on the large photo
    engines = (("off", {}), ("device_scanopt", {"device_scanopt": True}),
               ("device_entropy+device_scanopt",
                {"device_entropy": True, "device_scanopt": True}))
    for label, imgs in (("8x%dx%d" % kodak[0].shape[1::-1], kodak[:8]),
                        ("%dx%d" % (w, h), [big])):
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        walls = {n: [] for n, _ in engines}
        cpus = {n: [] for n, _ in engines}
        outs = {}
        for turn in range(3):
            for name, kw in (engines if turn != 1 else engines[::-1]):
                c = mjt.EncoderConfig(quality=75, **kw)
                c0, t0 = time.process_time(), time.perf_counter()
                got = mjt.encode_many(imgs, c)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
                cpus[name].append(time.process_time() - c0)
                if outs.setdefault(name, got) != got or got != outs.get(
                        "off", got):
                    raise SystemExit("the device engines changed the bytes "
                                     "(%s, %s)" % (label, name))
        log("device engines vs host [%s]: equal=True (%d bytes)"
            % (label, sum(map(len, outs["off"]))))
        for name, kw in engines:
            cx = encoder.resolve_group(imgs[0], mjt.EncoderConfig(
                quality=75, **kw))
            times = {}
            with ThreadPoolExecutor(8) as pool:
                encoder.encode_group(imgs, cx, dev, pool, times=times)
            wm = statistics.median(walls[name])
            log("crossover [%s, engines %s]: %.3f MP/s (median of 3 in "
                "turns, walls %s s), process CPU %.3f s a call, host entropy "
                "%.3f ms, device search %.3f ms, stages (ms) %s; %s" % (
                    label, name, mp / wm,
                    ", ".join("%.4f" % v for v in walls[name]),
                    statistics.median(cpus[name]),
                    times.get("host_entropy", 0) * 1e3,
                    times.get("device_search", 0) * 1e3,
                    json.dumps({k: round(v * 1e3, 3)
                                for k, v in times.items()}), smi))

    # a photo about four times as large, on which the whole-candidate
    # lanes of a sizes pass would need some 120 GB: now a chunk of blocks
    # at a time
    huge = np.ascontiguousarray(np.tile(big, (2, 2, 1))[:hh, :ww])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tg.reset_launches()
    t0 = time.perf_counter()
    on = mjt.encode_many([huge], mjt.EncoderConfig(quality=75,
                                                   device_scanopt=True))
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    n_tg = tg.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    off = mjt.encode_many([huge], mjt.EncoderConfig(quality=75))
    t_off = time.perf_counter() - t0
    peak_off = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log("device scan search vs host [%dx%d]: equal=%s (%d bytes); tablegen "
        "launches %d; the whole encode's peak %.2f GiB above its input "
        "(%.2f GiB with the host search); %.2f s against %.2f s; %s" % (
            ww, hh, on == off, len(on[0]), n_tg, peak, peak_off, t_on,
            t_off, smi))
    if on != off:
        raise SystemExit("the device scan search changed the bytes (48 MP)")
    if n_tg != 2 or peak > 40:
        raise SystemExit("the 48 MP device search should launch tablegen "
                         "twice and stay under 40 GiB")
    routes = dict(encoder.engine_host_routes)
    log("device engines' host routes over these photos: %s"
        % json.dumps(routes))
    if any(routes.values()):
        raise SystemExit("a device engine took its host route on photos")
    log("sync_latency_ms (best of 2 fresh 4 MB read-backs): %.4f"
        % attachment.sync_latency_ms())
    log("phase 13: %.1f s" % (time.perf_counter() - t_phase))
    k_ms, k_un, p_ms, b_ms, b_by, host_ms = timing["trellis route, one group"]
    s_ms, s_un, s_pms, s_bms, _, s_host = timing["sizes pass, one group"]
    return {"name": "tablegen", "route": "cuda",
            "source": "mozjpeg_tpu_torch/csrc/tablegen.cu",
            "replaces": "mozjpeg_tpu/ops/tablegen.py:30 (XLA, no pallas_call)",
            "launches": launches,
            "launches_per_device_search_group": search_launches,
            "max_abs_err": float(max_err),
            "exact": max_err == 0, "ms": k_ms, "ms_with_launch_gaps": k_un,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "host_annex_k_ms": host_ms,
            "ms_per_merge_step": float(step_ms),
            "sweep_ms": {str(n): sweep[n] for n in SWEEP_N},
            "sizes_pass_ms": s_ms, "sizes_pass_plain_ms": s_pms,
            "sizes_pass_bound_ms": s_bms, "sizes_pass_host_ms": s_host}


@contextlib.contextmanager
def environ(**kw):
    """The environment variables kw set inside, restored after."""
    keep = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def recording(rec):
    """encode_many's trellis passes and the row-sharded encoders' trellis
    record into rec (encoder._finals and trellis.trellis_all get a record
    dict: each trellis_ac launch's arguments and each tablegen launch's
    counts), and p1's launches too (p1_recording)."""
    from mozjpeg_tpu_torch.codec import encoder, trellis
    finals, trellis_all = encoder._finals, trellis.trellis_all

    def record(p1, ctx, dev_, b, times=None, _=None, *rest):
        return finals(p1, ctx, dev_, b, times, rec, *rest)

    def record_all(*args, **kw):
        kw["record"] = rec
        return trellis_all(*args, **kw)
    encoder._finals = record
    trellis.trellis_all = record_all
    try:
        with p1_recording(rec):
            yield
    finally:
        encoder._finals = finals
        trellis.trellis_all = trellis_all


# phase 14: each transfer codec's EncoderConfig fields, and the first
# pack it makes on every group (encoder.codec_routes; what follows an
# overflow depends on the data and is logged)
CODECS = [("sparse_download", dict(sparse_download=True), ("sparse",)),
          ("plane_pack", dict(plane_pack=True), ("plane_pack",)),
          ("coef_transport", dict(coef_transport=True), ("transport",)),
          ("all three", dict(sparse_download=True, plane_pack=True,
                             coef_transport=True),
           ("plane_pack", "transport"))]


def transfer_codecs(images, outs, ngroups, dev, smi, compare, h=3024,
                    w=4032, hs=512, ws=768, n12=8):
    """Phase 14: the transfer codecs on the card, each byte-equal to the
    dense route on phase 4's corpus with its launches held (every launch
    of the all-codecs run against the plain versions), the 12-bit
    transport on n12 of phase 11's photos, the overflow routes on dense
    noise, each codec's bytes moved, pack device time and kernels and
    MP/s beside the dense route; the host render and the packed decode
    route against the card's render on a 768x512 JPEG and an h x w one
    (hs x ws: the 12-bit photos' and the noise's size).
    -> the phase's launch counts for the kernels line."""
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder, pipeline_t
    from mozjpeg_tpu_torch.ops import sparsepack, tablegen as tg
    from mozjpeg_tpu_torch.ops import trellis_ac as tac, transport
    from mozjpeg_tpu_torch.utils import xfer
    t_phase = time.perf_counter()
    mp = sum(im.shape[0] * im.shape[1] for im in images) / 1e6
    launches = {"<10>": 0, "<14>": 0, "tablegen": 0}

    def run(imgs, cfg, rec=None):
        """encode_many on the card, counts from 0 -> (outputs, launches
        of <10>, <14> and tablegen, the routes, (H2D, D2H) bytes)."""
        torch.cuda.synchronize()
        tac.reset_launches()
        tg.reset_launches()
        encoder.reset_codec_routes()
        snap = xfer.snapshot()
        with recording(rec) if rec is not None else contextlib.nullcontext():
            got = mjt.encode_many(imgs, cfg)
        torch.cuda.synchronize()
        n = (tac.trellis_ac.launches_by_kmax[10],
             tac.trellis_ac.launches_by_kmax[14], tg.launches)
        for k, v in zip(launches, n):
            launches[k] += v
        return got, n, dict(encoder.codec_routes), xfer.delta(snap)

    # 1. each codec on phase 4's corpus: the dense route's bytes
    moved = {}
    _, _, _, moved["dense"] = run(images, mjt.EncoderConfig(quality=75))
    for name, kw, packs in CODECS:
        rec = {} if name == "all three" else None
        got, n, routes, moved[name] = run(
            images, mjt.EncoderConfig(quality=75, **kw), rec)
        log("transfer codec [%s]: %d images, equal to the dense route=%s, "
            "launches <10, 1023> %d, tablegen %d, routes %s, H2D %d B, "
            "D2H %d B (dense: %d B, %d B)"
            % (name, len(images), got == outs, n[0], n[2],
               json.dumps(routes), moved[name][0], moved[name][1],
               moved["dense"][0], moved["dense"][1]))
        if got != outs:
            raise SystemExit("the %s route changed the bytes" % name)
        if n != (3 * ngroups, 0, ngroups) or any(
                routes[k] != ngroups for k in packs):
            raise SystemExit("the %s route should launch trellis_ac 3 times "
                             "and tablegen once a group and pack %s once "
                             "a group" % (name, " and ".join(packs)))
        if rec is not None:
            if (len(rec["trellis_ac"]) != n[0]
                    or len(rec["tablegen"]) != n[2]):
                raise SystemExit("recorded launches differ from counted")
            for i, args in enumerate(rec["trellis_ac"]):
                compare(args, "phase 14 %s launch %d" % (name, i))
            for i, f in enumerate(rec["tablegen"]):
                tablegen_vs_plain(f, "phase 14 %s launch %d" % (name, i))
            check_p1(rec, "phase 14 %s, first group" % name, first=3)

    # 2. the 12-bit transport on phase 11's photos
    rng = np.random.default_rng(1200)
    corpus12 = []
    for i in range(n12):
        hi = photo(hs, ws, 1200 + i).astype(np.uint16) << 4
        corpus12.append(hi | rng.integers(0, 16, hi.shape, dtype=np.uint16))
    dense12 = mjt.encode_many(corpus12, mjt.EncoderConfig(quality=75,
                                                          precision=12))
    rec = {}
    got, n, routes, moved12 = run(corpus12, mjt.EncoderConfig(
        quality=75, precision=12, coef_transport=True), rec)
    log("transfer codec [12-bit coef_transport]: %d photos, equal to the "
        "dense route=%s, launches <14, 16383> %d, routes %s, D2H %d B"
        % (n12, got == dense12, n[1], json.dumps(routes), moved12[1]))
    if got != dense12 or n[1] != 3 or routes["transport"] != 1:
        raise SystemExit("the 12-bit transport route failed")
    for i, args in enumerate(rec["trellis_ac"]):
        compare(args, "phase 14 12-bit transport launch %d" % i)

    # 3. the overflow routes: dense noise past every capacity
    noise = np.random.default_rng(1401).integers(0, 256, (hs, ws, 3)) \
        .astype(np.uint8)
    want = mjt.encode_many([noise], mjt.EncoderConfig(quality=95))
    got, n, routes, _ = run([noise], mjt.EncoderConfig(
        quality=95, coef_transport=True))
    log("transfer codec overflow routes [%dx%d noise, q95]: equal=%s, "
        "packs made %s" % (ws, hs, got == want, json.dumps(routes)))
    if (got != want or routes["transport_scap32"] != 1
            or routes["sparse"] != 1):
        raise SystemExit("the noise should reach the transport's retry "
                         "and its fall to sparse")

    # 4. each codec's pack on one group: device ms and kernels, and the
    # download stage's wall time and bytes
    ctx = encoder.resolve_group(images[0], mjt.EncoderConfig(quality=75))
    p1 = encoder._batch_p1(images[:8], ctx, dev, batched=True)
    finals, _ = encoder._finals(p1, ctx, dev, 8, loop_ris=False)
    geom, *up, total = pipeline_t.pack_ycc_batch(images[:8], ctx.samp)
    up = [torch.from_numpy(a.view(np.int32)).to(dev) for a in up]
    for label, fn in (
            ("dense pack", lambda: pipeline_t.pack_all_batch(finals, 8)),
            ("sparse pack", lambda: sparsepack.pack_planes_exact(finals,
                                                                 8)),
            ("transport pack", lambda: transport.pack_batch(finals, 8)),
            ("plane-pack expand (upload)",
             lambda: pipeline_t.unpack_ycc_batch(*up, total))):
        dms, nk, wall = profiled(fn)
        held, gaps = cuda_ms(fn, 5), cuda_ms(fn, 5, hold=False)
        log("transfer codec device work per 8x768x512 group [%s]: %.4f ms "
            "of device time, %d kernels (torch.profiler), %.4f ms held and "
            "%.4f ms with the host's gaps (CUDA events), %.3f ms wall (%s)"
            % (label, dms, nk, held, gaps, wall, smi))
    for name, kw, _ in [("dense", {}, None)] + CODECS[:3:2]:
        cfg = mjt.EncoderConfig(quality=75, **kw).resolved()
        snap = xfer.snapshot()
        wall, walls = timed3(lambda: encoder._fetch_planes(
            geom, finals, 8, encoder._dispatch_download(finals, 8, cfg)))
        log("transfer codec download stage per group [%s]: median %.3f ms "
            "(%s), %d B a group (%s)"
            % (name, wall * 1e3, ", ".join("%.3f" % (v * 1e3)
                                          for v in walls),
               xfer.delta(snap)[1] // 3, smi))

    # 5. MP/s of each codec beside the dense route, 3 reps in turns
    mps = {}
    for _ in range(3):
        for name, kw, _ in [("dense", {}, None)] + CODECS:
            cfg = mjt.EncoderConfig(quality=75, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mjt.encode_many(images, cfg)
            torch.cuda.synchronize()
            mps.setdefault(name, []).append(mp / (time.perf_counter() - t0))
    for name, v in mps.items():
        log("transfer codec encode_many MP/s [%s]: median %.3f (reps %s; "
            "%s)" % (name, statistics.median(v),
                     ", ".join("%.3f" % x for x in v), smi))

    # 6. the host render and the packed route against the card's render
    big = mjt.encode(photo(h, w, 1212), mjt.EncoderConfig(quality=75))
    for label, data in (("%dx%d" % images[0].shape[1::-1], outs[0]),
                        ("%dx%d" % (w, h), big)):
        want = mjt.decode(data)
        with environ(MJ_DEPLOYMENT="remote"):
            host = mjt.decode(data)
            host_many = mjt.decode_many([data])[0]
        if not (same(host, want) and same(host_many, want)):
            raise SystemExit("the host render differs from the card's (%s)"
                             % label)
        times = {}
        for _ in range(3):
            for name, dep in (("card", "local"), ("host", "remote")):
                with environ(MJ_DEPLOYMENT=dep):
                    for call, fn in (("decode", lambda: mjt.decode(data)),
                                     ("decode_many",
                                      lambda: mjt.decode_many([data]))):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        times.setdefault((call, name), []).append(
                            time.perf_counter() - t0)
        for (call, name), v in times.items():
            log("host render [%s %s] %s: median %.3f ms (%s; equal=True; %s)"
                % (call, label, name, statistics.median(v) * 1e3,
                   ", ".join("%.3f" % (x * 1e3) for x in v), smi))
    datas = outs[:8] + [big]
    dmp = (sum(im.shape[0] * im.shape[1] for im in images[:8])
           + h * w) / 1e6
    want = {o: mjt.decode_many(datas, output=o) for o in ("rgb", "yuv")}
    decode_routes = [("card", dict(MJ_DEPLOYMENT="local")),
              ("host", dict(MJ_DEPLOYMENT="remote", MJ_HOST_ENGINE="1")),
              ("packed", dict(MJ_DEPLOYMENT="remote", MJ_HOST_ENGINE="0",
                              MJ_PLANEPACK="0")),
              ("packed + plane pack", dict(
                  MJ_DEPLOYMENT="remote", MJ_HOST_ENGINE="0",
                  MJ_PLANEPACK="1"))]
    for name, env in decode_routes:
        for o in ("rgb", "yuv"):
            with environ(**env):
                snap = xfer.snapshot()
                got = mjt.decode_many(datas, output=o)
                b = xfer.delta(snap)
            log("decode_many route [%s, %s, 8 images + %dx%d]: equal to "
                "the card's=%s, H2D %d B, D2H %d B (counted transfers)"
                % (name, o, w, h, same(got, want[o]), b[0], b[1]))
            if not same(got, want[o]):
                raise SystemExit("decode_many's %s route differs" % name)
    walls = {}
    for _ in range(3):
        for name, env in decode_routes:
            with environ(**env):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mjt.decode_many(datas)
                torch.cuda.synchronize()
                walls.setdefault(name, []).append(time.perf_counter() - t0)
    for name, env in decode_routes:
        with environ(**env):
            dms, nk, _ = profiled(lambda: mjt.decode_many(datas), reps=1)
        v = walls[name]
        log("decode_many route [%s] MP/s: median %.3f (reps %s), device "
            "%.3f ms, %d kernels a call (%s)"
            % (name, dmp / statistics.median(v),
               ", ".join("%.3f" % (dmp / x) for x in v), dms, nk, smi))
    log("phase 14: %.1f s" % (time.perf_counter() - t_phase))
    return launches


# phase 15: the row-sharded encoders and the single-device configuration
# each is byte-exact against (restart_in_rows=1 added), EncoderConfig
# fields by name
ROW_ENCODERS = [
    ("baseline", "encode_row_sharded",
     dict(profile="FASTEST", progressive=False, optimize_coding=True,
          optimize_scans=False, trellis_quant=False,
          overshoot_deringing=False)),
    ("trellis", "encode_row_sharded_trellis",
     dict(progressive=False, optimize_scans=False, trellis_quant=True,
          overshoot_deringing=True, optimize_coding=True)),
    ("progressive", "encode_row_sharded_progressive",
     dict(progressive=True, optimize_scans=False, trellis_quant=True,
          overshoot_deringing=True, optimize_coding=True)),
    ("scanopt", "encode_row_sharded_scanopt", {})]


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def sharded_run(fn, compare, label, nshards):
    """fn() under recording, launch counts from 0 -> (its bytes, wall s,
    peak GiB, launches, max error of its launches against the plain
    version). Fails unless the trellis launched once per shard and
    component (0 times where fn has no trellis) and every recorded launch
    agrees with the plain version."""
    import torch
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    rec = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tac.reset_launches()
    t0 = time.perf_counter()
    with recording(rec):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = tac.trellis_ac.launches_by_kmax[10]
    calls = rec.get("trellis_ac", [])
    if n != len(calls) or n not in (0, 3 * nshards):
        raise SystemExit("%s: %d trellis_ac launches, %d recorded, expected "
                         "0 or %d" % (label, n, len(calls), 3 * nshards))
    err = 0.0
    for i, args in enumerate(calls):
        err = max(err, compare(args, "phase 15 %s launch %d" % (label, i)))
    check_rows(rec, "phase 15 %s" % label)
    check_p1(rec, "phase 15 %s" % label)
    return out, wall, peak, n, err


def multi_device(kodak, dev, smi, compare, h=6144, w=8192):
    """Phase 15: the port's multi-device encode on one card, every entry
    of a mesh on cuda:0 -> (its launch counts by run, the max error of
    its launches against the plain version)."""
    import torch
    import torch.distributed as dist
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec.config import EncoderConfig, Profile
    from mozjpeg_tpu_torch.parallel import batch as pbatch
    from mozjpeg_tpu_torch.parallel import dryrun, multihost
    from mozjpeg_tpu_torch.parallel import rows as prows
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    nshards = 4
    mesh = pbatch.make_mesh([card] * nshards)

    # (a) the dry run
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(nshards, device=card)
    log("phase 15 dry run on %d cuda:0 entries: ok (%.1f s)"
        % (nshards, time.perf_counter() - t0))

    # (b) the one-process encoders at 768x512
    imgs = np.stack(kodak[:8])
    ref = pbatch.encode_batch(imgs, 75.0, pbatch.make_mesh([card]))
    for de in (False, True):
        t0 = time.perf_counter()
        got = pbatch.encode_batch(imgs, 75.0, mesh, device_entropy=de)
        torch.cuda.synchronize()
        log("phase 15 encode_batch 8x768x512 on %d entries, device_entropy="
            "%s: equal to one entry's=%s (%.3f s)"
            % (nshards, de, got == ref, time.perf_counter() - t0))
        if got != ref:
            raise SystemExit("encode_batch differs from the one-entry mesh")
    img = kodak[0]
    launches, err, single = {}, 0.0, {}
    for kind, name, kw in ROW_ENCODERS:
        kw = dict(kw)
        if "profile" in kw:
            kw["profile"] = Profile[kw["profile"]]
        want = mjt.encode(img, EncoderConfig(quality=75, restart_in_rows=1,
                                             **kw))
        fn = getattr(prows, name)
        got, wall, peak, n, e = sharded_run(
            lambda: fn(img, 75.0, mesh, restart_rows=1), compare,
            "768x512 " + kind, nshards)
        launches["768x512 " + kind] = n
        err = max(err, e)
        single[kind] = want
        log("phase 15 %s 768x512 on %d entries: equal to encode()=%s, %d "
            "bytes, %.3f s, peak %.2f GiB, trellis_ac launches %d"
            % (name, nshards, got == want, len(got), wall, peak, n))
        if got != want:
            raise SystemExit("%s differs from the single-device bytes"
                             % name)

    # (b) the full width: one 8192x6144 photo over the 48 MP batch limit
    big = photo(h, w, 300)
    mp = h * w / 1e6

    def sharded():
        return prows.encode_row_sharded_scanopt(big, 75.0, mesh,
                                                restart_rows=1)

    def per_image():
        return mjt.encode_many([big], EncoderConfig(quality=75,
                                                    restart_in_rows=1))[0]

    got, wall, peak, n, e = sharded_run(sharded, compare,
                                        "%dx%d scanopt" % (w, h), nshards)
    launches["%dx%d scanopt" % (w, h)] = n
    err = max(err, e)
    # then in turns: per-image, per-image, sharded
    walls = {"sharded": [wall], "per-image": []}
    peaks = {"sharded": [peak], "per-image": []}
    for name, fn in (("per-image", per_image), ("per-image", per_image),
                     ("sharded", sharded)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        peaks[name].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        if out != got:
            raise SystemExit("the sharded full-width encode differs from "
                             "the per-image route")
    for name in ("sharded", "per-image"):
        log("phase 15 %dx%d (%.1f MP) %s, %s: %s s (%s MP/s), peak %s GiB"
            % (w, h, mp, name, smi,
               " / ".join("%.3f" % v for v in walls[name]),
               " / ".join("%.3f" % (mp / v) for v in walls[name]),
               " / ".join("%.2f" % v for v in peaks[name])))
    log("phase 15 %dx%d: encode_row_sharded_scanopt on %d cuda:0 entries "
        "equal to encode_many's per-image route: True (%d bytes), "
        "trellis_ac launches %d" % (w, h, nshards, len(got), n))
    del big, got, out

    # (c) a one-rank NCCL group, then two gloo processes sharing the card
    t0 = time.perf_counter()
    multihost.init("127.0.0.1:%d" % free_port(), 1, 0,
                   devices=[card] * nshards)
    gm = multihost.global_mesh("rows", devices=[card] * nshards)
    backend = dist.get_backend()
    try:
        got = multihost.encode_row_sharded_scanopt_multihost(
            img, 75.0, restart_rows=1, mesh=gm)
    finally:
        dist.destroy_process_group()
    log("phase 15 one-rank group (%s), sums on %s: "
        "encode_row_sharded_scanopt_multihost equal=%s (%.1f s)"
        % (backend, gm.reduce_device, got == single["scanopt"],
           time.perf_counter() - t0))
    if gm.reduce_device.type != "cuda" or got != single["scanopt"]:
        raise SystemExit("the one-rank NCCL run failed")
    t0 = time.perf_counter()
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "torch_multihost_worker.py")
    modes = ("rows", "scanopt")
    with tempfile.TemporaryDirectory() as tmp:
        inpath = os.path.join(tmp, "in.npz")
        np.savez(inpath, batch=imgs[:2], image=img)
        coord = "127.0.0.1:%d" % free_port()
        procs = [subprocess.Popen(
            [sys.executable, worker, coord, "2", str(r), str(nshards),
             "cuda:0", inpath, os.path.join(tmp, "out"), *modes],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(2)]
        try:
            errs = [p.communicate(timeout=600)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, e) in enumerate(zip(procs, errs)):
            if p.returncode != 0:
                raise SystemExit("gloo rank %d failed:\n%s"
                                 % (r, e.decode()[-4000:]))
        for mode, kind in zip(modes, ("baseline", "scanopt")):
            outs = []
            for r in range(2):
                with open(os.path.join(tmp, "out.%s.%d.0.jpg" % (mode, r)),
                          "rb") as f:
                    outs.append(f.read())
            ok = outs == [single[kind]] * 2
            log("phase 15 two gloo processes on cuda:0 (%d entries each), "
                "%s: both equal to the single-device bytes=%s"
                % (nshards, mode, ok))
            if not ok:
                raise SystemExit("the two-process %s run differs" % mode)
    log("phase 15 two-process run: %.1f s" % (time.perf_counter() - t0))
    log("phase 15: %.1f s" % (time.perf_counter() - t_phase))
    return launches, err


# phase 16: the port from a copy of its package with the JAX package out of
# reach, then its tjbench and rd_collect on the card
def run_tool(main, argv, device):
    """main(argv, device=device) of a port tool, synchronised -> (its
    standard output, its standard error); fails unless it returns 0."""
    import torch
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, device=device)
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit("%s %s exited %d" % (main.__module__, argv, rc))
    return out.getvalue(), err.getvalue()


def standalone_and_tools(kodak, dev, smi, compare, h=3024, w=4032):
    """Phase 16: (1) a copy of mozjpeg_tpu_torch/ (without _build/) run by
    tests/torch_standalone_worker.py in a child whose sys.path holds the
    copy and the interpreter's own paths only, under an audit hook on
    every path under the checkout's mozjpeg_tpu/: it builds the host
    library and the three CUDA libraries from the copy and encodes
    kodak[0] on the card, byte-equal to this process, with 3 trellis_ac,
    1 tablegen and 3 trellis_dc launches; (2) the port's tjbench on an h x w
    photo at q95 4:2:0, plain and -progressive -optimize, and -tile on a
    384x256 crop at 4:4:4, every tile exact and the JPEG's size equal
    to the same call without -tile on the CPU; (3) the port's rd_collect
    over the h x w photo and phase 4's sixteen 768x512 ones at
    -q 50,75,95 -average -plot, the 768x512 rows equal to the CPU's and
    every kernel launch of its first (h x w) encode against the plain
    versions. -> (the <10, 1023> and tablegen launches of its runs, the
    largest difference of each kernel from its plain version)."""
    import importlib.util
    import torch
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.cli import rd_collect, tjbench
    from mozjpeg_tpu_torch.ops import tablegen as tg
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_16_")
    d = tmp.name

    def counts_from_0():
        torch.cuda.synchronize()
        tac.reset_launches()
        tg.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return (tac.trellis_ac.launches_by_kmax[10],
                tac.trellis_ac.launches_by_kmax[14], tg.launches)

    # 1. the port from a copy of its package
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "torch_standalone_worker",
        os.path.join(repo, "tests", "torch_standalone_worker.py"))
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    copy_dir = os.path.join(d, "copy")
    os.makedirs(copy_dir)
    rc, out, res = worker.run(repo, copy_dir, "cuda", [kodak[0]],
                              timeout=600)
    if rc != 0 or res is None:
        raise SystemExit("the standalone copy failed (exit %d):\n%s"
                         % (rc, out[-4000:]))
    want = mjt.encode(kodak[0], mjt.EncoderConfig(quality=75), device=dev)
    ok = (res["encode"] == [want] and not res["violations"]
          and res["launches"] == {"trellis_ac": 3, "tablegen": 1,
                                  "trellis_dc": 3, "p1_blocks": 3,
                                  "p1_eob_hist": 3}
          and res["p1_check"][1:] == [6, True])
    if res["p1_check"][2]:
        for kind in P1_CHECK:
            P1_CHECK[kind][0] = max(P1_CHECK[kind][0], res["p1_check"][0])
            P1_CHECK[kind][1] += 3
    log("phase 16 standalone copy (sys.path: the copy and the "
        "interpreter's own; audit hook on the checkout's JAX package): "
        "built %s from the copy in %.1f s, first encode %.1f s, encode() "
        "of a 768x512 photo %.3f s with trellis_ac %d, tablegen %d, "
        "trellis_dc %d, p1_blocks %d, p1_eob_hist %d launches; p1 kernels "
        "vs plain over %d launches: exact=%s max_abs_err=%g; audit "
        "violations %d, bytes equal to this process=%s (%.1f s)"
        % (", ".join(res["built"]), res["build_s"], res["warm_s"],
           res["encode_s"],
           res["launches"]["trellis_ac"], res["launches"]["tablegen"],
           res["launches"]["trellis_dc"], res["launches"]["p1_blocks"],
           res["launches"]["p1_eob_hist"], res["p1_check"][1],
           res["p1_check"][2], res["p1_check"][0],
           len(res["violations"]), res["encode"] == [want],
           time.perf_counter() - t0))
    if not ok:
        raise SystemExit("the standalone copy differs from the checkout's "
                         "port, reached the JAX package or missed a kernel")

    # 2. tjbench: 12 MP throughput, then tiles at 768x512
    big = photo(h, w, 1212)
    big_path = write_ppm(os.path.join(d, "big.ppm"), big)
    paths = [write_ppm(os.path.join(d, "kodak%02d.ppm" % i), im)
             for i, im in enumerate(kodak)]
    for flags in ([], ["-progressive", "-optimize"]):
        t0 = time.perf_counter()
        counts_from_0()
        res = json.loads(run_tool(tjbench.main, [
            big_path, "95", "-subsamp", "420", "-reps", "3", "-warmup", "1",
            "-json"] + flags, dev)[0])
        n = counts()
        log("phase 16 tjbench %dx%d q95 4:2:0%s on %s: compress %.3f MP/s, "
            "decompress %.3f MP/s (3 reps after 1), %d bytes; launches "
            "trellis_ac %d, tablegen %d (%.1f s)"
            % (w, h, "".join(" " + f for f in flags), smi,
               res["compress_mps"], res["decompress_mps"], res["jpeg_bytes"],
               n[0] + n[1], n[2], time.perf_counter() - t0))
        if n != (0, 0, 0):
            raise SystemExit("tjbench launched a kernel: TurboJPEG's "
                             "defaults have no trellis")
    crop_path = write_ppm(os.path.join(d, "crop.ppm"),
                          np.ascontiguousarray(kodak[0][:256, :384]))
    for sub in ("444",):
        t0 = time.perf_counter()
        argv = [crop_path, "95", "-subsamp", sub, "-reps", "1", "-warmup",
                "0", "-json"]
        counts_from_0()
        card = json.loads(run_tool(tjbench.main, argv + ["-tile"], dev)[0])
        n = counts()
        cpu = json.loads(run_tool(tjbench.main, argv, "cpu")[0])
        tiles = {k: v for k, v in card.items() if k.startswith("tile_")}
        ok = (len(tiles) == len(tjbench.tile_sizes(sub))
              and all(v["exact"] for v in tiles.values())
              and (card["jpeg_bytes"], card["ratio"])
              == (cpu["jpeg_bytes"], cpu["ratio"]) and n == (0, 0, 0))
        log("phase 16 tjbench -tile 384x256 q95 %s on %s: %s; jpeg_bytes "
            "%d (cpu %d); launches %d (%.1f s)"
            % (sub, smi, json.dumps(tiles), card["jpeg_bytes"],
               cpu["jpeg_bytes"], sum(n), time.perf_counter() - t0))
        if not ok:
            raise SystemExit("tjbench -tile: a tile is not exact, the JPEG "
                             "differs from the CPU's or a kernel launched")

    # 3. rd_collect: the 768x512 rows on the CPU, then the card's run with
    # the 12 MP photo first, its rows kept before -average folds them
    t0 = time.perf_counter()
    quals = "50,75,95"
    cpu_rows = json.loads(run_tool(rd_collect.main, paths + [
        "-q", quals, "-json"], "cpu")[0])
    cpu_s = time.perf_counter() - t0
    folded = []
    average_rows = rd_collect.average_rows

    def keep(rows):
        folded.extend(rows)
        return average_rows(rows)
    svg = os.path.join(d, "rd.svg")
    rec = {}
    t0 = time.perf_counter()
    counts_from_0()
    rd_collect.average_rows = keep
    try:
        with recording(rec):
            avg = json.loads(run_tool(rd_collect.main, [big_path] + paths + [
                "-q", quals, "-average", "-plot", svg, "-json"], dev)[0])
        n = counts()
    finally:
        rd_collect.average_rows = average_rows
    card_s = time.perf_counter() - t0
    encodes = 3 * (1 + len(paths))
    rows_k = [r for r in folded if r["image"] != big_path]
    ok = (n == (3 * encodes, 0, encodes) and rows_k == cpu_rows
          and len(avg) == 3 and os.path.getsize(svg) > 0)
    log("phase 16 rd_collect -q %s -average -plot over a %dx%d photo and "
        "%d 768x512 ones on %s: %d encodes in %.1f s (the CPU's 768x512 "
        "rows %.1f s), launches trellis_ac<10, 1023> %d, tablegen %d; the "
        "768x512 rows equal to the CPU's=%s; averages %s; %dx%d rows %s"
        % (quals, w, h, len(paths), smi, encodes, card_s, cpu_s, n[0], n[2],
           rows_k == cpu_rows, json.dumps(avg),
           w, h, json.dumps([r for r in folded if r["image"] == big_path])))
    if not ok:
        raise SystemExit("rd_collect on the card: rows differ from the "
                         "CPU's, or not 3 trellis_ac and 1 tablegen "
                         "launches an encode")
    err = max(compare(args, "phase 16 rd_collect %dx%d q50 launch %d"
                      % (w, h, i))
              for i, args in enumerate(rec["trellis_ac"][:3]))
    tg_err = tablegen_vs_plain(rec["tablegen"][0],
                               "phase 16 rd_collect %dx%d q50" % (w, h))
    check_rows(rec, "phase 16 rd_collect %dx%d q50" % (w, h), first=3)
    check_p1(rec, "phase 16 rd_collect %dx%d q50" % (w, h), first=3)
    tmp.cleanup()
    log("phase 16: %.1f s" % (time.perf_counter() - t_phase))
    return {"<10>": n[0], "tablegen": n[2]}, err, tg_err


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder, trellis
    from mozjpeg_tpu_torch.native import build as nbuild
    from mozjpeg_tpu_torch.ops import p1 as tp1
    from mozjpeg_tpu_torch.ops import tablegen as tg
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log("torch %s cuda %s on %s" % (torch.__version__, torch.version.cuda,
                                    torch.cuda.get_device_name(0)))

    # ---- 2. builds, in parallel ----
    with ThreadPoolExecutor(5) as ex:
        f_nat = ex.submit(nbuild.build_native)
        f_ker = ex.submit(tac.build)
        f_tg = ex.submit(tg.build)
        f_rows = ex.submit(trw.build)
        f_p1 = ex.submit(tp1.build)
        ker_s, ptxas = f_ker.result()
        tg_s, tg_ptxas = f_tg.result()
        rows_s, rows_ptxas = f_rows.result()
        p1_s, p1_ptxas = f_p1.result()
        log("build: native %.1f s, trellis_ac kernel %.1f s, tablegen "
            "kernel %.1f s, trellis_rows kernels %.1f s, p1 kernels %.1f s"
            % (f_nat.result(), ker_s, tg_s, rows_s, p1_s))
    for line in ptxas:
        log("trellis_ac build: " + line)
    for line in tg_ptxas:
        log("tablegen build: " + line)
    for line in rows_ptxas:
        log("trellis_rows build: " + line)
    for line in p1_ptxas:
        log("p1 build: " + line)

    # ---- 3. kernel vs plain on the card ----
    cfg = mjt.EncoderConfig(quality=75)
    kodak = [photo(512, 768, 100 + i) for i in range(16)]
    odd = [photo(683, 1021, 200 + i) for i in range(3)]
    ctx = encoder.resolve_group(kodak[0], cfg)
    rec_k, rec_o = {}, {}
    with ThreadPoolExecutor(8) as pool:
        for group, rec in ((kodak[:8], rec_k), (odd, rec_o)):
            with p1_recording(rec):
                for f in encoder.encode_group(group, ctx, dev, pool,
                                              record=rec):
                    f.result()
    recorded = rec_k["trellis_ac"]          # one 768x512 group: Y, Cb, Cr
    for rec in (rec_k, rec_o):
        if len(rec["trellis_ac"]) != 3 or len(rec["trellis_dc"]) != 3:
            raise SystemExit("expected 3 trellis_ac and 3 trellis_dc calls "
                             "per group, saw %d and %d"
                             % (len(rec["trellis_ac"]),
                                len(rec["trellis_dc"])))

    def compare(args, label):
        nb_k, ei_k = tac.trellis_ac(*args)
        nb_p, ei_p = tac.trellis_ac_plain(*args)
        torch.cuda.synchronize()
        err = max(float((nb_k - nb_p).abs().max()),
                  float((ei_k - ei_p).abs().max()))
        exact = torch.equal(nb_k, nb_p) and torch.equal(ei_k, ei_p)
        log("kernel vs plain [%s] N=%d band=(%d,%d): exact=%s max_abs_err=%g"
            % (label, args[0].shape[1], args[5], args[6], exact, err))
        if not exact:
            raise SystemExit("trellis_ac kernel disagrees with its plain "
                             "version (%s)" % label)
        return err

    max_err = 0.0
    for shape, rec in (("768x512", rec_k), ("1021x683", rec_o)):
        for name, args in zip(("Y", "Cb", "Cr"), rec["trellis_ac"]):
            max_err = max(max_err, compare(
                args, "main path %s %s" % (shape, name)))
    rng = np.random.default_rng(99)
    b_t, n_img = 2, 4096
    vals = np.array([0, 8, 16, 64, 256, 1024], np.int32)
    raw = (vals[rng.integers(0, len(vals), (64, b_t * n_img))]
           * rng.choice([-1, 1], (64, b_t * n_img))).astype(np.int32)
    qz = np.clip(rng.integers(1, 32, 64), 1, 255).astype(np.int32)
    si = rng.integers(2, 17, (b_t, 256)).astype(np.int32)
    si[:, 0] = rng.integers(2, 10, b_t)
    si[1, 0xF0] = 0
    tie = (torch.as_tensor(raw, device=dev), torch.as_tensor(qz, device=dev),
           torch.as_tensor(trellis.recip2_table()[qz], device=dev),
           trellis.rate_lut(torch.as_tensor(si, device=dev)),
           torch.full((b_t * n_img,), 2.0, device=dev))
    for band in ((1, 63), (1, 8), (9, 63)):
        max_err = max(max_err, compare(tie + band + (n_img,), "tie-stress"))
    for band in ((1, 8), (9, 63)):
        a = recorded[0]
        max_err = max(max_err, compare(a[:5] + band + a[7:], "main Y band"))
    dense = example_trellis("dense", 8, 6144, dev, 7)
    for args, label in (
            (example_trellis("zero", 2, 4096, dev, 5), "all-zero"),
            (dense, "dense"),
            (example_trellis("sparse", 3, 1001, dev, 6), "ragged B=3"),
            (example_trellis("sparse", 1, 1, dev, 8), "N=1")):
        max_err = max(max_err, compare(args, label))

    # the row-scan kernels: the groups' DC launches, then seeded DC
    # inputs (ties, 12-bit wrap, the delta weight at v = 2 with an odd
    # bh, a row past 48 KB of shared memory) and EOB strips
    check_rows(rec_k, "main path 768x512")
    check_rows(rec_o, "main path 1021x683")

    # p1's kernels: both groups' launches, then seeded planes with
    # deringing's edge cases and long flat runs (uint8 and int32 samples,
    # views into one buffer at a chroma offset and with a column stride,
    # B = 1 and 8, deringing on and off, restart intervals)
    check_p1(rec_k, "main path 768x512")
    check_p1(rec_o, "main path 1021x683")
    p1_seeded(np.asarray(ctx.qtables[1]), dev)
    for kind, shape, v, q0, nc, dw, prec, label in (
            ("tie", (3, 9, 33), 2, 1, 9, 0.5, 8, "tie-stress"),
            ("seeded", (2, 7, 40), 2, 3000, 9, 0.5, 12, "12-bit wrap"),
            ("seeded", (2, 5, 90), 1, 1, 9, 0.0, 12, "12-bit clamp"),
            ("seeded", (8, 63, 96), 2, 8, 9, 0.5, 8, "delta v=2 odd bh"),
            ("seeded", (1, 3, 2048), 2, 4, 9, 0.5, 8, "bw=2048")):
        raw, lam, si = trw.dc_example_inputs(kind, *shape, q0, prec, 7)
        rows_vs_plain("trellis_dc", (
            torch.as_tensor(raw, device=dev), torch.as_tensor(lam, device=dev),
            q0, float(trellis.recip2_table()[q0]), si, nc, v, dw,
            trellis.kmax_maxq(prec)[1]), label)
    # every candidate tied at nc 1, 2, 8 and 9, one column and two
    # walk-back segments a lane; rows past one tile of the per-row pass;
    # a 12 MP luma component
    dc_more = [("alltie", (2, 3, bw), 2, 8, nc, 0.5, 8,
                "all-tie nc=%d bw=%d" % (nc, bw))
               for nc in (1, 2, 8, 9) for bw in (1, 33)] + [
        ("tie", (1, 3, 260), 2, 1, 9, 0.5, 8, "tiles bw=260"),
        ("seeded", (1, 378, 504), 2, 8, 9, 0.0, 8, "12 MP luma")]
    for kind, shape, v, q0, nc, dw, prec, label in dc_more:
        raw, lam, si = trw.dc_example_inputs(kind, *shape, q0, prec, 11)
        rows_vs_plain("trellis_dc", (
            torch.as_tensor(raw, device=dev), torch.as_tensor(lam, device=dev),
            q0, float(trellis.recip2_table()[q0]), si, nc, v, dw,
            trellis.kmax_maxq(prec)[1]), label)
    # p1_eob_hist on runs at its tile edges and on a 12 MP plane's flags
    # (745 tiles: the combine over three blocks of 256 tiles)
    edges = torch.as_tensor(tp1.edge_flags(17).reshape(-1), device=dev)
    n12 = 378 * 504
    rng12 = np.random.default_rng(12)
    f12 = np.where(rng12.random(3 * n12) < 0.05,
                   rng12.choice([1, 3], 3 * n12), 2).astype(np.uint8)
    f12[n12:n12 + 40000] = 2
    f12 = torch.as_tensor(f12, device=dev)
    eob_rec = {"p1_eob_hist": [
        (edges, torch.zeros((6, 256), dtype=torch.int32, device=dev), 6, ri)
        for ri in (0, 1, 5, tp1.EOB_TILE - 1, tp1.EOB_TILE,
                   tp1.EOB_TILE + 1, tp1.EDGE_N - 1, tp1.EDGE_N,
                   tp1.EDGE_N + 3)] + [
        (f12, torch.zeros((3, 256), dtype=torch.int32, device=dev), 3, ri)
        for ri in (0, 504, 0x7FFF)]}
    check_p1(eob_rec, "EOB tile edges and 12 MP flags")
    # p1_blocks on the planes built to break it (ops/p1.adversarial_plane):
    # int32 samples whose FDCT wraps (the DC at -2^30; deringing off) at
    # quant values 1, 65535 and a ramp, clipped blocks with deringing, and
    # a view with a column stride at an odd offset
    ramp = np.arange(1, 65, dtype=np.int32)
    adv = {"p1_blocks": []}
    for prec in (8, 12):
        wrap = torch.as_tensor(tp1.adversarial_plane("wrap", 2, 16, 24, prec,
                                                     5), device=dev)
        for qv in (np.ones(64, np.int32), np.full(64, 65535, np.int32),
                   ramp):
            adv["p1_blocks"].append((wrap, 16, 24, qv, False, prec))
        clipped = torch.as_tensor(tp1.adversarial_plane(
            "clipped", 2, 16, 24, prec, 6), device=dev)
        adv["p1_blocks"].append((clipped, 16, 24, ramp, True, prec))
        wide = torch.as_tensor(tp1.example_plane(2, 9, 20, prec, 7, 73,
                                                 3 * 161 + 1), device=dev)
        adv["p1_blocks"].append((wide[:, 1:, 1::3], 9, 20, ramp, True, prec))
    check_p1(adv, "adversarial planes: int32 wrap, clipped, strided")
    for shape in ((8, 64, 96), (3, 4, 70), (2, 5, 1), (1, 4, 2048)):
        ei, si = trw.eob_example_inputs(shape[2], *shape)
        rows_vs_plain("trellis_eob", (torch.as_tensor(ei, device=dev),
                                      torch.as_tensor(si, device=dev),
                                      shape[1], shape[2]), "seeded")
    # rows of every cost tied, all zero, every other block all zero,
    # keep-heavy, around a warp, at 504 (12 MP luma) and past the
    # kernel's 512 register steps
    for L in (1, 31, 32, 33, 96, 504, 513, 1024):
        ei, si = trw.eob_example_inputs(L, 2, 5, L, "adversarial")
        rows_vs_plain("trellis_eob", (torch.as_tensor(ei, device=dev),
                                      torch.as_tensor(si, device=dev), 5, L),
                      "adversarial L=%d" % L)

    # the main path's lambda on the card vs the CPU and numpy, exactly
    s1, s2 = ctx.cfg.lambda_log_scale1, ctx.cfg.lambda_log_scale2
    for shape, rec in (("768x512", rec_k), ("1021x683", rec_o)):
        for ci, (nrm, lam_card) in enumerate(rec["lambda"]):
            lam_card = lam_card.cpu()
            lam_cpu = trellis.lambda_from_norm_t(nrm.cpu(), s1, s2)
            n_h = nrm.cpu().numpy()
            lam_np = ((np.float64(2.0) ** s1)
                      / (np.float64(2.0) ** s2
                         + (n_h / np.float32(63.0)).astype(np.float64))
                      ).astype(np.float32)
            ok = (torch.equal(lam_card, lam_cpu)
                  and np.array_equal(lam_card.numpy(), lam_np))
            log("lambda card vs cpu vs numpy [%s comp %d] N=%d: exact=%s"
                % (shape, ci, nrm.numel(), ok))
            if not ok:
                raise SystemExit("lambda on the card differs from the CPU's")

    # ---- 4. the slice ----
    images = kodak + odd
    mp = sum(im.shape[0] * im.shape[1] for im in images) / 1e6
    rec4 = {}
    with p1_recording(rec4):
        mjt.encode_many(images, cfg)                   # warm-up
    check_p1(rec4, "main path warm-up, 3 groups")
    torch.cuda.synchronize()
    tac.reset_launches()
    tg.reset_launches()
    trw.reset_launches()
    tp1.reset_launches()
    t0 = time.perf_counter()
    outs = mjt.encode_many(images, cfg)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = tac.trellis_ac.launches_by_kmax[10]
    tg_launches = tg.launches
    dc_launches, eob_launches = trw.trellis_dc.launches, trw.eob_dp.launches
    p1_launches = {"p1_blocks": tp1.p1_blocks.launches,
                   "p1_eob_hist": tp1.p1_eob_hist.launches}
    ngroups = 3                      # two groups of eight 768x512, one of 3
    log("main path: %d images, %.3f MP, %d groups, trellis_ac<10, 1023> "
        "launches=%d, tablegen launches=%d, trellis_dc launches=%d, "
        "trellis_eob launches=%d, p1_blocks launches=%d, p1_eob_hist "
        "launches=%d" % (len(images), mp, ngroups, launches, tg_launches,
                         dc_launches, eob_launches,
                         p1_launches["p1_blocks"],
                         p1_launches["p1_eob_hist"]))
    if launches <= 0 or dc_launches <= 0 or min(p1_launches.values()) <= 0:
        raise SystemExit("the main path never launched the trellis or p1 "
                         "kernels")
    if (launches != 3 * ngroups or tg_launches != ngroups
            or dc_launches != 3 * ngroups or eob_launches
            or set(p1_launches.values()) != {3 * ngroups}):
        raise SystemExit("the main path should launch trellis_ac, "
                         "trellis_dc and both p1 kernels 3 times and "
                         "tablegen once a group (the device-tablegen route), "
                         "and no EOB-run DP")
    for o in outs:
        if not (o[:2] == b"\xff\xd8" and o[-2:] == b"\xff\xd9"):
            raise SystemExit("output without SOI/EOI")
    checked = (0, 7, len(kodak), len(images) - 1)
    cpus = mjt.encode_many([images[i] for i in checked], cfg, device="cpu")
    for i, cpu in zip(checked, cpus):
        same = cpu == outs[i]
        log("card vs cpu bytes [image %d, %dx%d]: equal=%s (%d bytes)"
            % (i, images[i].shape[1], images[i].shape[0], same, len(cpu)))
        if not same:
            raise SystemExit("card output differs from the CPU path")
    for _ in range(2):
        t0 = time.perf_counter()
        again = mjt.encode_many(images, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if again != outs:
            raise SystemExit("outputs differ between runs")
    mps = [mp / w for w in walls]
    log("encode_many MP/s: median %.3f (reps %s)"
        % (statistics.median(mps), ", ".join("%.3f" % v for v in mps)))

    # ---- 5. decode ----
    decode_phase(images, outs, dev)

    # ---- 6. stage times of one group, kernel and plain times ----
    times = {}
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        encoder.encode_group(kodak[:8], ctx, dev, pool, times=times)
        group_s = time.perf_counter() - t0
    log("stages of one 8x768x512 group (ms): %s; total %.1f"
        % (json.dumps({k: round(v * 1e3, 3) for k, v in times.items()}),
           group_s * 1e3))
    dev_first_routes(kodak[:8], ctx, dev)

    def group_kernel():
        for a in recorded:
            tac.trellis_ac(*a)

    def group_plain():
        for a in recorded:
            tac.trellis_ac_plain(*a)

    def y_launch():
        tac.trellis_ac(*recorded[0])

    def dense_launch():
        tac.trellis_ac(*dense)

    k_ms, y_ms, d_ms = (cuda_ms(f, r) for f, r in (
        (group_kernel, 10), (y_launch, 10), (dense_launch, 5)))
    k_un, y_un, d_un = (cuda_ms(f, r, hold=False) for f, r in (
        (group_kernel, 10), (y_launch, 10), (dense_launch, 5)))
    p_ms = cuda_ms(group_plain, 2)
    nbytes, ops = 0, 0.0
    for a in recorded:
        b_, o_ = trellis_bound(a)
        nbytes += b_
        ops += o_
    bound_ms, bound_by = bound(nbytes, ops)
    log("trellis_ac per group (3 launches): kernel %.4f ms (%.4f ms with "
        "the host's launch gaps), plain %.3f ms, bound %.4f ms (%.3g ops, "
        "%d bytes), %.1f%% of the bound; Y launch (N=%d) %.4f ms (%.4f ms)"
        % (k_ms, k_un, p_ms, bound_ms, ops, nbytes, 100 * bound_ms / k_ms,
           recorded[0][0].shape[1], y_ms, y_un))
    dp_ms = cuda_ms(lambda: tac.trellis_ac_plain(*dense), 1)
    d_bytes, d_ops = trellis_bound(dense)
    d_bound, d_by = bound(d_bytes, d_ops)
    log("trellis_ac dense input (N=%d, one launch): kernel %.4f ms (%.4f ms "
        "with the host's launch gaps), plain %.3f ms, bound %.4f ms (%.3g "
        "ops, %d bytes, by %s), %.1f%% of the bound"
        % (dense[0].shape[1], d_ms, d_un, dp_ms, d_bound, d_ops, d_bytes,
           d_by, 100 * d_bound / d_ms))
    k_dc = dc_stage(rec_k["trellis_dc"], kodak[:8], ctx, dev, smi,
                    dc_launches)
    k_dc.update(dc_clock_split(rec_k["trellis_dc"][0],
                               "one 8x768x512 group, luma", smi))
    k_p1 = p1_stage(rec_k, kodak[:8], ctx, dev, smi, p1_launches)
    floor = empty_ms(dev, smi)
    for entry in [k_dc] + k_p1:
        entry["empty_kernel_ms"], entry["empty_kernel_ms_with_gaps"] = floor

    # ---- 7. the config matrix ----
    kept = {}
    err7, k_eob = config_matrix(kodak, odd, dev, statistics.median(mps),
                                compare, kept, smi)
    max_err = max(max_err, err7)

    # ---- 8. the per-image routes ----
    max_err = max(max_err, per_image_routes(kodak, odd, dev,
                                            statistics.median(mps), compare,
                                            kept))

    # ---- 9. decode of the port's own streams ----
    kept["default"] = ([images[0], images[len(kodak)]],
                       [outs[0], outs[len(kodak)]])
    decode_port_streams(kodak, outs[:8], kept, dev)

    # ---- 10. the djpeg surface ----
    djpeg_surface(kept, outs[:8], dev)

    # ---- 11. precision ----
    k12 = precision_phase(kodak[:8], outs[:8], dev, compare)

    # ---- 12. the remaining surfaces ----
    l12, err12, dc12, eob12, p1b12, dp12 = remaining_surfaces(
        kodak, dev, smi, compare)
    k_dc.update(dc12)
    k_p1[0].update(p1b12)
    k_p1[1].update(eob12)
    k_eob.update(dp12)
    max_err = max(max_err, err12)

    # ---- 13. the device engines ----
    k_tg = device_engines(kodak, odd, rec_k, rec_o, dev, smi, tg_launches)

    # ---- 14. the host render and the transfer codecs ----
    l14 = transfer_codecs(images, outs, ngroups, dev, smi, compare)
    k12["launches_phase14"] = l14["<14>"]
    k_tg["launches_phase14"] = l14["tablegen"]

    # ---- 15. multi-device encode ----
    l15, err15 = multi_device(kodak, dev, smi, compare)
    max_err = max(max_err, err15)

    # ---- 16. the standalone copy, tjbench and rd_collect ----
    l16, err16, tg_err16 = standalone_and_tools(kodak, dev, smi, compare)
    max_err = max(max_err, err16)
    k_tg["launches_phase16"] = l16["tablegen"]
    k_tg["max_abs_err"] = max(k_tg["max_abs_err"], float(tg_err16))
    k_tg["exact"] = k_tg["max_abs_err"] == 0

    # ---- 17. result lines ----
    for entry in (k_dc, k_eob):
        entry["max_abs_err"], entry["launches_checked"] = \
            ROWS_CHECK[entry["name"]]
        entry["exact"] = entry["max_abs_err"] == 0
    for entry in k_p1:
        entry["max_abs_err"], entry["launches_checked"] = \
            P1_CHECK[entry["name"]]
        entry["exact"] = entry["max_abs_err"] == 0
    log("chip_smoke: %.1f s" % (time.perf_counter() - t_start))
    log(json.dumps({"kernels": [{
        "name": "trellis_ac<10, 1023>", "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "exact": max_err == 0.0,
        "ms": k_ms, "kernel_ms": k_ms, "ms_with_launch_gaps": k_un,
        "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "dense_ms": d_ms, "dense_plain_ms": dp_ms,
        "dense_bound_ms": d_bound, "launches_phase12": l12,
        "launches_phase14": l14["<10>"], "launches_phase15": l15,
        "launches_phase16": l16["<10>"]},
        k12, k_tg, k_dc, k_eob] + k_p1}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
