#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # about two to four minutes

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. the card's name and power limit (nvidia-smi);
  2. build the native host library and the CUDA kernel from the checkout,
     in parallel, with their build times, and the report of ptxas from
     the build that made the kernel (registers, spills, shared memory);
  3. the AC trellis kernel against its plain PyTorch version on the card,
     exactly: on the inputs that one 768x512 group and the 1021x683 group
     give it, on a seeded tie-stress input and on bands (1, 8) and
     (9, 63), on an all-zero input, a fully dense one, ragged tiles with an
     odd N (B = 3, n_img = 1,001) and N = 1; the card's lambda of both
     groups against the CPU's and numpy's, exactly;
  4. the slice: encode_many of sixteen 768x512 and three 1021x683 seeded
     photo-like images on the card, warm-up first; every output starts
     with SOI and ends with EOI, and the first and last image of each
     shape are byte-equal to the port's device="cpu" path;
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
     group (synchronised instrumented pass), the kernel's time per group
     beside its plain version's and its bound, and the same on the dense
     input; each kernel time both with the card's queue held (device time
     alone) and without (the host's launch gaps counted too);
  7. the config matrix: for each configuration family of the batched
     encode surface (grayscale from 2-D planes and from RGB, RGB, CMYK
     and YCCK from seeded 4-channel images, device prep, smoothing, the
     ifast and float DCTs, restarts, sequential, standard tables,
     FASTEST, the simple script, the trellis options, quant tables and
     markers) one 768x512 and one 1021x683 corpus image on the card, with
     SOI/EOI and the same bytes twice, and the card's bytes equal to the
     CPU path's on a 256x192 and a 131x97 crop; the trellis kernel
     against its plain version, exactly with `ei`, on the launches of the
     grayscale, CMYK, use_scans_in_trellis and trellis_eob_opt groups;
     encode_many median MP/s over 3 reps of the 19-image corpus for nine
     families beside the default's, with the stage times of one
     8x768x512 group for the three slowest; the device time and kernel
     count of the EOB-run DP, the device prep and the float DCT per group
     (torch.profiler);
  8. the per-image routes: serial encode() of a 768x512 and the 1021x683
     image on the card against encode(..., device="cpu") (the host
     engine), byte-equal, with the median of 5 warm calls each way; the
     families the batched route does not carry (the arithmetic trellis,
     on one full-size image, sequential with restarts too, trellis_q_opt
     and qslots) and arithmetic coding without the trellis, checked as
     in phase 7, with the kernel exactly against its plain version on the
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
 11. the script's time, the kernels line, then {"ok": true, "device":
     ...} as the last line.
Launch counts are set to 0 just before each timed run of a path (phase
4's main path, each timed family of phases 7 and 8, the serial calls of
phase 8) and read just after it; the kernels line carries phase 4's. It
needs no network and imports no JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_F32_OPS = 67e12       # FP32 peak outside the tensor cores (data sheet)
H100_BYTES = 3.35e12       # HBM3 bytes/s (data sheet)
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


def example_trellis(kind, b, n_img, dev, seed):
    """trellis_ac arguments on `dev` from the shared seeded generator,
    band (1, 63)."""
    import torch
    from mozjpeg_tpu_torch.codec import trellis
    return tuple(torch.as_tensor(a, device=dev) for a in
                 trellis.ac_example_inputs(kind, b, n_img, seed)) \
        + (1, 63, n_img)


def bound(nbytes, ops):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the f32 operations over the peak."""
    t_b, t_o = nbytes / H100_BYTES, ops / H100_F32_OPS
    return max(t_b, t_o) * 1e3, ("operations" if t_o >= t_b else "bytes")


def trellis_bound(args):
    """(bytes, f32 operations) the AC trellis needs on these inputs: each
    input read once and output written once; per block, for every in-band
    i with qval_i != 0, each valid predecessor j < i and each of the nc_i
    bit lengths costs 3 ops (two adds, one compare), each (i, j) pair 2
    (the tail) and each (i, k) pair 2 (the distortion products)."""
    import torch
    from mozjpeg_tpu_torch.ops.symbols import nbits
    raw, qtbl, ltbl, luts, lam, ss, se, _ = args
    n = raw.shape[1]
    nbytes = (raw.numel() * 4 + lam.numel() * 4 + luts.numel() * 4
              + 64 * 8 + n * 64 * 4 + n * 8 * 4)
    q8 = (qtbl << 3)[:, None]
    qval = torch.clamp_max((raw.abs() + (q8 >> 1)) // q8, 1023)
    pos = torch.arange(64, device=raw.device)[:, None]
    in_band = (pos >= ss) & (pos <= se)
    jvalid = ((qval != 0) & in_band) | (pos == ss - 1)
    nj = torch.cumsum(jvalid.to(torch.int64), 0) - jvalid.to(torch.int64)
    live = (qval != 0) & in_band
    nc = nbits(qval).to(torch.int64)
    ops = torch.where(live, 3 * nj * nc + 2 * nj + 2 * nc, 0).sum()
    return nbytes, float(ops)


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
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
           if e.device_type == torch.autograd.DeviceType.CUDA]
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
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    corpus = kodak + odd
    mp = sum(im.shape[0] * im.shape[1] for im in corpus) / 1e6
    max_err = 0.0
    rates, recs = {}, {}
    for name, ch, kw in families:
        cfg = family_config(kw)
        big = family_images([kodak[0]] if name in one_image
                            else [kodak[0], odd[0]], ch, 300)
        outs = mjt.encode_many(big, cfg)
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
            with ThreadPoolExecutor(8) as pool:
                for f in encoder.encode_group(
                        family_images(kodak[:8], ch, 300), ctx, dev, pool,
                        record=rec):
                    f.result()
            recs[name] = (ctx, rec)
            for i, args in enumerate(rec["trellis_ac"]):
                max_err = max(max_err, compare(
                    args, "%s group launch %d" % (name, i)))
        if name in timed:
            # warm: this family's kernels and shapes just ran above
            imgs = family_images(corpus, ch, 400)
            torch.cuda.synchronize()
            tac.trellis_ac.launches = 0
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                mjt.encode_many(imgs, cfg)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = tac.trellis_ac.launches
            if cfg.resolved().trellis_quant and launches <= 0:
                raise SystemExit("%s never launched the trellis kernel"
                                 % name)
            rates[name] = [mp / w for w in walls]
            log("config matrix MP/s [%s]: median %.3f (reps %s), "
                "trellis_ac launches=%d; default %.3f"
                % (name, statistics.median(rates[name]),
                   ", ".join("%.3f" % v for v in rates[name]), launches,
                   default_mps))
    return rates, recs, max_err


def config_matrix(kodak, odd, dev, default_mps, compare, kept):
    """Phase 7; returns the largest kernel-vs-plain error it saw, and
    keeps each family's full-size images and JPEGs in `kept`."""
    import torch
    from mozjpeg_tpu_torch.codec import encoder, pipeline_t, trellis
    from mozjpeg_tpu_torch.ops import dct, dering, layout
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
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

    # the EOB-run DP of one group (Y, Cb, Cr) on the kernel's ei strips of
    # the recorded launches (the EOBn code lengths of the standard tables:
    # the DP's work does not depend on them)
    from mozjpeg_tpu_torch.codec.pipeline import geometry
    ctx, rec = recs["trellis_eob_opt"]
    h, w = kodak[0].shape[:2]
    comps = geometry(w, h, ctx.samp)[2]
    eob_in = []
    for args, g, slot in zip(rec["trellis_ac"], comps, (0, 1, 1)):
        _, ei = tac.trellis_ac(*args)
        si = trellis.trellis_tables_from_hist(None, slot, False)[0][::16]
        eob_in.append((ei, g, torch.as_tensor(
            np.repeat(si[None].astype(np.float32), 8 * g.bh, 0),
            device=dev)))

    def eob_group():
        for ei, g, si in eob_in:
            trellis.eob_block_dp(
                ei[0].reshape(-1, g.bw), ei[1].reshape(-1, g.bw),
                ei[2].to(torch.int64).reshape(-1, g.bw), si)

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

    for label, fn, reps in (
            ("EOB-run DP (Y, Cb, Cr)", eob_group, 1),
            ("device prep (RGB -> YCbCr 4:2:0)",
             lambda: pipeline_t.prep_planes(group_t, geom, "ycbcr"), 3),
            ("float DCT of the luma (dering, DCT, quantize, rescale)",
             float_dct, 3)):
        dev_ms, nk, wall_ms = profiled(fn, reps)
        log("config matrix per 8x768x512 group [%s]: %.4f ms of device "
            "kernels (torch.profiler, %d kernels), %.3f ms synchronised "
            "wall under the profiler" % (label, dev_ms, nk, wall_ms))
    log("config matrix: %.1f s" % (time.perf_counter() - t_phase))
    return max_err


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
        card = mjt.encode(img, cfg)
        ok = card == cpu and card[:2] == b"\xff\xd8" and card[-2:] == \
            b"\xff\xd9"
        ms = {}
        for way, dv in (("card", None), ("cpu host engine", "cpu")):
            walls = []
            tac.trellis_ac.launches = 0
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
    tac.trellis_ac.launches = 0

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
    tac.trellis_ac.launches = 0

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


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder, trellis
    from mozjpeg_tpu_torch.native import build as nbuild
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
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
    with ThreadPoolExecutor(2) as ex:
        f_nat = ex.submit(nbuild.build_native)
        f_ker = ex.submit(tac.build)
        ker_s, ptxas = f_ker.result()
        log("build: native %.1f s, trellis_ac kernel %.1f s"
            % (f_nat.result(), ker_s))
    for line in ptxas:
        log("trellis_ac build: " + line)

    # ---- 3. kernel vs plain on the card ----
    cfg = mjt.EncoderConfig(quality=75)
    kodak = [photo(512, 768, 100 + i) for i in range(16)]
    odd = [photo(683, 1021, 200 + i) for i in range(3)]
    ctx = encoder.resolve_group(kodak[0], cfg)
    rec_k, rec_o = {}, {}
    with ThreadPoolExecutor(8) as pool:
        for group, rec in ((kodak[:8], rec_k), (odd, rec_o)):
            for f in encoder.encode_group(group, ctx, dev, pool,
                                          record=rec):
                f.result()
    recorded = rec_k["trellis_ac"]          # one 768x512 group: Y, Cb, Cr
    for rec in (rec_k, rec_o):
        if len(rec["trellis_ac"]) != 3:
            raise SystemExit("expected 3 trellis_ac calls per group, saw %d"
                             % len(rec["trellis_ac"]))

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
    mjt.encode_many(images, cfg)                       # warm-up
    torch.cuda.synchronize()
    tac.trellis_ac.launches = 0
    t0 = time.perf_counter()
    outs = mjt.encode_many(images, cfg)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = tac.trellis_ac.launches
    log("main path: %d images, %.3f MP, trellis_ac launches=%d"
        % (len(images), mp, launches))
    if launches <= 0:
        raise SystemExit("the main path never launched the trellis kernel")
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

    # ---- 7. the config matrix ----
    kept = {}
    max_err = max(max_err, config_matrix(kodak, odd, dev, statistics.median(
        mps), compare, kept))

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

    # ---- 11. result lines ----
    log("chip_smoke: %.1f s" % (time.perf_counter() - t_start))
    log(json.dumps({"kernels": [{
        "name": "trellis_ac", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "exact": max_err == 0.0,
        "ms": k_ms, "kernel_ms": k_ms, "ms_with_launch_gaps": k_un,
        "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "dense_ms": d_ms, "dense_plain_ms": dp_ms,
        "dense_bound_ms": d_bound}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
