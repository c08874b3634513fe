"""cjpeg-compatible CLI (the flag surface of mozjpeg cjpeg.c:371-712).

Port of mozjpeg_tpu/cli/cjpeg.py, the same switches, outputs, messages
and exit codes; the encode runs on the GPU (main's device argument;
"cpu" for the kernels' plain versions).

Usage: python -m mozjpeg_tpu_torch.cli.cjpeg [switches] [inputfile]
"""
from __future__ import annotations

import argparse
import sys

from ..codec.config import (DCTMethod, EncoderConfig, Profile,
                            quality_default_subsampling)
from ..codec.encoder import _device
from ..utils import ppm


def build_parser():
    p = argparse.ArgumentParser(prog="cjpeg", add_help=True,
                                description="mozjpeg encoder on the GPU")
    p.add_argument("-quality", type=str, default=None)
    p.add_argument("-precision", type=int, default=8,
                   help="data precision: 8, 12 (lossy) or 16 (lossless)")
    p.add_argument("-lossless", type=str, default=None,
                   metavar="psv[,Pt]", help="lossless mode (predictor)")
    p.add_argument("-grayscale", "-greyscale", action="store_true",
                   dest="grayscale")
    p.add_argument("-rgb", action="store_true",
                   help="create RGB JPEG (no color conversion)")
    p.add_argument("-baseline", action="store_true")
    p.add_argument("-optimize", "-optimise", action="store_true",
                   dest="optimize", default=None)
    p.add_argument("-progressive", action="store_true", default=None)
    p.add_argument("-fastcrush", action="store_true")
    p.add_argument("-revert", action="store_true")
    p.add_argument("-baseline_seq", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("-notrellis", action="store_true")
    p.add_argument("-notrellis-dc", action="store_true", dest="notrellis_dc")
    p.add_argument("-trellis-dc", action="store_false", dest="notrellis_dc",
                   help="enable DC trellis optimization (default)")
    p.add_argument("-trellis-dc-ver-weight", type=float, default=0.0,
                   dest="trellis_dc_ver_weight")
    p.add_argument("-noovershoot", action="store_true")
    p.add_argument("-tune-psnr", action="store_true", dest="tune_psnr")
    p.add_argument("-tune-ssim", action="store_true", dest="tune_ssim")
    p.add_argument("-tune-ms-ssim", action="store_true", dest="tune_ms_ssim")
    p.add_argument("-tune-hvs-psnr", action="store_true",
                   dest="tune_hvs_psnr")
    p.add_argument("-quant-table", type=int, default=None,
                   dest="quant_table")
    p.add_argument("-qtables", type=str, default=None,
                   help="file with 1..4 quant tables of 64 values")
    p.add_argument("-qslots", type=str, default=None,
                   help="N[,N,...] quant table slot per component")
    p.add_argument("-scans", type=str, default=None,
                   help="scan script file")
    p.add_argument("-sample", type=str, default=None)
    p.add_argument("-icc", type=str, default=None,
                   help="embed ICC profile from file")
    p.add_argument("-smooth", type=int, default=0)
    p.add_argument("-restart", type=str, default=None)
    p.add_argument("-arithmetic", action="store_true")
    p.add_argument("-dc-scan-opt", type=int, default=0, dest="dc_scan_opt")
    p.add_argument("-lambda1", type=float, default=14.75)
    p.add_argument("-lambda2", type=float, default=16.5)
    p.add_argument("-dct", default="int", choices=["int", "fast", "float"])
    p.add_argument("-targa", action="store_true",
                   help="input is Targa (no magic number; cjpeg.c:90)")
    p.add_argument("-nojfif", action="store_true",
                   help="do not write JFIF APP0 (cjpeg.c:709-710)")
    p.add_argument("-quant-baseline", action="store_true",
                   dest="quant_baseline",
                   help="force 8-bit quantization entries without "
                        "disabling multiple scans (cjpeg.c:589-591)")
    p.add_argument("-memdst", action="store_true",
                   help="compress to memory; print size, write nothing")
    p.add_argument("-strict", action="store_true",
                   help="treat all warnings as fatal")
    p.add_argument("-maxmemory", type=str, default=None)   # accepted, no-op
    p.add_argument("-report", action="store_true")
    p.add_argument("-verbose", "-debug", action="store_true", dest="verbose")
    p.add_argument("-version", action="store_true")
    p.add_argument("-outfile", type=str, default=None)
    p.add_argument("input", nargs="?", default=None)
    return p


def read_input(data: bytes, is_targa: bool):
    """Sniff the input format by first byte like cjpeg select_file_type
    (cjpeg.c:86-126): B->BMP, G->GIF, P->PPM/PGM, 0x89->PNG; Targa needs
    -targa.

    -> (img, gray, density, icc): RGB (H, W, 3) or grayscale (H, W)
    uint8, whether the source declares itself grayscale (GIF gray
    colormap or Targa subtype 3 set in_color_space GRAYSCALE), BMP
    density, and any embedded ICC profile (PNG iCCP, rdpng.c:146-165)."""
    if is_targa:
        from ..utils import targa
        img, gray = targa.read_targa(data)
        return img, gray, None, None
    if not data:
        raise SystemExit("cjpeg: empty input file")
    c = data[0]
    if c == 0x42:
        from ..utils import bmp
        img, density = bmp.read_bmp(data)
        return img, False, density, None
    if c == 0x47:
        from ..utils import gif
        img, gray = gif.read_gif(data)
        return img, gray, None, None
    if c == 0x89:
        from ..utils import png
        img, gray, icc, _srgb = png.read_png(data)
        return img, gray, None, icc
    if c == 0x50:
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=".ppm") as f:
            f.write(data)
            f.flush()
            img = ppm.read(f.name)
        return img, img.ndim == 2, None, None
    raise SystemExit("cjpeg: unrecognized input file format")


def config_from_args(a) -> EncoderConfig:
    from . import rdswitch
    profile = Profile.FASTEST if a.revert else Profile.MAX_COMPRESSION
    quality = rdswitch.parse_quality(a.quality or "75")
    # the heuristic keys off the LAST rating parsed (rdswitch.c:562-570)
    q_last = quality[-1] if isinstance(quality, list) else quality
    subsampling = quality_default_subsampling(q_last)
    if a.sample:
        try:
            factors = rdswitch.parse_sample(a.sample)
        except ValueError as e:
            import sys
            print(f"cjpeg: {e}", file=sys.stderr)
            raise SystemExit(1)
        # rdswitch.c set_sample_factors: components beyond those given
        # default to 1x1; non-1x1 chroma factors are not representable
        # by this encoder's subsampling model
        if any(f != (1, 1) for f in factors[1:]):
            import sys
            print("cjpeg: per-component sampling factors other than "
                  "1x1 chroma are not supported", file=sys.stderr)
            raise SystemExit(1)
        subsampling = factors[0]
    # declared grayscale SOF factors (rdswitch.c:610-642 writes comp 0 even
    # for gray): explicit -sample, else the q>=80 heuristic; below 80 the
    # jpeg_set_colorspace 1x1 default stands untouched
    if a.sample:
        gray_sample = subsampling
    elif q_last >= 80:
        gray_sample = (1, 1) if q_last >= 90 else (2, 1)
    else:
        gray_sample = None
    restart_interval = 0
    restart_in_rows = 0
    if a.restart:
        if a.restart.lower().endswith("b"):
            restart_interval = int(a.restart[:-1])
        else:
            restart_in_rows = int(a.restart)

    # tuning flags (cjpeg.c:678-705): set lambda scales + quant table
    quant_idx = a.quant_table
    l1, l2 = a.lambda1, a.lambda2
    use_lambda_tbl = True
    if a.tune_psnr:
        quant_idx = 1 if quant_idx is None else quant_idx
        l1, l2 = 9.0, 0.0
        use_lambda_tbl = False
    elif a.tune_ssim:
        quant_idx = 1 if quant_idx is None else quant_idx
        l1, l2 = 11.5, 12.75
        use_lambda_tbl = False
    elif a.tune_ms_ssim:
        quant_idx = 3 if quant_idx is None else quant_idx
        l1, l2 = 12.0, 13.0
        use_lambda_tbl = False
    elif a.tune_hvs_psnr:
        quant_idx = 3 if quant_idx is None else quant_idx
        l1, l2 = 14.75, 16.5
        use_lambda_tbl = True

    if a.quality is None and quant_idx is None:
        # cjpeg quirk: without -quality (or -quant-table/-tune-*) the
        # tables stay as jpeg_set_defaults installed them -- Annex K
        # (index 0), because quant_tbl_master_idx is still 0 when
        # set_defaults calls jpeg_set_quality(75) (jcparam.c:411,505-510);
        # the mozjpeg default index 3 only applies once cjpeg runs
        # set_quality_ratings -> jpeg_default_qtables (cjpeg.c:721-724)
        quant_idx = 0

    def _read_text(path, what):
        try:
            with open(path) as f:
                return f.read()
        except OSError as e:
            import sys
            print("cjpeg: can't open %s file %s: %s"
                  % (what, path, e.strerror), file=sys.stderr)
            raise SystemExit(1)

    base_qt = (rdswitch.read_quant_tables(_read_text(a.qtables, "qtables"))
               if a.qtables else None)
    qslots = rdswitch.parse_int_list(a.qslots) if a.qslots else None
    scan_script = (rdswitch.read_scan_script(_read_text(a.scans, "scans"))
                   if a.scans else None)
    return EncoderConfig(
        quality=quality,
        profile=profile,
        subsampling=subsampling,
        gray_sample=gray_sample,
        grayscale=a.grayscale,
        progressive=(False if a.baseline else a.progressive),
        optimize_coding=(True if a.optimize else
                         (False if a.revert else None)),
        optimize_scans=False if (a.fastcrush or a.revert) else None,
        trellis_quant=False if (a.notrellis or a.revert) else None,
        trellis_quant_dc=not a.notrellis_dc,
        trellis_delta_dc_weight=a.trellis_dc_ver_weight,
        icc=_read_icc(a.icc),
        overshoot_deringing=False if (a.noovershoot or a.revert) else None,
        arithmetic=a.arithmetic,
        restart_interval=restart_interval,
        restart_in_rows=restart_in_rows,
        dc_scan_opt_mode=a.dc_scan_opt,
        quant_tbl_idx=quant_idx,
        force_baseline=a.baseline or a.quant_baseline,
        write_jfif=not a.nojfif,
        lambda_log_scale1=l1,
        lambda_log_scale2=l2,
        use_lambda_weight_tbl=use_lambda_tbl,
        smoothing_factor=a.smooth,
        precision=a.precision,
        colorspace="rgb" if a.rgb else None,
        dct_method={"int": DCTMethod.ISLOW, "fast": DCTMethod.IFAST,
                    "float": DCTMethod.FLOAT}[a.dct],
        base_quant_tables=base_qt,
        qslots=qslots,
        scan_script=scan_script,
    )


def _read_icc(path):
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        import sys
        print(f"cjpeg: can't open ICC profile file {path}: {e.strerror}",
              file=sys.stderr)
        raise SystemExit(1)


def main(argv=None, device=None):
    """Run cjpeg with `argv` (sys.argv[1:] by default) on `device`: None
    or "cuda" (the default, the GPU; raises RuntimeError without one) or
    "cpu". Returns the exit code."""
    a = build_parser().parse_args(argv)
    if a.version or a.verbose:
        from .. import __version__
        print("mozjpeg_tpu_torch version %s" % __version__, file=sys.stderr)
        if a.version:
            return 0
    dev = _device(device)
    from ..codec.encoder import encode
    if a.precision == 16 and not a.lossless:
        sys.stderr.write("16-bit requires -lossless\n")
        return 1
    data = (open(a.input, "rb").read() if a.input
            else sys.stdin.buffer.read())
    img, src_gray, density, src_icc = read_input(data, a.targa)
    if a.lossless:
        from ..codec.lossless import encode_lossless
        parts = a.lossless.split(",")
        psv = int(parts[0])
        pt = int(parts[1]) if len(parts) > 1 else 0
        ri = rr = 0
        if a.restart:
            if a.restart.lower().endswith("b"):
                ri = int(a.restart[:-1])
            else:
                rr = int(a.restart)
        out = encode_lossless(img, predictor=psv, point_transform=pt,
                              precision=a.precision, restart_interval=ri,
                              restart_in_rows=rr)
    else:
        import dataclasses
        cfg = config_from_args(a)
        if src_icc and not a.icc:
            # PNG iCCP profile carries over as APP2 (rdpng.c:146-165);
            # an explicit -icc flag takes precedence (cjpeg.c:473-478)
            cfg = dataclasses.replace(cfg, icc=src_icc)
        if src_gray and img.ndim == 2:
            # GIF gray colormap / Targa subtype 3 / PGM input set
            # in_color_space GRAYSCALE -> grayscale JPEG by default
            cfg = dataclasses.replace(cfg, grayscale=True)
        if density is not None:
            cfg = dataclasses.replace(cfg, density=density)
        # -report: per-pass progress like cdjpeg.c:29-59 progress_monitor;
        # -verbose: SCAN trace lines like jcmaster.c:747-754
        progress_fn = None
        if a.report:
            def progress_fn(done, total, desc):
                sys.stderr.write("\rPass %d/%d: 100%% " % (done, total))
                sys.stderr.flush()
        trace_fn = None
        if a.verbose:
            def trace_fn(msg):
                sys.stderr.write(msg + "\n")
        out = encode(img, cfg, progress=progress_fn, trace=trace_fn,
                     device=dev)
        if a.report:
            sys.stderr.write("\n")
    if a.memdst:
        # cjpeg.c:1035-1039: memory destination reports size, writes nothing
        print("Compressed size:  %d bytes" % len(out), file=sys.stderr)
        return 0
    if a.outfile:
        with open(a.outfile, "wb") as f:
            f.write(out)
    else:
        sys.stdout.buffer.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
