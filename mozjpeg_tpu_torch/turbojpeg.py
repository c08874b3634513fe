"""TurboJPEG-style API — the tj3* surface of libjpeg-turbo's turbojpeg.h
re-expressed for Python/numpy (handles become TJ objects; buffers become
arrays; errors raise TJError).

Port of mozjpeg_tpu/turbojpeg.py, the same results. A TJ runs on a
device, TJ(init_type, device=None): None or "cuda" (the GPU; raises
RuntimeError without one) or "cpu". compress, decompress and
compress_from_yuv run the port's encoder and decoder there; the colour
conversions and resampling of the YUV functions run there as PyTorch
ops (ops/color.py, ops/sample.py); transform is host-only (transcode),
as are the 4:1:1 and 4:4:1 averages, in numpy in both packages.

Parity map (reference turbojpeg.h):
  tj3Init/tj3Destroy            -> TJ() / context manager
  tj3Set/tj3Get                 -> TJ.set / TJ.get (TJPARAM_*)
  tj3Compress8/12/16            -> TJ.compress (dtype selects precision)
  tj3Decompress8/12/16          -> TJ.decompress
  tj3DecompressHeader           -> TJ.decompress_header
  tj3SetScalingFactor           -> TJ.set_scaling_factor
  tj3SetCroppingRegion          -> TJ.set_cropping_region
  tj3Transform                  -> TJ.transform (TJXOP_*, TJXOPT_*)
  tj3EncodeYUV8/DecodeYUV8      -> TJ.encode_yuv / TJ.decode_yuv
  tj3CompressFromYUV8           -> TJ.compress_from_yuv
  tj3DecompressToYUV8           -> TJ.decompress_to_yuv
  tj3JPEGBufSize/tj3YUVBufSize  -> jpeg_buf_size / yuv_buf_size
  tj3LoadImage*/tj3SaveImage*   -> load_image / save_image (PPM/PGM)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .codec.encoder import _device

# ---------------------------------------------------------------------------
# Enums (values match turbojpeg.h)
# ---------------------------------------------------------------------------

# chrominance subsampling options (TJSAMP enum)
TJSAMP_444, TJSAMP_422, TJSAMP_420, TJSAMP_GRAY, TJSAMP_440, TJSAMP_411, \
    TJSAMP_441, TJSAMP_UNKNOWN = 0, 1, 2, 3, 4, 5, 6, -1

_SAMP_FACTORS = {
    TJSAMP_444: (1, 1), TJSAMP_422: (2, 1), TJSAMP_420: (2, 2),
    TJSAMP_GRAY: (1, 1), TJSAMP_440: (1, 2), TJSAMP_411: (4, 1),
    TJSAMP_441: (1, 4),
}

# pixel formats (TJPF enum): (nchannels, (r, g, b) byte offsets)
TJPF_RGB, TJPF_BGR, TJPF_RGBX, TJPF_BGRX, TJPF_XBGR, TJPF_XRGB, TJPF_GRAY, \
    TJPF_RGBA, TJPF_BGRA, TJPF_ABGR, TJPF_ARGB, TJPF_CMYK = range(12)

_PF_INFO = {
    TJPF_RGB: (3, (0, 1, 2)), TJPF_BGR: (3, (2, 1, 0)),
    TJPF_RGBX: (4, (0, 1, 2)), TJPF_BGRX: (4, (2, 1, 0)),
    TJPF_XBGR: (4, (3, 2, 1)), TJPF_XRGB: (4, (1, 2, 3)),
    TJPF_GRAY: (1, (0, 0, 0)),
    TJPF_RGBA: (4, (0, 1, 2)), TJPF_BGRA: (4, (2, 1, 0)),
    TJPF_ABGR: (4, (3, 2, 1)), TJPF_ARGB: (4, (1, 2, 3)),
    TJPF_CMYK: (4, (0, 1, 2)),
}

# colorspaces (TJCS enum)
TJCS_RGB, TJCS_YCbCr, TJCS_GRAY, TJCS_CMYK, TJCS_YCCK = range(5)

# parameters (TJPARAM enum, turbojpeg.h:520-913)
(TJPARAM_STOPONWARNING, TJPARAM_BOTTOMUP, TJPARAM_NOREALLOC, TJPARAM_QUALITY,
 TJPARAM_SUBSAMP, TJPARAM_JPEGWIDTH, TJPARAM_JPEGHEIGHT, TJPARAM_PRECISION,
 TJPARAM_COLORSPACE, TJPARAM_FASTUPSAMPLE, TJPARAM_FASTDCT, TJPARAM_OPTIMIZE,
 TJPARAM_PROGRESSIVE, TJPARAM_SCANLIMIT, TJPARAM_ARITHMETIC, TJPARAM_LOSSLESS,
 TJPARAM_LOSSLESSPSV, TJPARAM_LOSSLESSPT, TJPARAM_RESTARTBLOCKS,
 TJPARAM_RESTARTROWS, TJPARAM_XDENSITY, TJPARAM_YDENSITY,
 TJPARAM_DENSITYUNITS, TJPARAM_MAXMEMORY, TJPARAM_MAXPIXELS) = range(25)

# transform operations (TJXOP enum)
(TJXOP_NONE, TJXOP_HFLIP, TJXOP_VFLIP, TJXOP_TRANSPOSE, TJXOP_TRANSVERSE,
 TJXOP_ROT90, TJXOP_ROT180, TJXOP_ROT270) = range(8)

_XOP_NAME = {
    TJXOP_NONE: "none", TJXOP_HFLIP: "flip_h", TJXOP_VFLIP: "flip_v",
    TJXOP_TRANSPOSE: "transpose", TJXOP_TRANSVERSE: "transverse",
    TJXOP_ROT90: "rot90", TJXOP_ROT180: "rot180", TJXOP_ROT270: "rot270",
}

# transform options (TJXOPT flags)
TJXOPT_PERFECT, TJXOPT_TRIM, TJXOPT_CROP, TJXOPT_GRAY, TJXOPT_NOOUTPUT, \
    TJXOPT_PROGRESSIVE, TJXOPT_COPYNONE, TJXOPT_ARITHMETIC, \
    TJXOPT_OPTIMIZE = (1, 2, 4, 8, 16, 32, 64, 128, 256)

TJINIT_COMPRESS, TJINIT_DECOMPRESS, TJINIT_TRANSFORM = 0, 1, 2


class TJError(RuntimeError):
    pass


def tjscaled(dim: int, num: int, den: int) -> int:
    """TJSCALED macro: ceil(dim * num / den)."""
    return (dim * num + den - 1) // den


def jpeg_buf_size(width: int, height: int, subsamp: int) -> int:
    """tj3JPEGBufSize (worst case)."""
    mcuw, mcuh = 8 * _SAMP_FACTORS.get(subsamp, (1, 1))[0], \
        8 * _SAMP_FACTORS.get(subsamp, (1, 1))[1]
    w = -(-width // mcuw) * mcuw
    h = -(-height // mcuh) * mcuh
    return max(w * h * 6 + 2048, 2048)


def yuv_plane_dims(comp: int, width: int, height: int,
                   subsamp: int) -> Tuple[int, int]:
    """tj3YUVPlaneWidth/Height: the luma plane pads to the sampling
    grid; chroma divides the padded luma dims (turbojpeg.c:1051-1075)."""
    h, v = _SAMP_FACTORS[subsamp]
    pw = -(-width // h) * h
    ph = -(-height // v) * v
    if comp == 0 or subsamp == TJSAMP_GRAY:
        return pw, ph
    return pw // h, ph // v


def yuv_buf_size(width: int, align: int, height: int, subsamp: int) -> int:
    total = 0
    ncomp = 1 if subsamp == TJSAMP_GRAY else 3
    for c in range(ncomp):
        w, h = yuv_plane_dims(c, width, height, subsamp)
        stride = -(-w // align) * align
        total += stride * h
    return total


def scaling_factors() -> List[Tuple[int, int]]:
    """tj3GetScalingFactors: all M/8 factors, M = 1..16 (like the
    reference's 16-entry list)."""
    return [(m, 8) for m in range(1, 17)]


class TJ:
    """A tjhandle: parameter store + compress/decompress/transform entry
    points. Usable as a context manager (tj3Destroy is a no-op here)."""

    def __init__(self, init_type: int = TJINIT_COMPRESS, device=None):
        self._dev = _device(device)
        self._params = {
            TJPARAM_QUALITY: 75, TJPARAM_SUBSAMP: TJSAMP_420,
            TJPARAM_PRECISION: 8, TJPARAM_COLORSPACE: TJCS_YCbCr,
            TJPARAM_OPTIMIZE: 0, TJPARAM_PROGRESSIVE: 0,
            TJPARAM_ARITHMETIC: 0, TJPARAM_LOSSLESS: 0,
            TJPARAM_LOSSLESSPSV: 1, TJPARAM_LOSSLESSPT: 0,
            TJPARAM_RESTARTBLOCKS: 0, TJPARAM_RESTARTROWS: 0,
            TJPARAM_STOPONWARNING: 0, TJPARAM_BOTTOMUP: 0,
            TJPARAM_NOREALLOC: 0, TJPARAM_FASTUPSAMPLE: 0,
            TJPARAM_FASTDCT: 0, TJPARAM_SCANLIMIT: 0,
            TJPARAM_JPEGWIDTH: 0, TJPARAM_JPEGHEIGHT: 0,
            TJPARAM_XDENSITY: 1, TJPARAM_YDENSITY: 1,
            TJPARAM_DENSITYUNITS: 0, TJPARAM_MAXMEMORY: 0,
            TJPARAM_MAXPIXELS: 0,
        }
        self._scaling = (1, 1)
        self._crop = None
        self._last_jpeg = None      # (bytes, CoefImage) of transform's source

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    # -- tj3Set / tj3Get ---------------------------------------------------
    def set(self, param: int, value: int):
        if param not in self._params:
            raise TJError("invalid parameter %r" % (param,))
        self._params[param] = int(value)

    def get(self, param: int) -> int:
        if param not in self._params:
            raise TJError("invalid parameter %r" % (param,))
        return self._params[param]

    # -- helpers -----------------------------------------------------------
    def _up(self, a: np.ndarray) -> torch.Tensor:
        """Samples onto the TJ's device (deeper than 8 bits as int32)."""
        a = np.array(a, np.uint8 if a.dtype == np.uint8 else np.int32)
        return torch.from_numpy(a).to(self._dev)

    def _gray(self, rgb: np.ndarray) -> np.ndarray:
        """The luma of (H, W, 3) samples as uint8, as the JAX package's
        rgb_to_gray gives it."""
        from .ops import color
        return color.rgb_to_gray(self._up(rgb)).cpu().numpy()

    def _encoder_config(self, gray: bool, cmyk: bool):
        from .codec.config import EncoderConfig, Profile
        p = self._params
        progressive = bool(p[TJPARAM_PROGRESSIVE])
        from .codec.config import DCTMethod
        return EncoderConfig(
            quality=p[TJPARAM_QUALITY],
            precision=p[TJPARAM_PRECISION],
            profile=Profile.FASTEST,
            dct_method=(DCTMethod.IFAST if p[TJPARAM_FASTDCT]
                        else DCTMethod.ISLOW),
            progressive=progressive,
            optimize_coding=bool(p[TJPARAM_OPTIMIZE]) or progressive,
            optimize_scans=False,
            trellis_quant=False,
            overshoot_deringing=False,
            arithmetic=bool(p[TJPARAM_ARITHMETIC]),
            grayscale=gray,
            colorspace="cmyk" if cmyk else None,
            subsampling=_SAMP_FACTORS[p[TJPARAM_SUBSAMP]],
            restart_interval=p[TJPARAM_RESTARTBLOCKS],
            restart_in_rows=p[TJPARAM_RESTARTROWS],
            force_baseline=p[TJPARAM_PRECISION] == 8,
        )

    @staticmethod
    def _to_rgb(src: np.ndarray, pf: int) -> np.ndarray:
        nch, (r, g, b) = _PF_INFO[pf]
        if src.ndim == 2:
            src = src[:, :, None]
        if src.shape[2] != nch:
            raise TJError("buffer has %d channels, pixel format needs %d"
                          % (src.shape[2], nch))
        if pf == TJPF_GRAY:
            return src[:, :, 0]
        if pf == TJPF_CMYK:
            return src
        return np.ascontiguousarray(src[:, :, [r, g, b]])

    def _from_rgb(self, rgb: np.ndarray, pf: int,
                  precision: int = None) -> np.ndarray:
        nch, (r, g, b) = _PF_INFO[pf]
        cmyk_src = rgb.ndim == 3 and rgb.shape[2] == 4
        if pf == TJPF_GRAY:
            if cmyk_src:
                raise ValueError("unsupported color conversion "
                                 "(CMYK/YCCK to grayscale)")
            if rgb.ndim == 3:
                return self._gray(rgb)
            return rgb
        if pf == TJPF_CMYK:
            if not cmyk_src:
                # tj3Decompress: JCS_CMYK output only from CMYK/YCCK
                raise ValueError("unsupported color conversion "
                                 "(non-CMYK source to TJPF_CMYK)")
            return rgb
        if cmyk_src:
            raise ValueError("unsupported color conversion "
                             "(CMYK/YCCK source needs TJPF_CMYK)")
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        out = np.zeros(rgb.shape[:2] + (nch,), rgb.dtype)
        out[:, :, r] = rgb[:, :, 0]
        out[:, :, g] = rgb[:, :, 1]
        out[:, :, b] = rgb[:, :, 2]
        if nch == 4:
            # padding/alpha byte = MAXJSAMPLE for the data precision
            bits = precision if precision else (
                8 if rgb.dtype == np.uint8 else 16)
            used = {r, g, b}
            pad = [i for i in range(4) if i not in used][0]
            out[:, :, pad] = (1 << bits) - 1
        return out

    # -- tj3Compress8/12/16 --------------------------------------------------
    def compress(self, src: np.ndarray,
                 pixel_format: int = TJPF_RGB) -> bytes:
        """tj3Compress8/12/16: dtype uint8 -> 8-bit, uint16 -> the set
        TJPARAM_PRECISION (12 lossy / 12..16 lossless)."""
        p = self._params
        src = np.asarray(src)
        if p[TJPARAM_BOTTOMUP]:
            src = src[::-1]
        if p[TJPARAM_LOSSLESS]:
            from .codec.lossless import encode_lossless
            img = self._to_rgb(src, pixel_format)
            return encode_lossless(img, predictor=p[TJPARAM_LOSSLESSPSV],
                                   point_transform=p[TJPARAM_LOSSLESSPT],
                                   precision=p[TJPARAM_PRECISION])
        from .codec.encoder import encode
        gray = (pixel_format == TJPF_GRAY
                or p[TJPARAM_SUBSAMP] == TJSAMP_GRAY)
        cmyk = pixel_format == TJPF_CMYK
        img = self._to_rgb(src, pixel_format)
        if gray and img.ndim == 3:
            img = self._gray(img)
        return encode(img, self._encoder_config(gray, cmyk),
                      device=self._dev)

    # -- tj3DecompressHeader -------------------------------------------------
    def decompress_header(self, jpeg: bytes) -> dict:
        from .codec import marker
        jp = marker.parse(jpeg)
        self._params[TJPARAM_JPEGWIDTH] = jp.width
        self._params[TJPARAM_JPEGHEIGHT] = jp.height
        self._params[TJPARAM_PRECISION] = jp.precision
        self._params[TJPARAM_PROGRESSIVE] = int(jp.progressive)
        self._params[TJPARAM_ARITHMETIC] = int(jp.arithmetic)
        self._params[TJPARAM_LOSSLESS] = int(jp.lossless)
        n = len(jp.components)
        if n == 1:
            samp = TJSAMP_GRAY
            cs = TJCS_GRAY
        else:
            c0 = jp.components[0]
            samp = {(1, 1): TJSAMP_444, (2, 1): TJSAMP_422,
                    (2, 2): TJSAMP_420, (1, 2): TJSAMP_440,
                    (4, 1): TJSAMP_411, (1, 4): TJSAMP_441} \
                .get((c0.h, c0.v), TJSAMP_UNKNOWN)
            if any(c.h != 1 or c.v != 1 for c in jp.components[1:]):
                samp = TJSAMP_UNKNOWN      # getSubsamp: chroma must be 1x1
            from .codec.decoder import _jpeg_colorspace
            cs = {"ycbcr": TJCS_YCbCr, "rgb": TJCS_RGB, "cmyk": TJCS_CMYK,
                  "ycck": TJCS_YCCK,
                  "grayscale": TJCS_GRAY}[_jpeg_colorspace(jp)]
        self._params[TJPARAM_SUBSAMP] = samp
        self._params[TJPARAM_COLORSPACE] = cs
        return {"width": jp.width, "height": jp.height,
                "subsamp": samp, "colorspace": cs,
                "precision": jp.precision, "progressive": jp.progressive,
                "lossless": jp.lossless}

    # -- tj3SetScalingFactor / tj3SetCroppingRegion --------------------------
    def set_scaling_factor(self, num: int, den: int):
        # normalize to M/8 and validate like tj3SetScalingFactor
        if den <= 0 or num <= 0 or (num * 8) % den != 0 \
                or not 1 <= num * 8 // den <= 16:
            raise TJError("unsupported scaling factor %d/%d" % (num, den))
        self._scaling = (num, den)

    def set_cropping_region(self, x: int, y: int, w: int, h: int):
        self._crop = (x, y, w, h)

    # -- tj3Decompress8/12/16 ------------------------------------------------
    def decompress(self, jpeg: bytes,
                   pixel_format: int = TJPF_RGB) -> np.ndarray:
        from .codec.decoder import decode, decode_scaled
        num, den = self._scaling
        if (num, den) != (1, 1):
            img = decode_scaled(jpeg, num, den, device=self._dev)
        else:
            img = decode(jpeg, device=self._dev)
        if self._crop:
            x, y, w, h = self._crop
            img = img[y:y + h, x:x + w]
        if self._params[TJPARAM_BOTTOMUP]:
            img = img[::-1]
        return self._from_rgb(np.asarray(img), pixel_format,
                              self._params[TJPARAM_PRECISION])

    # -- tj3Transform --------------------------------------------------------
    def transform(self, jpeg: bytes, op: int = TJXOP_NONE,
                  options: int = 0,
                  crop: Optional[Tuple[int, int, int, int]] = None
                  ) -> bytes:
        from .codec import transcode
        from .codec.config import EncoderConfig, Profile
        cfg = EncoderConfig(
            profile=Profile.FASTEST,
            progressive=bool(options & TJXOPT_PROGRESSIVE),
            optimize_coding=bool(options & (TJXOPT_OPTIMIZE
                                            | TJXOPT_PROGRESSIVE)),
            arithmetic=bool(options & TJXOPT_ARITHMETIC),
            optimize_scans=False, trellis_quant=False,
            overshoot_deringing=False)
        name = _XOP_NAME[op]
        # the last source's coefficients are kept, as tj3Transform reads
        # its source once for all of a call's transforms (tjbench's tiles
        # crop one JPEG many times); the transcode ops copy, never write
        if self._last_jpeg is None or self._last_jpeg[0] != jpeg:
            self._last_jpeg = (bytes(jpeg), transcode.read_coefficients(jpeg))
        img = self._last_jpeg[1]
        if name != "none":
            img = transcode.TRANSFORMS[name](img)
        if options & TJXOPT_GRAY:
            img = transcode.to_grayscale(img)
        if crop is not None or (options & TJXOPT_CROP and self._crop):
            x, y, w, h = crop if crop is not None else self._crop
            img = transcode.crop(img, x, y, w, h)
        if options & TJXOPT_NOOUTPUT:
            return b""
        return transcode.write_coefficients(img, cfg)

    # -- YUV (planar YCbCr) --------------------------------------------------
    def encode_yuv(self, src: np.ndarray, pixel_format: int = TJPF_RGB,
                   align: int = 1) -> bytes:
        """tj3EncodeYUV8: color convert + downsample, no entropy coding."""
        planes = self._yuv_planes(src, pixel_format)
        out = bytearray()
        for pl in planes:
            h, w = pl.shape
            stride = -(-w // align) * align
            row = np.zeros((h, stride), np.uint8)
            row[:, :w] = pl
            out += row.tobytes()
        return bytes(out)

    def _yuv_planes(self, src, pixel_format):
        from .ops import color, sample
        p = self._params
        img = self._to_rgb(np.asarray(src), pixel_format)
        hs, vs = _SAMP_FACTORS[p[TJPARAM_SUBSAMP]]
        if p[TJPARAM_SUBSAMP] == TJSAMP_GRAY or img.ndim == 2:
            if img.ndim == 3:
                img = self._gray(img)
            return [img]
        ycc = color.rgb_to_ycc(self._up(img)).cpu().numpy()
        h, w = img.shape[:2]
        pw0, ph0 = yuv_plane_dims(0, w, h, p[TJPARAM_SUBSAMP])
        planes = [np.pad(ycc[:, :, 0], ((0, ph0 - h), (0, pw0 - w)),
                         mode="edge")]
        for c in (1, 2):
            pl = ycc[:, :, c]
            # pad to sampling multiple with edge replication, then the
            # reference's biased-average downsample
            ph = -(-h // vs) * vs
            pw = -(-w // hs) * hs
            pl = np.pad(pl, ((0, ph - h), (0, pw - w)), mode="edge")
            if hs == 4:
                # 4:1 ratios use plain-average int_downsample with bias
                # numpix/2 (jcsample.c:185-215), not chained h2v1 passes
                a = np.asarray(pl).reshape(ph, pw // 4, 4).astype(np.int32)
                j = ((a.sum(2) + 2) >> 2).astype(np.uint8)
            elif vs == 4:
                a = np.asarray(pl).reshape(ph // 4, 4, pw).astype(np.int32)
                j = ((a.sum(1) + 2) >> 2).astype(np.uint8)
            else:
                t = self._up(pl)
                if hs == 2 and vs == 2:
                    t = sample.downsample_h2v2(t)
                elif hs == 2:
                    t = sample.downsample_h2v1(t)
                elif vs == 2:
                    t = sample.downsample_h1v2(t)
                j = t.cpu().numpy()
            cw, ch = yuv_plane_dims(c, w, h, p[TJPARAM_SUBSAMP])
            planes.append(j[:ch, :cw])
        return planes

    def decode_yuv(self, yuv: bytes, width: int, height: int,
                   pixel_format: int = TJPF_RGB,
                   align: int = 1) -> np.ndarray:
        """tj3DecodeYUV8: planar YCbCr -> packed pixels."""
        from .ops import color, sample
        p = self._params
        subsamp = p[TJPARAM_SUBSAMP]
        ncomp = 1 if subsamp == TJSAMP_GRAY else 3
        planes = []
        off = 0
        buf = np.frombuffer(yuv, np.uint8)
        for c in range(ncomp):
            w, h = yuv_plane_dims(c, width, height, subsamp)
            stride = -(-w // align) * align
            planes.append(buf[off:off + stride * h]
                          .reshape(h, stride)[:, :w])
            off += stride * h
        if ncomp == 1:
            return self._from_rgb(planes[0], pixel_format)
        y, cb, cr = planes
        hs, vs = _SAMP_FACTORS[subsamp]
        up = []
        for pl in (cb, cr):
            t = self._up(pl)
            if hs != 1 or vs != 1:
                # tjDecodeYUVPlanes forces do_fancy_upsampling = FALSE
                # (turbojpeg.c:2477): plain replication
                t = sample.upsample_replicate(t, hs, vs)
            up.append(t[:height, :width])
        ycc = torch.stack([self._up(y[:height, :width]), up[0], up[1]], -1)
        rgb = color.ycc_to_rgb(ycc).cpu().numpy()
        return self._from_rgb(rgb, pixel_format)

    def compress_from_yuv(self, yuv: bytes, width: int, height: int,
                          align: int = 1) -> bytes:
        """tj3CompressFromYUV8 (jpeg_write_raw_data): encode the supplied
        planes directly -- no color conversion or resampling."""
        from .codec.encoder import encode_raw_yuv
        p = self._params
        subsamp = p[TJPARAM_SUBSAMP]
        ncomp = 1 if subsamp == TJSAMP_GRAY else 3
        hs, vs = _SAMP_FACTORS[subsamp]
        samp = ([(1, 1)] if ncomp == 1
                else [(hs, vs), (1, 1), (1, 1)])
        planes = []
        off = 0
        buf = np.frombuffer(yuv, np.uint8)
        for c in range(ncomp):
            w, h = yuv_plane_dims(c, width, height, subsamp)
            stride = -(-w // align) * align
            planes.append(buf[off:off + stride * h]
                          .reshape(h, stride)[:, :w])
            off += stride * h
        gray = ncomp == 1
        cfg = self._encoder_config(gray, False)
        return encode_raw_yuv(planes, width, height, samp, cfg,
                              device=self._dev)

    def decompress_to_yuv(self, jpeg: bytes, align: int = 1) -> bytes:
        """tj3DecompressToYUV8 (jpeg_read_raw_data): component planes at
        tjPlaneWidth/Height dims -- the sampling-grid padding carries the
        decoded block-edge samples."""
        from .codec.decoder import decode_raw_planes
        planes, _, _, _ = decode_raw_planes(jpeg, device=self._dev)
        out = bytearray()
        for pl in planes:
            ph, pw = pl.shape
            stride = -(-pw // align) * align
            row = np.zeros((ph, stride), np.uint8)
            row[:, :pw] = pl
            out += row.tobytes()
        return bytes(out)

    # -- tj3LoadImage / tj3SaveImage ----------------------------------------
    def load_image(self, path: str, pixel_format: int = TJPF_RGB
                   ) -> np.ndarray:
        from .utils import ppm
        return self._from_rgb(ppm.read(path), pixel_format)

    def save_image(self, path: str, img: np.ndarray,
                   pixel_format: int = TJPF_RGB):
        from .utils import ppm
        ppm.write(path, self._to_rgb(np.asarray(img), pixel_format))
