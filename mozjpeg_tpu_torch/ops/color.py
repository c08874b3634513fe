"""Exact fixed-point colour conversions, batched over whole planes.

Port of mozjpeg_tpu/ops/color.py (rgb_to_ycc, rgb_to_gray, cmyk_to_ycck,
ycc_to_rgb, ycck_to_cmyk):
the table semantics of mozjpeg jccolor.c (encode) and jdcolor.c
build_ycc_rgb_table (decode) inlined as int32 multiplies (SCALEBITS=16).
The tables are linear in the sample value, so the inlined products give
the tables' integers. Decode clamps with the plain range-limit table of
ycc_rgb_convert (not the post-IDCT wraparound one).

Every function takes the data precision: 8-bit samples are uint8, wider
ones (12 bits) int32, since torch's uint16 supports few operations; the
callers make uint16 arrays on the host.
"""
from __future__ import annotations

import torch

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


# encode side (jccolor.c:227-241)
FIX_0_29900 = _fix(0.29900)
FIX_0_58700 = _fix(0.58700)
FIX_0_11400 = _fix(0.11400)
FIX_0_16874 = _fix(0.16874)
FIX_0_33126 = _fix(0.33126)
FIX_0_50000 = _fix(0.50000)
FIX_0_41869 = _fix(0.41869)
FIX_0_08131 = _fix(0.08131)

# jdcolor.c build_ycc_rgb_table: Cr=>R and Cb=>B round with ONE_HALF;
# the G terms are summed unrounded, with ONE_HALF folded into the sum
FIX_1_40200 = _fix(1.40200)
FIX_1_77200 = _fix(1.77200)
FIX_0_71414 = _fix(0.71414)
FIX_0_34414 = _fix(0.34414)


def _samples(x: torch.Tensor, precision: int) -> torch.Tensor:
    """int32 samples -> the sample type of the precision (uint8 at 8
    bits, int32 above)."""
    return x.to(torch.uint8) if precision <= 8 else x.to(torch.int32)


def _ycc(r, g, b, precision: int = 8):
    """int32 planes -> (Y, Cb, Cr) int32; Cb/Cr round with ONE_HALF-1
    plus the centre offset 1 << (precision-1) (rgb_ycc_start's
    0.5-epsilon)."""
    ctr_off = (1 << (precision - 1)) << SCALEBITS
    y = (FIX_0_29900 * r + FIX_0_58700 * g + FIX_0_11400 * b
         + ONE_HALF) >> SCALEBITS
    cb = ((-FIX_0_16874) * r + (-FIX_0_33126) * g + FIX_0_50000 * b
          + ctr_off + ONE_HALF - 1) >> SCALEBITS
    cr = (FIX_0_50000 * r + (-FIX_0_41869) * g + (-FIX_0_08131) * b
          + ctr_off + ONE_HALF - 1) >> SCALEBITS
    return y, cb, cr


def rgb_to_ycc(rgb: torch.Tensor, precision: int = 8) -> torch.Tensor:
    """(..., >=3) RGB samples -> (..., 3) YCbCr samples of the
    precision."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    return _samples(torch.stack(_ycc(r, g, b, precision), dim=-1),
                    precision)


def rgb_to_gray(rgb: torch.Tensor, precision: int = 8) -> torch.Tensor:
    """(..., 3) RGB samples -> (...) luma samples of the precision, the
    fixed-point Y of jdcolor.c rgb_gray_convert (Y has no centre
    offset)."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    return _samples(_ycc(r, g, b, precision)[0], precision)


def cmyk_to_ycck(cmyk: torch.Tensor, precision: int = 8) -> torch.Tensor:
    """(..., 4) CMYK -> (..., 4) YCCK samples of the precision
    (jccolor.c:396-437 cmyk_ycck_convert): CMY inverts to RGB against
    MAXJSAMPLE and takes the YCC transform; K passes through."""
    maxv = (1 << precision) - 1
    r, g, b = (maxv - cmyk[..., i].to(torch.int32) for i in range(3))
    k = cmyk[..., 3].to(torch.int32)
    return _samples(torch.stack(_ycc(r, g, b, precision) + (k,), dim=-1),
                    precision)


def ycc_to_rgb(ycc: torch.Tensor, precision: int = 8) -> torch.Tensor:
    """(..., 3) YCbCr -> (..., 3) RGB, bit-exact vs jdcolor.c; the cast
    to uint8 comes after the clamp."""
    ctr = 1 << (precision - 1)
    maxv = (1 << precision) - 1
    y = ycc[..., 0].to(torch.int32)
    cb = ycc[..., 1].to(torch.int32) - ctr
    cr = ycc[..., 2].to(torch.int32) - ctr

    r = y + ((FIX_1_40200 * cr + ONE_HALF) >> SCALEBITS)
    b = y + ((FIX_1_77200 * cb + ONE_HALF) >> SCALEBITS)
    g = y + (((-FIX_0_34414) * cb + (-FIX_0_71414) * cr + ONE_HALF)
             >> SCALEBITS)
    return _samples(torch.clamp(torch.stack([r, g, b], dim=-1), 0, maxv),
                    precision)


def ycck_to_cmyk(ycck: torch.Tensor, precision: int = 8) -> torch.Tensor:
    """(..., 4) YCCK -> (..., 4) CMYK samples of the precision (jdcolor.c
    ycck_cmyk_convert): YCC -> RGB, clamped, inverted back to CMY against
    MAXJSAMPLE; K passes through."""
    maxv = (1 << precision) - 1
    cmy = maxv - ycc_to_rgb(ycck[..., :3], precision).to(torch.int32)
    return _samples(torch.cat([cmy, ycck[..., 3:].to(torch.int32)], dim=-1),
                    precision)
