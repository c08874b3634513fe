"""Exact fixed-point YCbCr -> RGB for decode, batched over whole planes.

Port of mozjpeg_tpu/ops/color.py ycc_to_rgb: the table semantics of
mozjpeg jdcolor.c build_ycc_rgb_table inlined as int32 multiplies
(SCALEBITS=16), clamped with the plain range-limit table of
ycc_rgb_convert (not the post-IDCT wraparound one).
"""
from __future__ import annotations

import torch

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


# jdcolor.c build_ycc_rgb_table: Cr=>R and Cb=>B round with ONE_HALF;
# the G terms are summed unrounded, with ONE_HALF folded into the sum
FIX_1_40200 = _fix(1.40200)
FIX_1_77200 = _fix(1.77200)
FIX_0_71414 = _fix(0.71414)
FIX_0_34414 = _fix(0.34414)


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
    rgb = torch.clamp(torch.stack([r, g, b], dim=-1), 0, maxv)
    # samples wider than 8 bits stay int32 (torch has no full uint16)
    return rgb.to(torch.uint8) if precision <= 8 else rgb
