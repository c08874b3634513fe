"""Quantization with the reference's exact rounding.

Port of mozjpeg_tpu/ops/quant.py::quantize_islow_t: round-half-away-from-
zero division by 8q of the islow DCT output (mozjpeg jcdctmgr.c:181-230),
computed as an integer division on non-negative operands.
"""
from __future__ import annotations

import torch


def quantize_islow_t(coeffs: torch.Tensor, qtbl81: torch.Tensor
                     ) -> torch.Tensor:
    """(8, 8, N) int32 islow output x qtbl81 (8, 8, 1) -> (8, 8, N) int16."""
    q = qtbl81.to(torch.int32) << 3
    a = coeffs.abs()
    mag = (a + (q >> 1)) // q
    return torch.where(coeffs < 0, -mag, mag).to(torch.int16)
