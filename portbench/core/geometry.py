"""Block geometry of an encode and the bytes bounds of two hand kernels.

The bounds count what the work needs, from the image's shape alone: each
input byte read once and each output byte written once, whatever a
launch is given or reads again (after chip_smoke.p1_bound and
trellis_bound, which read launch arguments).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, at its 700 W limit
H100_BYTES_PER_S = 3.35e12

# p1_blocks, per 8x8 block: 64 uint8 samples in; 64 int16 quantized and 64
# int32 raw coefficients, an f32 norm and a flag byte out. Per image and
# component: the 256-bin int32 AC-first histogram out.
P1_BLOCK_BYTES = 64 + 64 * 2 + 64 * 4 + 4 + 1
P1_IMAGE_BYTES = 256 * 4
# trellis_ac, per block: 64 int32 raw coefficients and an f32 lambda in;
# 64 int32 kept values and 8 f32 end-of-block rows out. Per image and
# component: the (128, 16) f32 rate table in.
TRELLIS_BLOCK_BYTES = 64 * 4 + 4 + 64 * 4 + 8 * 4
TRELLIS_IMAGE_BYTES = 128 * 16 * 4


def comp_blocks(width: int, height: int,
                samp: Sequence[Tuple[int, int]]) -> List[int]:
    """The real 8x8 blocks of each component (T.81 A.2): samp is each
    component's (h, v) sampling factors, the first the largest."""
    mh = max(h for h, _ in samp)
    mv = max(v for _, v in samp)
    out = []
    for h, v in samp:
        cw = -(-width * h // mh)
        ch = -(-height * v // mv)
        out.append(-(-cw // 8) * -(-ch // 8))
    return out


def p1_blocks_bytes(width: int, height: int, samp) -> int:
    return sum(P1_BLOCK_BYTES * n + P1_IMAGE_BYTES
               for n in comp_blocks(width, height, samp))


def trellis_ac_bytes(width: int, height: int, samp) -> int:
    return sum(TRELLIS_BLOCK_BYTES * n + TRELLIS_IMAGE_BYTES
               for n in comp_blocks(width, height, samp))


def roofline_pct(nbytes: float, device_s: float):
    """Share of the bytes bound in a kernel's device time, in %, or None
    where the kernel did not run."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / H100_BYTES_PER_S / device_s
