"""The bytes bounds of the two hand kernels' 12-bit launches (beside
core/geometry.py's 8-bit ones), from the image's shape alone: each input
byte read once and each output byte written once.

p1_blocks_kernel<int32_t> reads int32 samples; its outputs are the 8-bit
launch's. trellis_ac_kernel<14, 16383> reads and writes what the 8-bit
instantiation does: the rate table keeps its (128, 16) shape, since 14
bit lengths fit its 16 columns.
"""
from __future__ import annotations

from . import geometry

# p1_blocks at 12 bits, per 8x8 block: 64 int32 samples in; 64 int16
# quantized and 64 int32 raw coefficients, an f32 norm and a flag byte
# out. Per image and component: the 256-bin int32 AC-first histogram.
P1_BLOCK_BYTES = 64 * 4 + 64 * 2 + 64 * 4 + 4 + 1
P1_IMAGE_BYTES = geometry.P1_IMAGE_BYTES
# trellis_ac<14, 16383>, per block and per image and component
TRELLIS_BLOCK_BYTES = geometry.TRELLIS_BLOCK_BYTES
TRELLIS_IMAGE_BYTES = geometry.TRELLIS_IMAGE_BYTES


def p1_blocks12_bytes(width: int, height: int, samp) -> int:
    return sum(P1_BLOCK_BYTES * n + P1_IMAGE_BYTES
               for n in geometry.comp_blocks(width, height, samp))


def trellis_ac14_bytes(width: int, height: int, samp) -> int:
    return sum(TRELLIS_BLOCK_BYTES * n + TRELLIS_IMAGE_BYTES
               for n in geometry.comp_blocks(width, height, samp))
