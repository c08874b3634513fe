"""JPEG standard constants and mozjpeg's tuned tables.

The port's own copy of what it needs from mozjpeg_tpu/consts.py (the port
imports nothing from the JAX package). Data tables only, as numpy arrays.

Parity references (values, not code):
  - zigzag order: ITU-T T.81 Figure 5 (mozjpeg jutils.c jpeg_natural_order)
  - quant presets: mozjpeg jcparam.c:76-292 (9 luma + 9 chroma presets)
  - quality scaling: mozjpeg jcparam.c:329-357
  - standard Huffman tables: ITU-T T.81 Annex K.3 (mozjpeg jstdhuff.c)
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Zigzag: JPEG_ZIGZAG[k] = natural (row*8+col) index of the k-th zigzag coeff.
# JPEG_ZIGZAG_INV[n] = zigzag position of natural index n.
# ---------------------------------------------------------------------------


def _make_zigzag() -> np.ndarray:
    order = []
    for s in range(15):  # anti-diagonals
        rng = range(s + 1) if s < 8 else range(s - 7, 8)
        idx = [(i, s - i) for i in rng]
        if s % 2 == 0:  # even diagonals run bottom-left -> top-right
            idx = idx[::-1]
        order += [r * 8 + c for r, c in idx]
    return np.array(order, dtype=np.int32)


JPEG_ZIGZAG = _make_zigzag()
JPEG_ZIGZAG_INV = np.argsort(JPEG_ZIGZAG).astype(np.int32)

# ---------------------------------------------------------------------------
# Quantization table presets (mozjpeg ships 9 luma + 9 chroma base tables;
# index 3 — the ImageMagick-forum table — is the mozjpeg default).
# Values transcribed from mozjpeg jcparam.c:76-292 (natural order).
# ---------------------------------------------------------------------------

STD_LUMINANCE_QUANT_TBL = np.array([
    [  # 0: JPEG Annex K
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    [16] * 64,  # 1: flat
    [  # 2: MSSIM-tuned (Kodak)
        12, 17, 20, 21, 30, 34, 56, 63,
        18, 20, 20, 26, 28, 51, 61, 55,
        19, 20, 21, 26, 33, 58, 69, 55,
        26, 26, 26, 30, 46, 87, 86, 66,
        31, 33, 36, 40, 46, 96, 100, 73,
        40, 35, 46, 62, 81, 100, 111, 91,
        46, 66, 76, 86, 102, 121, 120, 101,
        68, 90, 90, 96, 113, 102, 105, 103,
    ],
    [  # 3: ImageMagick forum table (mozjpeg default)
        16, 16, 16, 18, 25, 37, 56, 85,
        16, 17, 20, 27, 34, 40, 53, 75,
        16, 20, 24, 31, 43, 62, 91, 135,
        18, 27, 31, 40, 53, 74, 106, 156,
        25, 34, 43, 53, 69, 94, 131, 189,
        37, 40, 62, 74, 94, 124, 169, 238,
        56, 53, 91, 106, 131, 169, 226, 311,
        85, 75, 135, 156, 189, 238, 311, 418,
    ],
    [  # 4: PSNR-HVS-M tuned (Kodak)
        9, 10, 12, 14, 27, 32, 51, 62,
        11, 12, 14, 19, 27, 44, 59, 73,
        12, 14, 18, 25, 42, 59, 79, 78,
        17, 18, 25, 42, 61, 92, 87, 92,
        23, 28, 42, 75, 79, 112, 112, 99,
        40, 42, 59, 84, 88, 124, 132, 111,
        42, 64, 78, 95, 105, 126, 125, 99,
        70, 75, 100, 102, 116, 100, 107, 98,
    ],
    [  # 5: Klein, Silverstein, Carney (1992)
        10, 12, 14, 19, 26, 38, 57, 86,
        12, 18, 21, 28, 35, 41, 54, 76,
        14, 21, 25, 32, 44, 63, 92, 136,
        19, 28, 32, 41, 54, 75, 107, 157,
        26, 35, 44, 54, 70, 95, 132, 190,
        38, 41, 63, 75, 95, 125, 170, 239,
        57, 54, 92, 107, 132, 170, 227, 312,
        86, 76, 136, 157, 190, 239, 312, 419,
    ],
    [  # 6: Watson, Taylor, Borthwick DCTune (1997)
        7, 8, 10, 14, 23, 44, 95, 241,
        8, 8, 11, 15, 25, 47, 102, 255,
        10, 11, 13, 19, 31, 58, 127, 255,
        14, 15, 19, 27, 44, 83, 181, 255,
        23, 25, 31, 44, 72, 136, 255, 255,
        44, 47, 58, 83, 136, 255, 255, 255,
        95, 102, 127, 181, 255, 255, 255, 255,
        241, 255, 255, 255, 255, 255, 255, 255,
    ],
    [  # 7: Ahumada, Watson, Peterson (1993)
        15, 11, 11, 12, 15, 19, 25, 32,
        11, 13, 10, 10, 12, 15, 19, 24,
        11, 10, 14, 14, 16, 18, 22, 27,
        12, 10, 14, 18, 21, 24, 28, 33,
        15, 12, 16, 21, 26, 31, 36, 42,
        19, 15, 18, 24, 31, 38, 45, 53,
        25, 19, 22, 28, 36, 45, 55, 65,
        32, 24, 27, 33, 42, 53, 65, 77,
    ],
    [  # 8: Peterson, Ahumada, Watson (1993)
        14, 10, 11, 14, 19, 25, 34, 45,
        10, 11, 11, 12, 15, 20, 26, 33,
        11, 11, 15, 18, 21, 25, 31, 38,
        14, 12, 18, 24, 28, 33, 39, 47,
        19, 15, 21, 28, 36, 43, 51, 59,
        25, 20, 25, 33, 43, 54, 64, 74,
        34, 26, 31, 39, 51, 64, 77, 91,
        45, 33, 38, 47, 59, 74, 91, 108,
    ],
], dtype=np.uint32)

STD_CHROMINANCE_QUANT_TBL = np.array([
    [  # 0: JPEG Annex K
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    [16] * 64,  # 1: flat
    [  # 2: MSSIM-tuned
        8, 12, 15, 15, 86, 96, 96, 98,
        13, 13, 15, 26, 90, 96, 99, 98,
        12, 15, 18, 96, 99, 99, 99, 99,
        17, 16, 90, 96, 99, 99, 99, 99,
        96, 96, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    [  # 3: ImageMagick forum table (same as luma; mozjpeg default)
        16, 16, 16, 18, 25, 37, 56, 85,
        16, 17, 20, 27, 34, 40, 53, 75,
        16, 20, 24, 31, 43, 62, 91, 135,
        18, 27, 31, 40, 53, 74, 106, 156,
        25, 34, 43, 53, 69, 94, 131, 189,
        37, 40, 62, 74, 94, 124, 169, 238,
        56, 53, 91, 106, 131, 169, 226, 311,
        85, 75, 135, 156, 189, 238, 311, 418,
    ],
    [  # 4: PSNR-HVS-M tuned
        9, 10, 17, 19, 62, 89, 91, 97,
        12, 13, 18, 29, 84, 91, 88, 98,
        14, 19, 29, 93, 95, 95, 98, 97,
        20, 26, 84, 88, 95, 95, 98, 94,
        26, 86, 91, 93, 97, 99, 98, 99,
        99, 100, 98, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        97, 97, 99, 99, 99, 99, 97, 99,
    ],
    [  # 5: KSC (copied from luma)
        10, 12, 14, 19, 26, 38, 57, 86,
        12, 18, 21, 28, 35, 41, 54, 76,
        14, 21, 25, 32, 44, 63, 92, 136,
        19, 28, 32, 41, 54, 75, 107, 157,
        26, 35, 44, 54, 70, 95, 132, 190,
        38, 41, 63, 75, 95, 125, 170, 239,
        57, 54, 92, 107, 132, 170, 227, 312,
        86, 76, 136, 157, 190, 239, 312, 419,
    ],
    [  # 6: DCTune (copied from luma)
        7, 8, 10, 14, 23, 44, 95, 241,
        8, 8, 11, 15, 25, 47, 102, 255,
        10, 11, 13, 19, 31, 58, 127, 255,
        14, 15, 19, 27, 44, 83, 181, 255,
        23, 25, 31, 44, 72, 136, 255, 255,
        44, 47, 58, 83, 136, 255, 255, 255,
        95, 102, 127, 181, 255, 255, 255, 255,
        241, 255, 255, 255, 255, 255, 255, 255,
    ],
    [  # 7: AWP (copied from luma)
        15, 11, 11, 12, 15, 19, 25, 32,
        11, 13, 10, 10, 12, 15, 19, 24,
        11, 10, 14, 14, 16, 18, 22, 27,
        12, 10, 14, 18, 21, 24, 28, 33,
        15, 12, 16, 21, 26, 31, 36, 42,
        19, 15, 18, 24, 31, 38, 45, 53,
        25, 19, 22, 28, 36, 45, 55, 65,
        32, 24, 27, 33, 42, 53, 65, 77,
    ],
    [  # 8: PAW (copied from luma)
        14, 10, 11, 14, 19, 25, 34, 45,
        10, 11, 11, 12, 15, 20, 26, 33,
        11, 11, 15, 18, 21, 25, 31, 38,
        14, 12, 18, 24, 28, 33, 39, 47,
        19, 15, 21, 28, 36, 43, 51, 59,
        25, 20, 25, 33, 43, 54, 64, 74,
        34, 26, 31, 39, 51, 64, 77, 91,
        45, 33, 38, 47, 59, 74, 91, 108,
    ],
], dtype=np.uint32)


def quality_scaling(quality: float) -> float:
    """Quality (1..100) -> linear table scale percentage (jcparam.c:329-357)."""
    quality = min(max(float(quality), 1.0), 100.0)
    if quality < 50.0:
        return 5000.0 / quality
    return 200.0 - quality * 2.0


def scale_quant_table(basic_table: np.ndarray, scale_factor: float,
                      force_baseline: bool = True) -> np.ndarray:
    """Scale a base table by percentage, clamping like jpeg_add_quant_table.

    Matches mozjpeg jcparam.c:30-68 exactly for integer scale factors
    (the reference computes (v*sf + 50)/100 in integer math when called through
    jpeg_set_quality; jpeg_quality_scaling returns an int there).
    """
    sf = int(scale_factor)
    t = (basic_table.astype(np.int64) * sf + 50) // 100
    t = np.clip(t, 1, 32767)
    if force_baseline:
        t = np.minimum(t, 255)
    return t.astype(np.uint16)


# ---------------------------------------------------------------------------
# Standard Huffman tables (ITU-T T.81 Annex K.3). bits[1..16] = #codes of each
# length; we store as (bits[17], vals[]) like the reference's JHUFF_TBL.
# ---------------------------------------------------------------------------

STD_DC_LUMINANCE = (
    np.array([0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.uint8),
    np.arange(12, dtype=np.uint8),
)
STD_DC_CHROMINANCE = (
    np.array([0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], dtype=np.uint8),
    np.arange(12, dtype=np.uint8),
)
STD_AC_LUMINANCE = (
    np.array([0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], dtype=np.uint8),
    np.array([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
        0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
        0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16,
        0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
        0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
        0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
        0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
        0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
        0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4,
        0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
        0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
        0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
        0xf9, 0xfa], dtype=np.uint8),
)
STD_AC_CHROMINANCE = (
    np.array([0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], dtype=np.uint8),
    np.array([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
        0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
        0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34,
        0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
        0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
        0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
        0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
        0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
        0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
        0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
        0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
        0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
        0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
        0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
        0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
        0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
        0xf9, 0xfa], dtype=np.uint8),
)
