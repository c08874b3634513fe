"""Exact-integer islow forward DCT, batched over blocks (int32).

Port of mozjpeg_tpu/ops/dct.py (fdct_islow_t and its butterfly): the
Loeffler-Ligtenberg-Moshovitz fixed-point DCT of mozjpeg jfdctint.c
(CONST_BITS=13, PASS1_BITS=2, 32-bit arithmetic) as whole-tensor ops over
every block at once.
"""
from __future__ import annotations

import torch

CONST_BITS = 13
PASS1_BITS = 2

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def _descale(x, n: int):
    """(x + 2^(n-1)) >> n with arithmetic shift: C's DESCALE."""
    return (x + (1 << (n - 1))) >> n


def _fdct_butterfly(d, shift_even: int, descale_n: int):
    """One 1-D LLM forward pass on 8 lanes d[0..7]; returns 8 lanes.

    shift_even: left shift of the even 0/4 outputs (pass 1); when
    negative, descale by -shift_even instead (pass 2)."""
    tmp0 = d[0] + d[7]
    tmp7 = d[0] - d[7]
    tmp1 = d[1] + d[6]
    tmp6 = d[1] - d[6]
    tmp2 = d[2] + d[5]
    tmp5 = d[2] - d[5]
    tmp3 = d[3] + d[4]
    tmp4 = d[3] - d[4]

    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    if shift_even >= 0:
        o0 = (tmp10 + tmp11) << shift_even
        o4 = (tmp10 - tmp11) << shift_even
    else:
        o0 = _descale(tmp10 + tmp11, -shift_even)
        o4 = _descale(tmp10 - tmp11, -shift_even)

    z1 = (tmp12 + tmp13) * FIX_0_541196100
    o2 = _descale(z1 + tmp13 * FIX_0_765366865, descale_n)
    o6 = _descale(z1 + tmp12 * (-FIX_1_847759065), descale_n)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602

    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560)
    z4 = z4 * (-FIX_0_390180644)

    z3 = z3 + z5
    z4 = z4 + z5

    o7 = _descale(tmp4 + z1 + z3, descale_n)
    o5 = _descale(tmp5 + z2 + z4, descale_n)
    o3 = _descale(tmp6 + z2 + z3, descale_n)
    o1 = _descale(tmp7 + z1 + z4, descale_n)
    return o0, o1, o2, o3, o4, o5, o6, o7


def fdct_islow_t(x: torch.Tensor) -> torch.Tensor:
    """Exact islow forward DCT on (8, 8, N) int32 centered 8-bit samples;
    output scaled x8 like jpeg_fdct_islow."""
    x = x.to(torch.int32)
    d = [x[:, c, :] for c in range(8)]                 # pass 1 over rows
    o = _fdct_butterfly(d, PASS1_BITS, CONST_BITS - PASS1_BITS)
    y = torch.stack(o, dim=1)                          # (8, 8, N)
    d = [y[r, :, :] for r in range(8)]                 # pass 2 over columns
    o = _fdct_butterfly(d, -PASS1_BITS, CONST_BITS + PASS1_BITS)
    return torch.stack(o, dim=0)
