"""Exact-integer islow DCTs, batched over blocks (int32).

Port of mozjpeg_tpu/ops/dct.py (fdct_islow_t, idct_islow and their
butterflies): the Loeffler-Ligtenberg-Moshovitz fixed-point DCTs of
mozjpeg jfdctint.c / jidctint.c (CONST_BITS=13, PASS1_BITS=2, 32-bit
arithmetic) as whole-tensor ops over every block at once.

Exactness: everything stays int32, as in the reference's `int`
workspace. Products of extreme coefficients (corrupt streams) overflow
and wrap in two's complement here exactly as in the JAX int32 program;
widening to int64 would change those results. `>>` on signed int32 is an
arithmetic shift in torch, as C's DESCALE needs.
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


def _idct_butterfly(d, descale_n: int):
    """One 1-D LLM inverse pass; d[0..7] are the 8 frequency lanes."""
    z2 = d[2]
    z3 = d[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * (-FIX_1_847759065)
    tmp3 = z1 + z2 * FIX_0_765366865

    z2 = d[0]
    z3 = d[4]
    tmp0 = (z2 + z3) << CONST_BITS
    tmp1 = (z2 - z3) << CONST_BITS

    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602

    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560)
    z4 = z4 * (-FIX_0_390180644)

    z3 = z3 + z5
    z4 = z4 + z5

    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    o0 = _descale(tmp10 + t3, descale_n)
    o7 = _descale(tmp10 - t3, descale_n)
    o1 = _descale(tmp11 + t2, descale_n)
    o6 = _descale(tmp11 - t2, descale_n)
    o2 = _descale(tmp12 + t1, descale_n)
    o5 = _descale(tmp12 - t1, descale_n)
    o3 = _descale(tmp13 + t0, descale_n)
    o4 = _descale(tmp13 - t0, descale_n)
    return o0, o1, o2, o3, o4, o5, o6, o7


def _range_limit(v: torch.Tensor, precision: int = 8) -> torch.Tensor:
    """The post-IDCT wraparound table of mozjpeg jdmaster.c
    prepare_range_limit_table, as a closed form over v & RANGE_MASK.
    `v & mask` of a negative int32 is two's complement, as in C and XLA;
    the cast to a narrow type comes only after the table."""
    m = (1 << precision) - 1          # MAXJSAMPLE
    ctr = 1 << (precision - 1)
    mask = 4 * (m + 1) - 1
    idx = v & mask
    out = torch.where(idx < ctr, idx + ctr,
                      torch.where(idx < 2 * (m + 1), m,
                                  torch.where(idx < 4 * (m + 1) - ctr, 0,
                                              idx - (4 * (m + 1) - ctr))))
    # samples wider than 8 bits stay int32 (torch has no full uint16)
    return out.to(torch.uint8) if precision <= 8 else out


def idct_islow(coeffs: torch.Tensor, qtbl: torch.Tensor,
               pass1_bits: int = PASS1_BITS,
               precision: int = 8) -> torch.Tensor:
    """Exact islow dequantize + IDCT: (..., 8, 8) natural-order
    coefficients times an (8, 8) or broadcastable quant table ->
    (..., 8, 8) samples, range-limited like jidctint.c."""
    # int16 coefficient x quant table, in int32 (the JAX program's width)
    x = coeffs.to(torch.int32) * qtbl.to(torch.int32)
    d = [x[..., i, :] for i in range(8)]               # pass 1 over columns
    o = _idct_butterfly(d, CONST_BITS - pass1_bits)
    y = torch.stack(o, dim=-2)
    d = [y[..., :, i] for i in range(8)]               # pass 2 over rows
    o = _idct_butterfly(d, CONST_BITS + pass1_bits + 3)
    return _range_limit(torch.stack(o, dim=-1), precision)
