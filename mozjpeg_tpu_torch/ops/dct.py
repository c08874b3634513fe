"""Forward and inverse DCTs batched over blocks.

Port of mozjpeg_tpu/ops/dct.py: the Loeffler-Ligtenberg-Moshovitz
fixed-point islow DCTs of mozjpeg jfdctint.c / jidctint.c (CONST_BITS=13,
PASS1_BITS=2, 32-bit arithmetic), the encoder's AAN ifast (jfdctfst.c)
and float (jfdctflt.c) forward DCTs with their quantizers and raw
rescales, and the decoder's AAN ifast (jidctfst.c) and float
(jidctflt.c) inverse DCTs with their multiplier tables, as whole-tensor
ops over every block at once.

Exactness: everything stays int32, as in the reference's `int`
workspace. Products of extreme coefficients (corrupt streams) overflow
and wrap in two's complement here exactly as in the JAX int32 program;
widening to int64 would change those results. `>>` on signed int32 is an
arithmetic shift in torch, as C's DESCALE needs.
"""
from __future__ import annotations

import numpy as np
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


def pass1_bits(precision: int) -> int:
    """PASS1_BITS of jfdctint.c / jidctint.c: 2 for 8-bit samples, 1 for
    12-bit ones (so that the 12-bit products stay in 32 bits)."""
    return PASS1_BITS if precision == 8 else 1


def fdct_islow_t(x: torch.Tensor, pass1: int = PASS1_BITS) -> torch.Tensor:
    """Exact islow forward DCT on (8, 8, N) int32 centered samples (pass1
    = pass1_bits(precision)); output scaled x8 like jpeg_fdct_islow."""
    x = x.to(torch.int32)
    d = [x[:, c, :] for c in range(8)]                 # pass 1 over rows
    o = _fdct_butterfly(d, pass1, CONST_BITS - pass1)
    y = torch.stack(o, dim=1)                          # (8, 8, N)
    d = [y[r, :, :] for r in range(8)]                 # pass 2 over columns
    o = _fdct_butterfly(d, -pass1, CONST_BITS + pass1)
    return torch.stack(o, dim=0)


# ---------------------------------------------------------------------------
# AAN "ifast" forward DCT (jfdctfst.c, plain-C build: DCTELEM = int,
# CONST_BITS = 8, MULTIPLY is a plain arithmetic shift with no rounding).
# ---------------------------------------------------------------------------

AANSCALES = np.asarray([
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967, 3552,
    8867, 12299, 11585, 10426, 8867, 6967, 4799, 2446,
    4520, 6270, 5906, 5315, 4520, 3552, 2446, 1247,
], dtype=np.int32).reshape(8, 8)

_F_0_382 = 98     # FIX(0.382683433) at CONST_BITS=8
_F_0_541 = 139
_F_0_707 = 181
_F_1_306 = 334


def _mul8(v, c: int):
    """ifast MULTIPLY: (v * c) >> 8, an arithmetic shift without rounding
    (jfdctfst.c:101 redefines DESCALE as RIGHT_SHIFT)."""
    return (v * c) >> 8


def _fdct_ifast_1d(d):
    t0 = d[0] + d[7]
    t7 = d[0] - d[7]
    t1 = d[1] + d[6]
    t6 = d[1] - d[6]
    t2 = d[2] + d[5]
    t5 = d[2] - d[5]
    t3 = d[3] + d[4]
    t4 = d[3] - d[4]
    t10 = t0 + t3
    t13 = t0 - t3
    t11 = t1 + t2
    t12 = t1 - t2
    o0 = t10 + t11
    o4 = t10 - t11
    z1 = _mul8(t12 + t13, _F_0_707)
    o2 = t13 + z1
    o6 = t13 - z1
    t10 = t4 + t5
    t11 = t5 + t6
    t12 = t6 + t7
    z5 = _mul8(t10 - t12, _F_0_382)
    z2 = _mul8(t10, _F_0_541) + z5
    z4 = _mul8(t12, _F_1_306) + z5
    z3 = _mul8(t11, _F_0_707)
    z11 = t7 + z3
    z13 = t7 - z3
    return [o0, z11 + z4, o2, z13 - z2, o4, z13 + z2, o6, z11 - z4]


def fdct_ifast_t(x: torch.Tensor) -> torch.Tensor:
    """AAN forward DCT on (8, 8, N) int32 centred samples; the output
    carries the AAN scale factors (the divisors absorb them)."""
    x = x.to(torch.int32)
    y = torch.stack(_fdct_ifast_1d([x[:, c, :] for c in range(8)]), dim=1)
    return torch.stack(_fdct_ifast_1d([y[r, :, :] for r in range(8)]),
                       dim=0)


def ifast_divisors(qtbl) -> np.ndarray:
    """Encoder divisors DESCALE(quantval * aanscale, 11) with the rounding
    add (jcdctmgr.c:296-345) -> (8, 8) int32."""
    q = np.asarray(qtbl).astype(np.int64).reshape(8, 8)
    return ((q * AANSCALES.astype(np.int64) + (1 << 10)) >> 11) \
        .astype(np.int32)


def quantize_ifast_t(coeffs: torch.Tensor, dtbl81: torch.Tensor
                     ) -> torch.Tensor:
    """floor((|x| + d//2) / d) with the sign of x, the value of jcdctmgr's
    reciprocal-multiply quantize for every divisor; int16 out."""
    d = dtbl81.to(torch.int32)
    a = coeffs.abs()
    mag = (a + (d >> 1)) // d
    return torch.where(coeffs < 0, -mag, mag).to(torch.int16)


def rescale_ifast_t(coeffs: torch.Tensor) -> torch.Tensor:
    """AAN output to the nominal islow range for the trellis's raw save
    (jcdctmgr.c:730-748): (x*32768 +- s) divided by 2s, truncating. The
    int32 products wrap as the JAX program's do."""
    s = torch.as_tensor(AANSCALES.reshape(8, 8, 1), device=coeffs.device)
    num = torch.where(coeffs >= 0, coeffs * 32768 + s, coeffs * 32768 - s)
    return torch.div(num, 2 * s, rounding_mode="trunc")


# ---------------------------------------------------------------------------
# Float AAN forward DCT (jfdctflt.c): single-precision butterflies. Eager
# PyTorch rounds every f32 product before it feeds an add (one kernel per
# op), which is what the JAX package's minimum() guards force on XLA; so
# no addcmul, no fused form and no torch.compile here. The constants are
# the f32 values of the C literals.
# ---------------------------------------------------------------------------

_AAN_F = (1.0, 1.387039845, 1.306562965, 1.175875602,
          1.0, 0.785694958, 0.541196100, 0.275899379)


def _f32(c: float) -> float:
    return float(np.float32(c))


_C_0_707 = _f32(0.707106781)
_C_0_382 = _f32(0.382683433)
_C_0_541 = _f32(0.541196100)
_C_1_306 = _f32(1.306562965)


def _fdct_float_1d(d):
    tmp0 = d[0] + d[7]
    tmp7 = d[0] - d[7]
    tmp1 = d[1] + d[6]
    tmp6 = d[1] - d[6]
    tmp2 = d[2] + d[5]
    tmp5 = d[2] - d[5]
    tmp3 = d[3] + d[4]
    tmp4 = d[3] - d[4]
    t10 = tmp0 + tmp3
    t13 = tmp0 - tmp3
    t11 = tmp1 + tmp2
    t12 = tmp1 - tmp2
    o0 = t10 + t11
    o4 = t10 - t11
    z1 = (t12 + t13) * _C_0_707
    o2 = t13 + z1
    o6 = t13 - z1
    t10 = tmp4 + tmp5
    t11 = tmp5 + tmp6
    t12 = tmp6 + tmp7
    z5 = (t10 - t12) * _C_0_382
    z2 = t10 * _C_0_541 + z5
    z4 = t12 * _C_1_306 + z5
    z3 = t11 * _C_0_707
    z11 = tmp7 + z3
    z13 = tmp7 - z3
    return [o0, z11 + z4, o2, z13 - z2, o4, z13 + z2, o6, z11 - z4]


def fdct_float_t(x: torch.Tensor) -> torch.Tensor:
    """(8, 8, N) float32 centred samples -> AAN-scaled float coefficients."""
    y = torch.stack(_fdct_float_1d([x[:, c, :] for c in range(8)]), dim=1)
    return torch.stack(_fdct_float_1d([y[r, :, :] for r in range(8)]),
                       dim=0)


def float_divisors(qtbl) -> np.ndarray:
    """1 / (quantval * aan_r * aan_c * 8) in double, stored as float
    (jcdctmgr.c JDCT_FLOAT divisors) -> (8, 8) float32."""
    q = np.asarray(qtbl, dtype=np.float64).reshape(8, 8)
    aan = np.asarray(_AAN_F, dtype=np.float64)
    return (1.0 / (q * aan[:, None] * aan[None, :] * 8.0)).astype(np.float32)


def quantize_float_t(coeffs: torch.Tensor, div81: torch.Tensor
                     ) -> torch.Tensor:
    """(JCOEF)((int)(v * divisor + 16384.5) - 16384): the product, then
    the add, then the truncating cast (quantize_float)."""
    temp = coeffs * div81 + 16384.5
    return (temp.to(torch.int32) - 16384).to(torch.int16)


def _rescale_float_consts(device):
    """The f32 reciprocals and the f32 hi/lo split of aan_r * aan_c."""
    aan = np.asarray(_AAN_F, dtype=np.float64)
    a2 = aan[:, None] * aan[None, :]
    hi = a2.astype(np.float32)
    lo = (a2 - hi.astype(np.float64)).astype(np.float32)
    r = (1.0 / a2).astype(np.float32)
    return tuple(torch.as_tensor(t.reshape(8, 8, 1), device=device)
                 for t in (r, hi, lo))


def rescale_float_t(coeffs: torch.Tensor) -> torch.Tensor:
    """The trellis's raw save: coefficient / (aan_r * aan_c) rounded half
    away from zero to int32 (jcdctmgr.c forward_DCT_float). C divides in
    double; the JAX package takes a reciprocal product with one
    float-float Newton correction, and this is that formula, op for op in
    f32, so the two agree on every input, ties included."""
    r, a_hi, a_lo = _rescale_float_consts(coeffs.device)
    q1 = coeffs * r
    resid = (coeffs - q1 * a_hi) - q1 * a_lo
    q = q1 + resid * r
    half = torch.where(q >= 0, 0.5, -0.5)
    return (q + half).to(torch.int32)


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


# ---------------------------------------------------------------------------
# The decoder's AAN IDCTs at 8 bits: ifast (jidctfst.c, int32 products
# that wrap, MULTIPLY a plain >> 8) and float (jidctflt.c, every f32
# product rounded before it feeds an add, as eager PyTorch does op by op).
# ---------------------------------------------------------------------------

_F_1_082 = 277    # FIX(1.082392200) at CONST_BITS=8
_F_1_414 = 362
_F_1_847 = 473
_F_2_613 = 669


def ifast_multipliers(qtbl) -> np.ndarray:
    """The ifast decoder's multiplier table DESCALE(quantval * aanscale,
    12) (jddctmgr.c) -> (8, 8) int32."""
    q = np.asarray(qtbl).astype(np.int64).reshape(8, 8)
    return ((q * AANSCALES.astype(np.int64) + (1 << 11)) >> 12) \
        .astype(np.int32)


def _idct_ifast_1d(d):
    t10 = d[0] + d[4]
    t11 = d[0] - d[4]
    t13 = d[2] + d[6]
    t12 = _mul8(d[2] - d[6], _F_1_414) - t13
    t0 = t10 + t13
    t3 = t10 - t13
    t1 = t11 + t12
    t2 = t11 - t12
    z13 = d[5] + d[3]
    z10 = d[5] - d[3]
    z11 = d[1] + d[7]
    z12 = d[1] - d[7]
    t7 = z11 + z13
    t11 = _mul8(z11 - z13, _F_1_414)
    z5 = _mul8(z10 + z12, _F_1_847)
    t10 = _mul8(z12, _F_1_082) - z5
    t12 = _mul8(z10, -_F_2_613) + z5
    t6 = t12 - t7
    t5 = t11 - t6
    t4 = t10 + t5
    return [t0 + t7, t1 + t6, t2 + t5, t3 - t4, t3 + t4, t2 - t5,
            t1 - t6, t0 - t7]


def idct_ifast(coeffs: torch.Tensor, ifmtbl: torch.Tensor,
               precision: int = 8) -> torch.Tensor:
    """AAN integer IDCT: (..., 8, 8) natural-order coefficients times the
    ifast multiplier table -> (..., 8, 8) samples. The final descale is a
    plain >> 5 (PASS1_BITS + 3, jidctfst.c IDESCALE without rounding),
    then the wraparound range limit of the precision (the JAX package
    keeps the 8-bit descale at 12 bits too)."""
    x = coeffs.to(torch.int32) * ifmtbl.to(torch.int32)
    y = torch.stack(_idct_ifast_1d([x[..., i, :] for i in range(8)]),
                    dim=-2)                            # columns
    o = torch.stack(_idct_ifast_1d([y[..., :, i] for i in range(8)]),
                    dim=-1)                            # rows
    return _range_limit(o >> 5, precision)


def float_multipliers(qtbl) -> np.ndarray:
    """The float decoder's table (float)(quantval * aan_r * aan_c), in
    double then stored as float (jddctmgr.c) -> (8, 8) float32."""
    q = np.asarray(qtbl, dtype=np.float64).reshape(8, 8)
    aan = np.asarray(_AAN_F, dtype=np.float64)
    return (q * aan[:, None] * aan[None, :]).astype(np.float32)


_C_1_414 = _f32(1.414213562)
_C_1_847 = _f32(1.847759065)
_C_1_082 = _f32(1.082392200)
_C_2_613 = _f32(2.613125930)


def _idct_float_1d(d, center=None):
    d0 = d[0] if center is None else d[0] + center
    t10 = d0 + d[4]
    t11 = d0 - d[4]
    t13 = d[2] + d[6]
    t12 = (d[2] - d[6]) * _C_1_414 - t13
    t0 = t10 + t13
    t3 = t10 - t13
    t1 = t11 + t12
    t2 = t11 - t12
    z13 = d[5] + d[3]
    z10 = d[5] - d[3]
    z11 = d[1] + d[7]
    z12 = d[1] - d[7]
    t7 = z11 + z13
    t11 = (z11 - z13) * _C_1_414
    z5 = (z10 + z12) * _C_1_847
    t10 = z5 - z12 * _C_1_082
    t12 = z5 - z10 * _C_2_613
    t6 = t12 - t7
    t5 = t11 - t6
    t4 = t10 - t5
    # rows 3 and 4 take t4 with the opposite sign to the ifast kernel
    # (jidctflt.c negates tmp10/tmp12 against jidctfst.c)
    return [t0 + t7, t1 + t6, t2 + t5, t3 + t4, t3 - t4, t2 - t5,
            t1 - t6, t0 - t7]


_I32_MAX_F = 2147483648.0      # 2^31, the first f32 above int32's range


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """C's (int) truncation, saturating out of range as XLA's conversion
    does (the JAX program's semantics). A bare .to(int32) of an
    out-of-range float is undefined and differs between the CPU and the
    card; corrupt streams with large quant tables reach it."""
    v = torch.clamp(x, -_I32_MAX_F, 2147483520.0).to(torch.int32)
    return torch.where(x >= _I32_MAX_F, torch.full_like(v, 2 ** 31 - 1), v)


def idct_float(coeffs: torch.Tensor, fmtbl: torch.Tensor,
               precision: int = 8) -> torch.Tensor:
    """Float AAN IDCT: (..., 8, 8) natural-order coefficients dequantized
    by fmtbl * 0.125, two f32 passes with the centre + 0.5 folded into the
    second pass's DC, (int) truncation, then jidctflt.c's range limit
    (sample_range_limit without the IDCT's centre offset: the identity on
    0..MAXJSAMPLE, then MAXJSAMPLE, then 0 over the wrapped index) ->
    (..., 8, 8) samples of the precision."""
    qm = fmtbl.to(torch.float32) * 0.125
    x = coeffs.to(torch.float32) * qm
    y = torch.stack(_idct_float_1d([x[..., i, :] for i in range(8)]),
                    dim=-2)
    o = torch.stack(_idct_float_1d([y[..., :, i] for i in range(8)],
                                   (1 << (precision - 1)) + 0.5), dim=-1)
    m = (1 << precision) - 1
    idx = _f32_to_i32(o) & (4 * (m + 1) - 1)
    lim = torch.where(idx <= m, idx,
                      torch.where(idx < 2 * (m + 1) + (m + 1) // 2, m, 0))
    return lim.to(torch.uint8 if precision <= 8 else torch.int32)
