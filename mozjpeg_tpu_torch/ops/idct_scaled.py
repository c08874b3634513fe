"""Scaled exact integer IDCTs (djpeg -scale M/8, M = 1..16).

Port of mozjpeg_tpu/ops/idct_scaled.py: mozjpeg jidctred.c (4x4, 2x2,
1x1) and jidctint.c (3x3..16x16, the _p3.._p16 1-D kernels) as
whole-tensor PyTorch ops over every block at once; the all-zero-AC
shortcuts of the reference give the general path's values, so only the
general path is written.

Inputs: (..., 8, 8) int coefficients (natural order), qtbl broadcastable.
Outputs: (..., S, S) uint8 samples.

The NxN kernels fold the descale rounding into the DC term as the C code
does (the fudge added once, plain arithmetic shifts after it).

Exactness: every product stays int32 and wraps in two's complement, as in
the JAX int32 program (a Python int constant times an int32 tensor is
int32 in both frameworks; nothing is widened to int64 or made float), and
`>>` on int32 is an arithmetic shift in both.
"""
from __future__ import annotations

import torch

from .dct import _descale, _range_limit

CONST_BITS = 13
PASS1_BITS = 2

F_0_211164243 = 1730
F_0_509795579 = 4176
F_0_601344887 = 4926
F_0_720959822 = 5906
F_0_765366865 = 6270
F_0_850430095 = 6967
F_0_899976223 = 7373
F_1_061594337 = 8697
F_1_272758580 = 10426
F_1_451774981 = 11893
F_1_847759065 = 15137
F_2_172734803 = 17799
F_2_562915447 = 20995
F_3_624509785 = 29692


def _pass_4(d0, d1, d2, d3, d5, d6, d7, descale_n):
    """One 1-D 4-point reduced pass (jidctred.c 4x4); term 4 unused."""
    tmp0 = d0 << (CONST_BITS + 1)
    tmp2 = d2 * F_1_847759065 + d6 * (-F_0_765366865)
    tmp10 = tmp0 + tmp2
    tmp12 = tmp0 - tmp2

    t0 = (d7 * (-F_0_211164243) + d5 * F_1_451774981
          + d3 * (-F_2_172734803) + d1 * F_1_061594337)
    t2 = (d7 * (-F_0_509795579) + d5 * (-F_0_601344887)
          + d3 * F_0_899976223 + d1 * F_2_562915447)
    o0 = _descale(tmp10 + t2, descale_n)
    o3 = _descale(tmp10 - t2, descale_n)
    o1 = _descale(tmp12 + t0, descale_n)
    o2 = _descale(tmp12 - t0, descale_n)
    return o0, o1, o2, o3


def idct_4x4(coeffs: torch.Tensor, qtbl: torch.Tensor) -> torch.Tensor:
    x = coeffs.to(torch.int32) * qtbl.to(torch.int32)
    # pass 1: columns (skip column 4)
    d = [x[..., i, :] for i in range(8)]
    o = _pass_4(d[0], d[1], d[2], d[3], d[5], d[6], d[7],
                CONST_BITS - PASS1_BITS + 1)
    y = torch.stack(o, dim=-2)                          # (..., 4, 8)
    d = [y[..., :, i] for i in range(8)]
    o = _pass_4(d[0], d[1], d[2], d[3], d[5], d[6], d[7],
                CONST_BITS + PASS1_BITS + 3 + 1)
    return _range_limit(torch.stack(o, dim=-1))         # (..., 4, 4)


def _pass_2(d0, d1, d3, d5, d7, descale_n):
    tmp10 = d0 << (CONST_BITS + 2)
    tmp0 = (d7 * (-F_0_720959822) + d5 * F_0_850430095
            + d3 * (-F_1_272758580) + d1 * F_3_624509785)
    o0 = _descale(tmp10 + tmp0, descale_n)
    o1 = _descale(tmp10 - tmp0, descale_n)
    return o0, o1


def idct_2x2(coeffs: torch.Tensor, qtbl: torch.Tensor) -> torch.Tensor:
    x = coeffs.to(torch.int32) * qtbl.to(torch.int32)
    d = [x[..., i, :] for i in range(8)]
    o = _pass_2(d[0], d[1], d[3], d[5], d[7], CONST_BITS - PASS1_BITS + 2)
    y = torch.stack(o, dim=-2)                          # (..., 2, 8)
    d = [y[..., :, i] for i in range(8)]
    o = _pass_2(d[0], d[1], d[3], d[5], d[7], CONST_BITS + PASS1_BITS + 3 + 2)
    return _range_limit(torch.stack(o, dim=-1))         # (..., 2, 2)


def idct_1x1(coeffs: torch.Tensor, qtbl: torch.Tensor) -> torch.Tensor:
    dc = coeffs[..., 0, 0].to(torch.int32) * qtbl.to(torch.int32)[..., 0, 0]
    return _range_limit(_descale(dc, 3))[..., None, None]


def _fix(x: float) -> int:
    return int(x * (1 << CONST_BITS) + 0.5)


def _sh(x, n):
    return x >> n              # plain arithmetic shift (fudge pre-added)


def _dc_in(d0, pass1):
    """DC term with the pass's descale fudge folded in (jidctint.c)."""
    if pass1:
        return (d0 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1))
    return (d0 + (1 << (PASS1_BITS + 2))) << CONST_BITS


def _finish(outs, pass1):
    n1 = CONST_BITS - PASS1_BITS
    n2 = CONST_BITS + PASS1_BITS + 3
    return [_sh(o, n1 if pass1 else n2) for o in outs]


def _p3(d, pass1):
    tmp0 = _dc_in(d[0], pass1)
    tmp12 = d[2] * _fix(0.707106781)
    tmp10 = tmp0 + tmp12
    tmp2 = tmp0 - tmp12 - tmp12
    t0 = d[1] * _fix(1.224744871)
    return _finish([tmp10 + t0, tmp2, tmp10 - t0], pass1)


def _p5(d, pass1):
    tmp12 = _dc_in(d[0], pass1)
    z1 = (d[2] + d[4]) * _fix(0.790569415)
    z2 = (d[2] - d[4]) * _fix(0.353553391)
    z3 = tmp12 + z2
    tmp10 = z3 + z1
    tmp11 = z3 - z1
    tmp12 = tmp12 - (z2 << 2)
    z1 = (d[1] + d[3]) * _fix(0.831253876)
    t0 = z1 + d[1] * _fix(0.513743148)
    t1 = z1 - d[3] * _fix(2.176250899)
    return _finish([tmp10 + t0, tmp11 + t1, tmp12, tmp11 - t1,
                    tmp10 - t0], pass1)


def _p6(d, pass1):
    tmp0 = _dc_in(d[0], pass1)
    t = d[4] * _fix(0.707106781)
    tmp1 = tmp0 + t
    tmp11 = tmp0 - t - t
    t2 = d[2] * _fix(1.224744871)
    tmp10 = tmp1 + t2
    tmp12 = tmp1 - t2
    z1, z2, z3 = d[1], d[3], d[5]
    o1 = (z1 + z3) * _fix(0.366025404)
    odd0 = o1 + ((z1 + z2) << CONST_BITS)
    odd2 = o1 + ((z3 - z2) << CONST_BITS)
    n1 = CONST_BITS - PASS1_BITS
    n2 = CONST_BITS + PASS1_BITS + 3
    if pass1:
        # rows 1/4 are finished early in pass 1 (jidctint.c:627-629)
        o14a = _sh(tmp11, n1)
        o14b = (z1 - z2 - z3) << PASS1_BITS
        return [_sh(tmp10 + odd0, n1), o14a + o14b,
                _sh(tmp12 + odd2, n1), _sh(tmp12 - odd2, n1),
                o14a - o14b, _sh(tmp10 - odd0, n1)]
    odd1 = (z1 - z2 - z3) << CONST_BITS
    return [_sh(tmp10 + odd0, n2), _sh(tmp11 + odd1, n2),
            _sh(tmp12 + odd2, n2), _sh(tmp12 - odd2, n2),
            _sh(tmp11 - odd1, n2), _sh(tmp10 - odd0, n2)]


def _p7(d, pass1):
    tmp13 = _dc_in(d[0], pass1)
    z1, z2, z3 = d[2], d[4], d[6]
    tmp10 = (z2 - z3) * _fix(0.881747734)
    tmp12 = (z1 - z2) * _fix(0.314692123)
    tmp11 = tmp10 + tmp12 + tmp13 - z2 * _fix(1.841218003)
    t0 = z1 + z3
    z2 = z2 - t0
    t0 = t0 * _fix(1.274162392) + tmp13
    tmp10 = tmp10 + t0 - z3 * _fix(0.077722536)
    tmp12 = tmp12 + t0 - z1 * _fix(2.470602249)
    tmp13 = tmp13 + z2 * _fix(1.414213562)
    z1, z2, z3 = d[1], d[3], d[5]
    t1 = (z1 + z2) * _fix(0.935414347)
    t2 = (z1 - z2) * _fix(0.170262339)
    t0 = t1 - t2
    t1 = t1 + t2
    t2 = (z2 + z3) * (-_fix(1.378756276))
    t1 = t1 + t2
    zz = (z1 + z3) * _fix(0.613604268)
    t0 = t0 + zz
    t2 = t2 + zz + z3 * _fix(1.870828693)
    return _finish([tmp10 + t0, tmp11 + t1, tmp12 + t2, tmp13,
                    tmp12 - t2, tmp11 - t1, tmp10 - t0], pass1)


_REDUCED = {3: _p3, 5: _p5, 6: _p6, 7: _p7}


def idct_reduced(coeffs: torch.Tensor, qtbl: torch.Tensor,
                 size: int) -> torch.Tensor:
    """NxN reduced IDCT for N in 3/5/6/7: pass 1 over the first N columns
    using the upper-left NxN coefficients, pass 2 over the N rows."""
    p = _REDUCED[size]
    x = coeffs.to(torch.int32) * qtbl.to(torch.int32)
    cols = [x[..., k, :size] for k in range(size)]     # (..., size) each
    rows = p(cols, True)                               # size x (..., size)
    y = torch.stack(rows, dim=-2)                       # (..., size, size)
    ins = [y[..., :, k] for k in range(size)]
    outs = p(ins, False)
    return _range_limit(torch.stack(outs, dim=-1))


# ---------------------------------------------------------------------------
# Expanded sizes (9..16): both passes run the same 1-D kernel producing N
# outputs from 8 inputs (jidctint.c _jpeg_idct_9x9 .. _jpeg_idct_16x16);
# pass 1 covers the 8 input columns, pass 2 the N workspace rows.
# ---------------------------------------------------------------------------

def _p9(d, pass1):
    tmp0 = _dc_in(d[0], pass1)
    z1, z2, z3 = d[2], d[4], d[6]
    t3 = z3 * _fix(0.707106781)
    t1 = tmp0 + t3
    t2 = tmp0 - t3 - t3
    t0 = (z1 - z2) * _fix(0.707106781)
    tmp11 = t2 + t0
    tmp14 = t2 - t0 - t0
    t0 = (z1 + z2) * _fix(1.328926049)
    t2b = z1 * _fix(1.083350441)
    t3b = z2 * _fix(0.245575608)
    tmp10 = t1 + t0 - t3b
    tmp12 = t1 - t0 + t2b
    tmp13 = t1 - t2b + t3b
    z1, z2, z3, z4 = d[1], d[3], d[5], d[7]
    z2 = z2 * (-_fix(1.224744871))
    t2 = (z1 + z3) * _fix(0.909038955)
    t3 = (z1 + z4) * _fix(0.483689525)
    t0 = t2 + t3 - z2
    t1 = (z3 - z4) * _fix(1.392728481)
    t2 = t2 + z2 - t1
    t3 = t3 + z2 + t1
    t1 = (z1 - z3 - z4) * _fix(1.224744871)
    return _finish([tmp10 + t0, tmp11 + t1, tmp12 + t2, tmp13 + t3,
                    tmp14, tmp13 - t3, tmp12 - t2, tmp11 - t1,
                    tmp10 - t0], pass1)


def _p10(d, pass1):
    z3 = _dc_in(d[0], pass1)
    z4 = d[4]
    z1 = z4 * _fix(1.144122806)
    z2 = z4 * _fix(0.437016024)
    tmp10 = z3 + z1
    tmp11 = z3 - z2
    tmp22_big = z3 - ((z1 - z2) << 1)          # rows 2/7 even part
    z2 = d[2]
    z3e = d[6]
    z1 = (z2 + z3e) * _fix(0.831253876)
    tmp12 = z1 + z2 * _fix(0.513743148)
    tmp13 = z1 - z3e * _fix(2.176250899)
    tmp20 = tmp10 + tmp12
    tmp24 = tmp10 - tmp12
    tmp21 = tmp11 + tmp13
    tmp23 = tmp11 - tmp13
    z1, z2, z3o, z4 = d[1], d[3], d[5], d[7]
    tmp11o = z2 + z4
    tmp13o = z2 - z4
    tmp12o = tmp13o * _fix(0.309016994)
    z5 = z3o << CONST_BITS
    z2 = tmp11o * _fix(0.951056516)
    z4b = z5 + tmp12o
    tmp10o = z1 * _fix(1.396802247) + z2 + z4b
    tmp14o = z1 * _fix(0.221231742) - z2 + z4b
    z2 = tmp11o * _fix(0.587785252)
    z4b = z5 - tmp12o - (tmp13o << (CONST_BITS - 1))
    tmp11b = z1 * _fix(1.260073511) - z2 - z4b
    tmp13b = z1 * _fix(0.642039522) - z2 + z4b
    n1 = CONST_BITS - PASS1_BITS
    n2 = CONST_BITS + PASS1_BITS + 3
    if pass1:
        # rows 2/7 finish early: both terms already at PASS1 scale
        o2a = _sh(tmp22_big, n1)
        o2b = (z1 - tmp13o - z3o) << PASS1_BITS
        return [_sh(tmp20 + tmp10o, n1), _sh(tmp21 + tmp11b, n1),
                o2a + o2b,
                _sh(tmp23 + tmp13b, n1), _sh(tmp24 + tmp14o, n1),
                _sh(tmp24 - tmp14o, n1), _sh(tmp23 - tmp13b, n1),
                o2a - o2b,
                _sh(tmp21 - tmp11b, n1), _sh(tmp20 - tmp10o, n1)]
    o2b = ((z1 - tmp13o) << CONST_BITS) - z5
    return [_sh(tmp20 + tmp10o, n2), _sh(tmp21 + tmp11b, n2),
            _sh(tmp22_big + o2b, n2),
            _sh(tmp23 + tmp13b, n2), _sh(tmp24 + tmp14o, n2),
            _sh(tmp24 - tmp14o, n2), _sh(tmp23 - tmp13b, n2),
            _sh(tmp22_big - o2b, n2),
            _sh(tmp21 - tmp11b, n2), _sh(tmp20 - tmp10o, n2)]


_EXPANDED = {9: _p9, 10: _p10}


def idct_expanded(coeffs: torch.Tensor, qtbl: torch.Tensor,
                  size: int) -> torch.Tensor:
    """NxN expanded IDCT for N in 9..16: 8 -> N point 1-D kernels."""
    p = _EXPANDED[size]
    x = coeffs.to(torch.int32) * qtbl.to(torch.int32)
    cols = [x[..., k, :] for k in range(8)]            # (..., 8) each
    rows = p(cols, True)                               # N x (..., 8)
    y = torch.stack(rows, dim=-2)                       # (..., N, 8)
    ins = [y[..., :, k] for k in range(8)]
    outs = p(ins, False)
    return _range_limit(torch.stack(outs, dim=-1))      # (..., N, N)


def _p11(d, pass1):
    tmp10 = _dc_in(d[0], pass1)
    z1, z2, z3 = d[2], d[4], d[6]
    tmp20 = (z2 - z3) * _fix(2.546640132)
    tmp23 = (z2 - z1) * _fix(0.430815045)
    z4 = z1 + z3
    tmp24 = z4 * (-_fix(1.155664402))
    z4 = z4 - z2
    tmp25 = tmp10 + z4 * _fix(1.356927976)
    tmp21 = tmp20 + tmp23 + tmp25 - z2 * _fix(1.821790775)
    tmp20 = tmp20 + tmp25 + z3 * _fix(2.115825087)
    tmp23 = tmp23 + tmp25 - z1 * _fix(1.513598477)
    tmp24 = tmp24 + tmp25
    tmp22 = tmp24 - z3 * _fix(0.788749120)
    tmp24 = tmp24 + z2 * _fix(1.944413522) - z1 * _fix(1.390975730)
    tmp25 = tmp10 - z4 * _fix(1.414213562)
    z1, z2, z3, z4 = d[1], d[3], d[5], d[7]
    t11 = z1 + z2
    t14 = (t11 + z3 + z4) * _fix(0.398430003)
    t11 = t11 * _fix(0.887983902)
    t12 = (z1 + z3) * _fix(0.670361295)
    t13 = t14 + (z1 + z4) * _fix(0.366151574)
    t10 = t11 + t12 + t13 - z1 * _fix(0.923107866)
    zz = t14 - (z2 + z3) * _fix(1.163011579)
    t11 = t11 + zz + z2 * _fix(2.073276588)
    t12 = t12 + zz - z3 * _fix(1.192193623)
    zz = (z2 + z4) * (-_fix(1.798248910))
    t11 = t11 + zz
    t13 = t13 + zz + z4 * _fix(2.102458632)
    t14 = (t14 + z2 * (-_fix(1.467221301))
           + z3 * _fix(1.001388905) - z4 * _fix(1.684843907))
    return _finish([tmp20 + t10, tmp21 + t11, tmp22 + t12, tmp23 + t13,
                    tmp24 + t14, tmp25, tmp24 - t14, tmp23 - t13,
                    tmp22 - t12, tmp21 - t11, tmp20 - t10], pass1)


def _p12(d, pass1):
    z3 = _dc_in(d[0], pass1)
    z4 = d[4] * _fix(1.224744871)
    tmp10 = z3 + z4
    tmp11 = z3 - z4
    z1s = d[2] * _fix(1.366025404)
    z1 = d[2] << CONST_BITS
    z2 = d[6] << CONST_BITS
    t12 = z1 - z2
    tmp21 = z3 + t12
    tmp24 = z3 - t12
    t12 = z1s + z2
    tmp20 = tmp10 + t12
    tmp25 = tmp10 - t12
    t12 = z1s - z1 - z2
    tmp22 = tmp11 + t12
    tmp23 = tmp11 - t12
    z1, z2, z3o, z4 = d[1], d[3], d[5], d[7]
    t11 = z2 * _fix(1.306562965)
    t14 = z2 * (-_fix(0.541196100))
    t10 = z1 + z3o
    t15 = (t10 + z4) * _fix(0.860918669)
    t12 = t15 + t10 * _fix(0.261052384)
    t10 = t12 + t11 + z1 * _fix(0.280143716)
    t13 = (z3o + z4) * (-_fix(1.045510580))
    t12 = t12 + t13 + t14 - z3o * _fix(1.478575242)
    t13 = t13 + t15 - t11 + z4 * _fix(1.586706681)
    t15 = (t15 + t14 - z1 * _fix(0.676326758)
           - z4 * _fix(1.982889723))
    za = z1 - z4
    zb = z2 - z3o
    zc = (za + zb) * _fix(0.541196100)
    t11 = zc + za * _fix(0.765366865)
    t14 = zc - zb * _fix(1.847759065)
    return _finish([tmp20 + t10, tmp21 + t11, tmp22 + t12, tmp23 + t13,
                    tmp24 + t14, tmp25 + t15, tmp25 - t15, tmp24 - t14,
                    tmp23 - t13, tmp22 - t12, tmp21 - t11,
                    tmp20 - t10], pass1)


_EXPANDED[11] = _p11
_EXPANDED[12] = _p12


def _p13(d, pass1):
    z1 = _dc_in(d[0], pass1)
    z2, z3, z4 = d[2], d[4], d[6]
    t10 = z3 + z4
    t11 = z3 - z4
    t12 = t10 * _fix(1.155388986)
    t13 = t11 * _fix(0.096834934) + z1
    tmp20 = z2 * _fix(1.373119086) + t12 + t13
    tmp22 = z2 * _fix(0.501487041) - t12 + t13
    t12 = t10 * _fix(0.316450131)
    t13 = t11 * _fix(0.486914739) + z1
    tmp21 = z2 * _fix(1.058554052) - t12 + t13
    tmp25 = z2 * (-_fix(1.252223920)) + t12 + t13
    t12 = t10 * _fix(0.435816023)
    t13 = t11 * _fix(0.937303064) - z1
    tmp23 = z2 * (-_fix(0.170464608)) - t12 - t13
    tmp24 = z2 * (-_fix(0.803364869)) + t12 - t13
    tmp26 = (t11 - z2) * _fix(1.414213562) + z1
    z1, z2, z3, z4 = d[1], d[3], d[5], d[7]
    t11 = (z1 + z2) * _fix(1.322312651)
    t12 = (z1 + z3) * _fix(1.163874945)
    t15 = z1 + z4
    t13 = t15 * _fix(0.937797057)
    t10 = t11 + t12 + t13 - z1 * _fix(2.020082300)
    t14 = (z2 + z3) * (-_fix(0.338443458))
    t11 = t11 + t14 + z2 * _fix(0.837223564)
    t12 = t12 + t14 - z3 * _fix(1.572116027)
    t14 = (z2 + z4) * (-_fix(1.163874945))
    t11 = t11 + t14
    t13 = t13 + t14 + z4 * _fix(2.205608352)
    t14 = (z3 + z4) * (-_fix(0.657217813))
    t12 = t12 + t14
    t13 = t13 + t14
    t15 = t15 * _fix(0.338443458)
    t14 = (t15 + z1 * _fix(0.318774355)
           - z2 * _fix(0.466105296))
    zz = (z3 - z2) * _fix(0.937797057)
    t14 = t14 + zz
    t15 = (t15 + zz + z3 * _fix(0.384515595)
           - z4 * _fix(1.742345811))
    return _finish([tmp20 + t10, tmp21 + t11, tmp22 + t12, tmp23 + t13,
                    tmp24 + t14, tmp25 + t15, tmp26, tmp25 - t15,
                    tmp24 - t14, tmp23 - t13, tmp22 - t12, tmp21 - t11,
                    tmp20 - t10], pass1)


def _p14(d, pass1):
    z1 = _dc_in(d[0], pass1)
    z4 = d[4]
    z2 = z4 * _fix(1.274162392)
    z3 = z4 * _fix(0.314692123)
    z4 = z4 * _fix(0.881747734)
    tmp10 = z1 + z2
    tmp11 = z1 + z3
    tmp12 = z1 - z4
    tmp23_big = z1 - ((z2 + z3 - z4) << 1)     # rows 3/10 even part
    z1e, z2e = d[2], d[6]
    z3 = (z1e + z2e) * _fix(1.105676686)
    t13 = z3 + z1e * _fix(0.273079590)
    t14 = z3 - z2e * _fix(1.719280954)
    t15 = z1e * _fix(0.613604268) - z2e * _fix(1.378756276)
    tmp20 = tmp10 + t13
    tmp26 = tmp10 - t13
    tmp21 = tmp11 + t14
    tmp25 = tmp11 - t14
    tmp22 = tmp12 + t15
    tmp24 = tmp12 - t15
    z1, z2, z3, z4 = d[1], d[3], d[5], d[7]
    z4s = z4 << CONST_BITS
    t14 = z1 + z3
    t11 = (z1 + z2) * _fix(1.334852607)
    t12 = t14 * _fix(1.197448846)
    t10 = t11 + t12 + z4s - z1 * _fix(1.126980169)
    t14 = t14 * _fix(0.752406978)
    t16 = t14 - z1 * _fix(1.061150426)
    z1m = z1 - z2
    t15 = z1m * _fix(0.467085129) - z4s
    t16 = t16 + t15
    t13o = (z2 + z3) * (-_fix(0.158341681)) - z4s
    t11 = t11 + t13o - z2 * _fix(0.424103948)
    t12 = t12 + t13o - z3 * _fix(2.373959773)
    t13o = (z3 - z2) * _fix(1.405321284)
    t14 = t14 + t13o + z4s - z3 * _fix(1.6906431334)
    t15 = t15 + t13o + z2 * _fix(0.674957567)
    n1 = CONST_BITS - PASS1_BITS
    n2 = CONST_BITS + PASS1_BITS + 3
    if pass1:
        o3a = _sh(tmp23_big, n1)
        o3b = (z1m + z4 - z3) << PASS1_BITS
        return [_sh(tmp20 + t10, n1), _sh(tmp21 + t11, n1),
                _sh(tmp22 + t12, n1), o3a + o3b,
                _sh(tmp24 + t14, n1), _sh(tmp25 + t15, n1),
                _sh(tmp26 + t16, n1), _sh(tmp26 - t16, n1),
                _sh(tmp25 - t15, n1), _sh(tmp24 - t14, n1),
                o3a - o3b, _sh(tmp22 - t12, n1),
                _sh(tmp21 - t11, n1), _sh(tmp20 - t10, n1)]
    o3b = ((z1m - z3) << CONST_BITS) + z4s
    return [_sh(tmp20 + t10, n2), _sh(tmp21 + t11, n2),
            _sh(tmp22 + t12, n2), _sh(tmp23_big + o3b, n2),
            _sh(tmp24 + t14, n2), _sh(tmp25 + t15, n2),
            _sh(tmp26 + t16, n2), _sh(tmp26 - t16, n2),
            _sh(tmp25 - t15, n2), _sh(tmp24 - t14, n2),
            _sh(tmp23_big - o3b, n2), _sh(tmp22 - t12, n2),
            _sh(tmp21 - t11, n2), _sh(tmp20 - t10, n2)]


_EXPANDED[13] = _p13
_EXPANDED[14] = _p14


def _p15(d, pass1):
    z1 = _dc_in(d[0], pass1)
    z2, z3, z4 = d[2], d[4], d[6]
    t10 = z4 * _fix(0.437016024)
    t11 = z4 * _fix(1.144122806)
    t12 = z1 - t10
    t13 = z1 + t11
    z1c = z1 - ((t11 - t10) << 1)
    z4e = z2 - z3
    z3e = z3 + z2
    t10 = z3e * _fix(1.337628990)
    t11 = z4e * _fix(0.045680613)
    z2e = z2 * _fix(1.439773946)
    tmp20 = t13 + t10 + t11
    tmp23 = t12 - t10 + t11 + z2e
    t10 = z3e * _fix(0.547059574)
    t11 = z4e * _fix(0.399234004)
    tmp25 = t13 - t10 - t11
    tmp26 = t12 + t10 - t11 - z2e
    t10 = z3e * _fix(0.790569415)
    t11 = z4e * _fix(0.353553391)
    tmp21 = t12 + t10 + t11
    tmp24 = t13 - t10 + t11
    t11 = t11 + t11
    tmp22 = z1c + t11
    tmp27 = z1c - t11 - t11
    z1, z2 = d[1], d[3]
    z3 = d[5] * _fix(1.224744871)
    z4 = d[7]
    t13 = z2 - z4
    t15 = (z1 + t13) * _fix(0.831253876)
    t11 = t15 + z1 * _fix(0.513743148)
    t14 = t15 - t13 * _fix(2.176250899)
    t13 = z2 * (-_fix(0.831253876))
    t15 = z2 * (-_fix(1.344997024))
    z2o = z1 - z4
    t12 = z3 + z2o * _fix(1.406466353)
    t10 = t12 + z4 * _fix(2.457431844) - t15
    t16 = t12 - z1 * _fix(1.112434820) + t13
    t12 = z2o * _fix(1.224744871) - z3
    zz = (z1 + z4) * _fix(0.575212477)
    t13 = t13 + zz + z1 * _fix(0.475753014) - z3
    t15 = t15 + zz - z4 * _fix(0.869244010) + z3
    return _finish([tmp20 + t10, tmp21 + t11, tmp22 + t12, tmp23 + t13,
                    tmp24 + t14, tmp25 + t15, tmp26 + t16, tmp27,
                    tmp26 - t16, tmp25 - t15, tmp24 - t14, tmp23 - t13,
                    tmp22 - t12, tmp21 - t11, tmp20 - t10], pass1)


def _p16(d, pass1):
    tmp0 = _dc_in(d[0], pass1)
    z1 = d[4]
    t1 = z1 * _fix(1.306562965)
    t2 = z1 * _fix(0.541196100)
    tmp10 = tmp0 + t1
    tmp11 = tmp0 - t1
    tmp12 = tmp0 + t2
    tmp13 = tmp0 - t2
    z1, z2 = d[2], d[6]
    z3 = z1 - z2
    z4 = z3 * _fix(0.275899379)
    z3 = z3 * _fix(1.387039845)
    e0 = z3 + z2 * _fix(2.562915447)
    e1 = z4 + z1 * _fix(0.899976223)
    e2 = z3 - z1 * _fix(0.601344887)
    e3 = z4 - z2 * _fix(0.509795579)
    tmp20 = tmp10 + e0
    tmp27 = tmp10 - e0
    tmp21 = tmp12 + e1
    tmp26 = tmp12 - e1
    tmp22 = tmp13 + e2
    tmp25 = tmp13 - e2
    tmp23 = tmp11 + e3
    tmp24 = tmp11 - e3
    z1, z2, z3, z4 = d[1], d[3], d[5], d[7]
    t11 = z1 + z3
    o1 = (z1 + z2) * _fix(1.353318001)
    o2 = t11 * _fix(1.247225013)
    o3 = (z1 + z4) * _fix(1.093201867)
    o10 = (z1 - z4) * _fix(0.897167586)
    o11 = t11 * _fix(0.666655658)
    o12 = (z1 - z2) * _fix(0.410524528)
    o0 = o1 + o2 + o3 - z1 * _fix(2.286341144)
    o13 = o10 + o11 + o12 - z1 * _fix(1.835730603)
    zz = (z2 + z3) * _fix(0.138617169)
    o1 = o1 + zz + z2 * _fix(0.071888074)
    o2 = o2 + zz - z3 * _fix(1.125726048)
    zz = (z3 - z2) * _fix(1.407403738)
    o11 = o11 + zz - z3 * _fix(0.766367282)
    o12 = o12 + zz + z2 * _fix(1.971951411)
    z24 = z2 + z4
    zz = z24 * (-_fix(0.666655658))
    o1 = o1 + zz
    o3 = o3 + zz + z4 * _fix(1.065388962)
    zz = z24 * (-_fix(1.247225013))
    o10 = o10 + zz + z4 * _fix(3.141271809)
    o12 = o12 + zz
    zz = (z3 + z4) * (-_fix(1.353318001))
    o2 = o2 + zz
    o3 = o3 + zz
    zz = (z4 - z3) * _fix(0.410524528)
    o10 = o10 + zz
    o11 = o11 + zz
    return _finish([tmp20 + o0, tmp21 + o1, tmp22 + o2, tmp23 + o3,
                    tmp24 + o10, tmp25 + o11, tmp26 + o12, tmp27 + o13,
                    tmp27 - o13, tmp26 - o12, tmp25 - o11, tmp24 - o10,
                    tmp23 - o3, tmp22 - o2, tmp21 - o1,
                    tmp20 - o0], pass1)


_EXPANDED[15] = _p15
_EXPANDED[16] = _p16
