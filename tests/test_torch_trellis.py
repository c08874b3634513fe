"""The port's trellis program against the JAX package's on the CPU, bit for
bit: the AC kernel's plain version against the Pallas kernel (interpret
mode) and the XLA formulation, the rate LUT, lambda, the DC trellis and
the whole per-component trellis program, with seeded numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mozjpeg_tpu.codec import trellis as jtr
from mozjpeg_tpu.codec.pipeline import geometry as jgeometry
from mozjpeg_tpu.ops import pallas_trellis as jpt
from mozjpeg_tpu.ops import softfloat as jsf
from mozjpeg_tpu_torch.codec import trellis as ttr
from mozjpeg_tpu_torch.ops import trellis_ac as tac


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rand_ac_si(rng, zrl_zero=False):
    """Plausible AC code-length tables with holes (as tests/test_ops.py)."""
    si = rng.integers(2, 17, size=256).astype(np.int32)
    si[rng.integers(0, 256, size=20)] = 0
    si[0x00] = int(rng.integers(2, 10))
    si[0xF0] = 0 if zrl_zero else int(rng.integers(4, 12))
    return si


def _ac_inputs(seed, n_img, b=2, tie=False):
    rng = np.random.default_rng(seed)
    n = b * n_img
    if tie:   # few magnitudes + power-of-two lambda: exact cost ties
        qtbl = np.clip(rng.integers(1, 32, 64), 1, 255).astype(np.int32)
        vals = np.array([0, 8, 16, 64, 256, 1024], np.int32)
        raw = (vals[rng.integers(0, len(vals), size=(64, n))]
               * rng.choice([-1, 1], size=(64, n))).astype(np.int32)
        lam = np.full(n, 2.0, np.float32)
    else:
        qtbl = np.clip(rng.integers(1, 100, size=64), 1, 255) \
            .astype(np.int32)
        raw = rng.integers(-12000, 12000, size=(64, n)).astype(np.int32)
        raw[rng.random(size=raw.shape) < 0.6] = 0
        lam = rng.random(n).astype(np.float32) * 4.0 + 0.01
    qcoef = rng.integers(-50, 50, size=(64, n)).astype(np.int16)
    ac_si = np.stack([_rand_ac_si(rng), _rand_ac_si(rng, zrl_zero=True)]
                     [:b])
    return raw, qcoef, qtbl, ac_si, lam


def _plain(raw, qtbl, ac_si, lam, ss, se, n_img):
    lut = ttr.rate_lut(_t(ac_si))
    ltbl = _t(ttr.recip2_table()[qtbl])
    return tac.trellis_ac(_t(raw), _t(qtbl), ltbl, lut, _t(lam), ss, se,
                          n_img)


@pytest.mark.parametrize("band,tie", [((1, 63), False), ((1, 8), False),
                                      ((1, 63), True)])
def test_plain_matches_pallas_kernel_both_outputs(band, tie):
    n_img = 512
    raw, _, qtbl, ac_si, lam = _ac_inputs(7, n_img, tie=tie)
    ss, se = band
    lut_j = jtr.rate_lut_dev(jnp.asarray(ac_si), ss, se, 10)
    nb_j, ei_j = jpt.trellis_ac_dp_pallas(
        jnp.asarray(raw), jnp.asarray(qtbl),
        jtr._ltbl_lookup(jnp.asarray(qtbl)), lut_j, jnp.asarray(lam),
        ss, se, n_img, True)
    nb, ei = _plain(raw, qtbl, ac_si, lam, ss, se, n_img)
    _eq(nb, nb_j)
    _eq(ei, ei_j)


@pytest.mark.parametrize("band", [(1, 8), (9, 63), (1, 63)])
def test_plain_matches_padded_pallas_and_xla(band):
    """n_img=300 exercises the Pallas caller's lane padding path."""
    n_img = 300
    raw, qcoef, qtbl, ac_si, lam = _ac_inputs(11, n_img)
    ss, se = band
    args = (jnp.asarray(raw), jnp.asarray(qcoef), jnp.asarray(qtbl))
    xla = jtr._trellis_ac_t(*args, jnp.asarray(ac_si), jnp.asarray(lam),
                            ss, se, kmax=10, maxq=1023)
    pallas = jtr._trellis_ac_pallas(
        *args, jtr.rate_lut_dev(jnp.asarray(ac_si), ss, se, 10),
        jnp.asarray(ac_si), jnp.asarray(lam), ss, se, interpret=True)
    nb, _ = _plain(raw, qtbl, ac_si, lam, ss, se, n_img)
    pos = torch.arange(64)[:, None]
    got = torch.where((pos >= ss) & (pos <= se), nb.to(torch.int16),
                      _t(qcoef))
    _eq(got, pallas)
    _eq(got, xla)


def test_plain_tie_break_stress_matches_xla():
    """The tie corpus of tests/test_ops.py (first-minimum (j, k) order)."""
    raw, qcoef, qtbl, ac_si, lam = _ac_inputs(99, 512, tie=True)
    ref = jtr._trellis_ac_t(jnp.asarray(raw), jnp.asarray(qcoef),
                            jnp.asarray(qtbl), jnp.asarray(ac_si),
                            jnp.asarray(lam), 1, 63, kmax=10, maxq=1023)
    nb, _ = _plain(raw, qtbl, ac_si, lam, 1, 63, 512)
    _eq(torch.where(torch.arange(64)[:, None] >= 1, nb.to(torch.int16),
                    _t(qcoef)), ref)


def test_trellis_ac_refuses_other_devices_and_bad_inputs():
    raw, _, qtbl, ac_si, lam = _ac_inputs(3, 8)
    lut = ttr.rate_lut(_t(ac_si))
    ltbl = _t(ttr.recip2_table()[qtbl])
    args = [_t(raw), _t(qtbl), ltbl, lut, _t(lam)]
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        tac.trellis_ac(*meta, 1, 63, 8)
    with pytest.raises(ValueError):
        tac.trellis_ac(args[0].to(torch.int64), *args[1:], 1, 63, 8)
    with pytest.raises(ValueError):
        tac.trellis_ac(*args, 1, 63, 7)


def test_rate_lut_matches_device_and_host_builders():
    rng = np.random.default_rng(3)
    ac_si = np.stack([_rand_ac_si(rng), _rand_ac_si(rng, zrl_zero=True)])
    got = ttr.rate_lut(_t(ac_si))
    _eq(got, jtr.rate_lut_dev(jnp.asarray(ac_si), 1, 63, 10))
    _eq(got, np.stack([jpt.build_rate_lut(a, 1, 63) for a in ac_si]))


@pytest.mark.parametrize("s1,s2", [(14.75, 16.5), (15.0, 14.0),
                                   (14.75, 0.0)])
def test_lambda_matches_host_and_softfloat(s1, s2):
    rng = np.random.default_rng(4)
    norms = np.concatenate([
        np.zeros(5, np.float32),
        rng.random(2000).astype(np.float32) * 1e4,
        rng.random(500).astype(np.float32) * 3e9,
        np.float32([1.0, 63.0, 3.4e38, 1e-30, 123456.789])])
    got = ttr.lambda_from_norm_t(_t(norms), s1, s2)
    _eq(got, jtr.lambda_from_norm(norms, s1, s2))
    _eq(got, jsf.lambda_from_norm_t(jnp.asarray(norms), s1=s1, s2=s2))


@pytest.mark.parametrize("tie", [False, True])
def test_dc_trellis_rows_match_jax(tie):
    rng = np.random.default_rng(8 + tie)
    r, l = 6, 40
    if tie:   # repeated DCs on the quant grid and a flat lambda
        raw = (rng.integers(-3, 4, (r, l)) * 64).astype(np.int32)
        lam = np.full((r, l), 0.5, np.float32)
    else:
        raw = rng.integers(-8000, 8000, (r, l)).astype(np.int32)
        lam = (rng.random((r, l)) * 0.01).astype(np.float32)
    last = rng.integers(-50, 50, r).astype(np.int32)
    dc_si = np.zeros(256, np.int32)
    dc_si[:12] = rng.integers(2, 10, 12)
    for q0 in (8, 2):
        nc = ttr.get_num_dc_candidates(q0)
        assert nc == jtr.get_num_dc_candidates(q0)
        got, fin = ttr.trellis_dc_rows(_t(raw), _t(last), q0, _t(dc_si),
                                       _t(lam), nc)
        want, wfin = jtr.trellis_dc_rows(
            jnp.asarray(raw), jnp.asarray(last), jnp.int32(q0),
            jnp.asarray(dc_si), jnp.asarray(lam), nc)
        _eq(got, want)
        _eq(fin, wfin)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_trellis_all_matches_make_trellis_all_t(use_pallas):
    """Every component of a B=2 4:2:0 batch (luma v=2 phases, an odd
    block-row count) against the JAX program, with the Pallas kernel in
    interpret mode and with the XLA formulation."""
    rng = np.random.default_rng(12)
    b = 2
    _, _, geoms = jgeometry(40, 40, [(2, 2), (1, 1), (1, 1)])
    raws, qs, lams, ac_sis, dc_sis, qzs, ncands = [], [], [], [], [], [], []
    for ci, g in enumerate(geoms):
        n = b * g.bh * g.bw
        raw = rng.integers(-6000, 6000, (64, n)).astype(np.int32)
        raw[rng.random(raw.shape) < 0.5] = 0
        raws.append(raw)
        qs.append(rng.integers(-30, 30, (64, n)).astype(np.int16))
        lams.append((rng.random(n) * 2 + 0.01).astype(np.float32))
        ac_sis.append(np.stack([_rand_ac_si(rng) for _ in range(b)]))
        si = np.zeros(256, np.int32)
        si[:12] = rng.integers(2, 10, 12)
        dc_sis.append(si)
        qz = np.clip(rng.integers(1, 60, 64), 1, 255).astype(np.int32)
        qzs.append(qz)
        ncands.append(jtr.get_num_dc_candidates(int(qz[0])))
    run = jtr.make_trellis_all_t(tuple(geoms), None, ((1, 63),), True,
                                 tuple(ncands), batch=b,
                                 use_pallas=use_pallas, interpret=use_pallas)
    packed = jnp.asarray(jtr.pack_trellis_inputs(lams, ac_sis, dc_sis, qzs))
    want = run(tuple(jnp.asarray(r) for r in raws),
               tuple(jnp.asarray(q) for q in qs), packed)
    got = ttr.trellis_all(tuple(geoms), [_t(r) for r in raws],
                          [_t(q) for q in qs], [_t(x) for x in lams],
                          [_t(a) for a in ac_sis], dc_sis, qzs, ncands,
                          batch=b)
    for g_, w_ in zip(got, want):
        _eq(g_, w_)
