"""12-bit encode (precision=12, uint16 samples) of the port against the JAX
package on the CPU, bit for bit: the colour conversions, p1 with each DCT
with and without deringing (whose headroom numerator goes negative at 12
bits), the norm sums and AC-first histograms at 12-bit magnitudes, the AC
trellis's plain version at kmax 14 / maxq 16383 against the XLA
_trellis_ac_t (sparse, dense, all-zero, tie-heavy and wrapping inputs),
the DC trellis at maxq 16383, and encode_many / encode of three
configurations. The JAX oracle compiles once per configuration and image
shape (10-30 s each), so the streams come from one module-scoped fixture
on one aligned geometry, and an unaligned one for the FASTEST profile,
whose program has no trellis and compiles fastest. (The float DCT at 12
bits is held here through p1, and end to end at 4:4:4 by the card's
tests against the CPU path.)"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import pipeline_t as jpt
from mozjpeg_tpu.codec import trellis as jtr
from mozjpeg_tpu.codec.config import EncoderConfig as JCfg
from mozjpeg_tpu.codec.encoder import make_qtables
from mozjpeg_tpu.codec.pipeline import geometry as jgeometry
from mozjpeg_tpu.ops import color as jcolor
from mozjpeg_tpu.ops import dering as jdering
from mozjpeg_tpu.ops import symbols as jsymbols
from mozjpeg_tpu_torch.codec import pipeline_t as tpt
from mozjpeg_tpu_torch.codec import trellis as ttr
from mozjpeg_tpu_torch.ops import color as tcolor
from mozjpeg_tpu_torch.ops import dering as tdering
from mozjpeg_tpu_torch.ops import symbols as tsymbols
from mozjpeg_tpu_torch.ops import trellis_ac as tac
from test_torch_trellis import _rand_ac_si

WRAP = 46341          # the least |x| whose square passes int32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _as_u16(t: torch.Tensor) -> np.ndarray:
    """The port's int32 12-bit samples as the JAX package's uint16."""
    a = t.numpy()
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() <= 4095
    return a.astype(np.uint16)


def photo12(h, w, seed, c=3):
    """Seeded photo-like 12-bit samples: gradients, a hard edge, a clipped
    white patch (drives the deringing), noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([4095 * xx / w, 4095 * yy / h,
                    2048 + 1400 * np.sin((xx + 2 * yy) / 5.0),
                    4095 - 60.0 * xx][:c], -1)
    img[: h // 2, w // 2:] = r.uniform(0, 4095, c)
    img[h // 4:h // 2, w // 5:w // 2] = 4095
    img += r.normal(0, 140, img.shape)
    return np.clip(img, 0, 4095).astype(np.uint16)


def test_colour_conversions_at_12_bits():
    rng = np.random.default_rng(1)
    px = rng.integers(0, 4096, (37, 4)).astype(np.uint16)
    px[:4] = [[0, 0, 0, 0], [4095, 4095, 4095, 4095], [4095, 0, 0, 4095],
              [0, 4095, 4095, 0]]
    t32 = _t(px.astype(np.int32))
    _eq(_as_u16(tcolor.rgb_to_ycc(t32, 12)),
        jcolor.rgb_to_ycc(jnp.asarray(px[:, :3]), 12))
    _eq(_as_u16(tcolor.cmyk_to_ycck(t32, 12)),
        jcolor.cmyk_to_ycck(jnp.asarray(px), 12))
    _eq(_as_u16(tcolor.ycc_to_rgb(t32[:, :3], 12)),
        jcolor.ycc_to_rgb(jnp.asarray(px[:, :3]), 12))
    _eq(_as_u16(tcolor.ycck_to_cmyk(t32, 12)),
        jcolor.ycck_to_cmyk(jnp.asarray(px), 12))
    # JAX's rgb_to_gray casts to uint8 at every precision
    _eq(tcolor.rgb_to_gray(t32[:, :3], 12).to(torch.uint8),
        jcolor.rgb_to_gray(jnp.asarray(px[:, :3])))
    # the uint16 upload keeps all 16 bits
    _eq(_as_u16(tpt.to_samples(px, "cpu")), px)


def test_dering_at_12_bits_negative_headroom():
    """12-bit centred samples mark most bright pixels as clipped (the
    threshold stays the 8-bit 127), so 127*64 - sum goes negative and the
    truncating division must hold."""
    rng = np.random.default_rng(2)
    zz = rng.integers(-2048, 2048, (64, 300)).astype(np.int32)
    zz[:, :100] = np.maximum(zz[:, :100], 127 * (rng.random((64, 100))
                                                 < 0.5))
    zz[:, 100:110] = 2047
    m = zz >= 127
    num = 127 * 64 - zz.sum(0)
    assert ((num < 0) & (m.sum(0) > 0) & (m.sum(0) < 64)).sum() > 50
    assert ((num % np.maximum(m.sum(0), 1)) != 0).any()
    for q0 in (1, 16, 200):
        _eq(tdering.dering_t(_t(zz), q0),
            jdering.dering_t(jnp.asarray(zz), jnp.int32(q0)))
        f = zz.astype(np.float32)
        _eq(tdering.dering_float_t(_t(f), q0),
            jdering.dering_float_t(jnp.asarray(f), jnp.int32(q0)))


def test_norm_seq_and_histograms_at_12_bit_magnitudes():
    rng = np.random.default_rng(3)
    raw = rng.integers(-131072, 131072, (64, 400)).astype(np.int32)
    raw[rng.random(raw.shape) < 0.3] = 0
    _eq(tpt.norm_seq(_t(raw)), jax.jit(jpt._norm_seq)(jnp.asarray(raw)))
    q = (rng.integers(-16383, 16384, (64, 2 * 90))
         >> rng.integers(0, 14, (64, 2 * 90))).astype(np.int16)
    q[rng.random(q.shape) < 0.6] = 0
    q[1:, 5:40] = 0                                   # EOB runs
    assert np.abs(q).max() >= 8192                    # size 14 symbols
    hist = jax.jit(jsymbols.ac_first_histogram_t, static_argnames="ri")
    for ri in (0, 7):
        got = tsymbols.ac_first_histograms_t(_t(q), 2, ri)
        for i in range(2):
            _eq(got[i], hist(jnp.asarray(q[:, i * 90:(i + 1) * 90]), ri=ri))


@pytest.mark.parametrize("dctm,dering", [
    ("islow", True), ("islow", False), ("ifast", True), ("float", True)])
def test_p1_at_12_bits_matches_run_p1_batch(dctm, dering):
    """p1 at 12 bits (level shift 2048, PASS1_BITS 1, the post-dering
    clamp +-16383) against pipeline_t.run_p1_batch on an unaligned B=2
    batch of 12-bit gray planes with clipped-white patches."""
    h, w = 21, 30
    imgs = np.stack([photo12(h, w, s, 1)[..., 0] for s in (1, 2)])
    cs, samps, slots, smooth = "grayscale", [(1, 1)], (0,), 0
    qt = make_qtables(JCfg(quality=[70, 50], precision=12).resolved())
    _, _, comps = jgeometry(w, h, samps)
    ris = tuple(2 * g.bw for g in comps)
    _, merged_j, small_j = jpt.run_p1_batch(
        imgs, samps, qt, dering, 12, ris, smooth, dctm, cs, slots)
    geom = jgeometry(w, h, samps)
    merged, small, _ = tpt.p1_batch(tpt.to_samples(imgs, "cpu"), geom, cs,
                                    qt, slots, dering, dctm, ris, smooth, 12)
    for (q, r), (qj, rj) in zip(merged, merged_j):
        _eq(q, qj)
        _eq(r, rj)
    _eq(small, small_j)


@functools.lru_cache(maxsize=None)
def _xla_trellis_ac():
    return jax.jit(jtr._trellis_ac_t,
                   static_argnames=("Ss", "Se", "kmax", "maxq"))


def _ac12(kind, n_img=32, b=2, seed=21):
    """AC trellis inputs at 12-bit magnitudes (raw is the FDCT output x8,
    up to 8 * 16383 * 8 q)."""
    rng = np.random.default_rng(seed)
    n = b * n_img
    lam = (rng.random(n) * 4 + 0.01).astype(np.float32)
    qtbl = rng.integers(1, 80, 64).astype(np.int32)
    if kind == "tie":                 # integer costs: q = 1, lambda 1/64
        qtbl = np.ones(64, np.int32)
        vals = np.array([0, 8, 64, 512, 4096, 32768, 131040], np.int32)
        raw = vals[rng.integers(0, len(vals), (64, n))]
        lam = np.full(n, 1 / 64, np.float32)
    elif kind in ("dense", "wrap"):
        qtbl = rng.integers(1, 5 if kind == "dense" else 40, 64) \
            .astype(np.int32)
        q8 = (qtbl << 3)[:, None]
        qv = rng.integers(1, 17000, (64, n))
        raw = qv * q8 + rng.integers(-(q8 >> 1), q8 >> 1, (64, n))
    elif kind == "zero":
        raw = np.zeros((64, n), np.int64)
    else:                             # sparse
        raw = rng.integers(-60000, 60000, (64, n))
        raw[rng.random(raw.shape) < 0.9] = 0
    raw = (raw * rng.choice([-1, 1], (64, n))).astype(np.int32)
    qcoef = rng.integers(-50, 50, (64, n)).astype(np.int16)
    ac_si = np.stack([_rand_ac_si(rng), _rand_ac_si(rng, zrl_zero=True)])
    return raw, qcoef, qtbl, ac_si, lam


@pytest.mark.parametrize("kind", ["sparse", "dense", "zero", "tie", "wrap"])
def test_trellis_ac_plain_kmax14_matches_xla(kind):
    """trellis_ac_plain(kmax=14, maxq=16383) against the JAX package's
    12-bit AC trellis (_trellis_ac_t at kmax 14), with int32 squares that
    wrap in both (|raw| past 46,341) and the clamp at 16383."""
    n_img = 32
    raw, qcoef, qtbl, ac_si, lam = _ac12(kind, n_img)
    if kind in ("sparse", "wrap"):
        assert (np.abs(raw[1:]) >= WRAP).any()
    if kind == "wrap":
        q8 = (qtbl << 3)[:, None]
        assert ((np.abs(raw) + (q8 >> 1)) // q8 > 16383).any()
    want = _xla_trellis_ac()(jnp.asarray(raw), jnp.asarray(qcoef),
                             jnp.asarray(qtbl), jnp.asarray(ac_si),
                             jnp.asarray(lam), Ss=1, Se=63, kmax=14,
                             maxq=16383)
    nb, _ = tac.trellis_ac(_t(raw), _t(qtbl),
                           _t(ttr.recip2_table()[qtbl]),
                           ttr.rate_lut(_t(ac_si), 14), _t(lam), 1, 63,
                           n_img, 14, 16383)
    pos = torch.arange(64)[:, None]
    _eq(torch.where(pos >= 1, nb.to(torch.int16), _t(qcoef)), want)
    if kind != "zero":
        assert np.abs(np.asarray(want)[1:]).max() > 1023


def test_ac_example_inputs_at_12_bits():
    """The smoke run's 12-bit kernel inputs reach the wrap and the long
    bit lengths, and the 8-bit ones are what they were."""
    for kind in ("dense", "sparse", "tie"):
        raw, qtbl, _, luts, _ = ttr.ac_example_inputs(kind, 2, 40,
                                                       precision=12)
        q8 = (qtbl << 3)[:, None]
        qval = np.minimum((np.abs(raw) + (q8 >> 1)) // q8, 16383)
        assert luts.shape == (2, 128, 16)
        if kind != "sparse":
            assert qval[1:].max() >= 8192
        if kind != "tie":
            assert (np.abs(raw[1:]) >= WRAP).any()
        assert (luts[:, :64, 13] < ttr._ac.BIGF).any()
        assert (luts[:, :, 14:] >= ttr._ac.BIGF).all()
    raw8, *_, luts8, _ = ttr.ac_example_inputs("dense", 2, 40)
    assert np.abs(raw8[1:]).max() < WRAP
    assert (luts8[:, :, 10:] >= ttr._ac.BIGF).all()
    with pytest.raises(ValueError, match="instantiation"):
        tac.trellis_ac(*(_t(a) for a in ttr.ac_example_inputs(
            "sparse", 1, 8)[:5]), 1, 63, 8, 12, 4095)


@pytest.mark.parametrize("q0", [1, 8])
def test_dc_trellis_rows_at_maxq_16383(q0):
    rng = np.random.default_rng(9 + q0)
    r, l = 5, 36
    raw = rng.integers(-131072, 131072, (r, l)).astype(np.int32)
    raw[:, 3] = 131071                          # qval 16384: clamped
    lam = (rng.random((r, l)) * 0.01).astype(np.float32)
    last = rng.integers(-16000, 16000, r).astype(np.int32)
    dc_si = np.zeros(256, np.int32)
    dc_si[:16] = rng.integers(2, 14, 16)
    nc = ttr.get_num_dc_candidates(q0)
    got, fin = ttr.trellis_dc_rows(_t(raw), _t(last), q0, _t(dc_si),
                                   _t(lam), nc, maxq=16383)
    want, wfin = jtr.trellis_dc_rows(
        jnp.asarray(raw), jnp.asarray(last), jnp.int32(q0),
        jnp.asarray(dc_si), jnp.asarray(lam), nc, 16383)
    _eq(got, want)
    _eq(fin, wfin)
    if q0 == 1:
        assert np.abs(np.asarray(want)).max() == 16383


IMG_A = photo12(48, 64, 1)          # aligned to the 4:2:0 iMCU
IMG_B = photo12(29, 37, 3)          # unaligned

CONFIGS = {
    "default": ([IMG_A], dict(quality=75, precision=12)),
    "fastest": ([IMG_A, IMG_B], dict(quality=75, precision=12,
                                     profile="FASTEST")),
    "grayscale": ([IMG_A[..., 0]], dict(quality=75, precision=12)),
}


def _cfg(pkg, kw):
    kw = dict(kw)
    if "profile" in kw:
        kw["profile"] = pkg.Profile[kw["profile"]]
    if "dct_method" in kw:
        kw["dct_method"] = pkg.DCTMethod[kw["dct_method"]]
    return pkg.EncoderConfig(**kw)


# tables whose AC entries pass 255 (16-bit DQT entries); the JAX program
# compiled for FASTEST takes them as arguments
WIDE_TABLES = [np.where(np.arange(64) == 0, 8, 40 + 9 * np.arange(64))] * 2


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX package's streams of every configuration (one compile
    each), and of FASTEST with WIDE_TABLES."""
    out = {name: mj.encode_many(imgs, _cfg(mj, kw))
           for name, (imgs, kw) in CONFIGS.items()}
    out["wide"] = mj.encode_many([IMG_A], mj.EncoderConfig(
        quality=50, precision=12, base_quant_tables=WIDE_TABLES,
        profile=mj.Profile.FASTEST))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_many_12_bit_matches_jax(jax_streams, name):
    imgs, kw = CONFIGS[name]
    got = mjt.encode_many(imgs, _cfg(mjt, kw), device="cpu")
    assert got == jax_streams[name]
    sof = b"\xff\xc1" if name == "fastest" else b"\xff\xc2"
    assert all(sof in g and b"\xff\xc0" not in g for g in got)


def test_encode_12_bit_matches_jax(jax_streams):
    """encode() of one image routes to encode_many on the CPU at 12 bits
    (the host engine is 8-bit only, as the JAX package's)."""
    imgs, kw = CONFIGS["fastest"]
    assert mjt.encode(imgs[-1], _cfg(mjt, kw), device="cpu") \
        == jax_streams["fastest"][-1]


def test_16_bit_quant_tables_and_refusals(jax_streams):
    """Tables past 255 go out as 16-bit DQT entries (Pq 1); uint16
    samples at 8 bits and other sample types are refused."""
    got = mjt.encode_many([IMG_A], mjt.EncoderConfig(
        quality=50, precision=12, base_quant_tables=WIDE_TABLES,
        profile=mjt.Profile.FASTEST), device="cpu")
    assert got == jax_streams["wide"]
    dqt = got[0].index(b"\xff\xdb")
    assert got[0][dqt + 4] >> 4 == 1
    with pytest.raises(ValueError, match="precision=12"):
        mjt.encode_many([IMG_A], mjt.EncoderConfig(quality=75),
                        device="cpu")
    with pytest.raises(ValueError, match="uint8 or uint16"):
        mjt.encode_many([IMG_A.astype(np.float32)],
                        mjt.EncoderConfig(quality=75, precision=12),
                        device="cpu")
