"""The encode ops of the port's full 8-bit surface, each held bit-exact
against its JAX function on the CPU with seeded numpy inputs: padding,
colour conversion, the downsamplers and smoothers, the ifast and float
DCTs with their quantizers and rescales, float deringing, the restart-
segmented AC-first histograms, the EOB-run DP, the DC trellis's delta
weight, the band histograms, the device-prep p1 and the trellis program
over bands with the EOB DP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mozjpeg_tpu.codec import pipeline_t as jpt
from mozjpeg_tpu.codec import trellis as jtr
from mozjpeg_tpu.codec.config import EncoderConfig as JCfg
from mozjpeg_tpu.codec.encoder import make_qtables
from mozjpeg_tpu.codec.pipeline import geometry as jgeometry
from mozjpeg_tpu.ops import color as jcolor
from mozjpeg_tpu.ops import dct as jdct
from mozjpeg_tpu.ops import dering as jdering
from mozjpeg_tpu.ops import layout as jlayout
from mozjpeg_tpu.ops import sample as jsample
from mozjpeg_tpu.ops import symbols as jsymbols
from mozjpeg_tpu_torch.codec import pipeline_t as tpt
from mozjpeg_tpu_torch.codec import trellis as ttr
from mozjpeg_tpu_torch.ops import color as tcolor
from mozjpeg_tpu_torch.ops import dct as tdct
from mozjpeg_tpu_torch.ops import dering as tdering
from mozjpeg_tpu_torch.ops import layout as tlayout
from mozjpeg_tpu_torch.ops import sample as tsample
from mozjpeg_tpu_torch.ops import symbols as tsymbols
from test_torch_ops import _dering_corpus
from test_torch_trellis import _rand_ac_si


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_pad_plane_and_colour_conversions():
    rng = np.random.default_rng(1)
    plane = rng.integers(0, 256, (2, 13, 9)).astype(np.uint8)
    for ph, pw in ((13, 9), (16, 9), (13, 16), (24, 32)):
        _eq(tlayout.pad_plane(_t(plane), ph, pw),
            jlayout.pad_plane(jnp.asarray(plane), ph, pw))
    # every 8-bit extreme and a random spread of RGB and CMYK samples
    ext = np.array(np.meshgrid(*[[0, 1, 127, 128, 254, 255]] * 4))
    px = np.concatenate([ext.reshape(4, -1).T,
                         rng.integers(0, 256, (5000, 4))]).astype(np.uint8)
    _eq(tcolor.rgb_to_ycc(_t(px[:, :3])), jcolor.rgb_to_ycc(jnp.asarray(
        px[:, :3])))
    _eq(tcolor.cmyk_to_ycck(_t(px)), jcolor.cmyk_to_ycck(jnp.asarray(px)))


@pytest.mark.parametrize("h,w", [(16, 24), (6, 10), (24, 40)])
def test_downsamplers_and_smoothers(h, w):
    """Every ratio the encoder takes (odd multiples of the factor too),
    and the smoothing filters on odd and even planes, with a batch axis
    (the JAX functions run per plane, as under the encoder's vmap)."""
    rng = np.random.default_rng(h * w)
    planes = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
    planes[0, :3] = 255
    planes[1, :, -2:] = 0

    def per_plane(fn, *a):
        return np.stack([np.asarray(fn(jnp.asarray(p), *a)) for p in planes])

    _eq(tsample.downsample_h2v2(_t(planes)), per_plane(
        jsample.downsample_h2v2))
    _eq(tsample.downsample_h2v1(_t(planes)), per_plane(
        jsample.downsample_h2v1))
    # jcsample.c has no 1x2 kernel: the JAX h1v2 is int_downsample's
    _eq(tsample.downsample_int(_t(planes), 1, 2), per_plane(
        jsample.downsample_h1v2))
    for hexp, vexp in ((1, 2), (2, 1), (2, 2)) + (
            ((4, 2), (4, 1)) if w % 4 == 0 else ()):
        _eq(tsample.downsample_int(_t(planes), hexp, vexp),
            per_plane(jsample.downsample_int, hexp, vexp))
    for sf in (1, 25, 100):
        odd = planes[:, :h - 1, :w - 1]
        for p in (planes, odd):
            _eq(tsample.smooth_fullsize(_t(p), sf), np.stack(
                [np.asarray(jsample.smooth_fullsize(jnp.asarray(q), sf))
                 for q in p]))
        _eq(tsample.downsample_h2v2_smooth(_t(planes), sf),
            per_plane(jsample.downsample_h2v2_smooth, sf))


def _sample_blocks(n):
    """(8, 8, n) centred samples: random, flat extremes, stripes."""
    rng = np.random.default_rng(n)
    x = rng.integers(-128, 128, (8, 8, n)).astype(np.int32)
    x[..., 0] = -128
    x[..., 1] = 127
    x[:, ::2, 2] = 127
    x[:, 1::2, 2] = -128
    x[::2, :, 3] = -128
    x[1::2, :, 3] = 127
    return x


@pytest.mark.parametrize("q", [1, 2, 16, 255])
def test_ifast_dct_quantize_rescale(q):
    x = _sample_blocks(600)
    sc = tdct.fdct_ifast_t(_t(x))
    sc_j = jdct.fdct_ifast_t(jnp.asarray(x))
    _eq(sc, sc_j)
    rng = np.random.default_rng(q)
    qt = np.clip(rng.integers(1, 100, (8, 8)), 1, 255)
    qt[0, 0] = q
    qt[3, :] = q
    d = tdct.ifast_divisors(qt)
    _eq(d, jdct.ifast_divisors(qt))
    # the DCT's outputs, then the int16 extremes and values past them
    # (the int32 products of the rescale wrap as XLA's do)
    extra = np.array([-32768, -32767, -1, 0, 1, 32767, 32768, 65535,
                      -70000, 70000, 99999, -99999], np.int32)
    vals = np.concatenate([sc.numpy(), np.broadcast_to(
        extra, (8, 8, extra.size))], 2)
    d81 = d.reshape(8, 8, 1)
    _eq(tdct.quantize_ifast_t(_t(vals), _t(d81)),
        jdct.quantize_ifast_t(jnp.asarray(vals), jnp.asarray(d81)))
    _eq(tdct.rescale_ifast_t(_t(vals)),
        jdct.rescale_ifast_t(jnp.asarray(vals)))


@pytest.mark.parametrize("q", [1, 7, 255])
def test_float_dct_quantize_rescale(q):
    x = _sample_blocks(600).astype(np.float32)
    sc = tdct.fdct_float_t(_t(x))
    _eq(sc, jdct.fdct_float_t(jnp.asarray(x)))
    rng = np.random.default_rng(q)
    qt = np.clip(rng.integers(1, 100, (8, 8)), 1, 255)
    qt[0, 0] = q
    div = tdct.float_divisors(qt)
    _eq(div, jdct.float_divisors(qt))
    # the DCT's outputs, the whole coefficient range, and exact or near
    # halves of every AAN scale (the rounding ties of the rescale)
    aan = np.asarray(tdct._AAN_F)
    a2 = (aan[:, None] * aan[None, :]).reshape(8, 8, 1)
    k = np.arange(-300, 300) + 0.5
    ties = np.concatenate([(k * a2).astype(np.float32),
                           np.nextafter((k * a2).astype(np.float32),
                                        np.float32(np.inf))], 2)
    wide = rng.uniform(-70000, 70000, (8, 8, 2000)).astype(np.float32)
    vals = np.concatenate([sc.numpy(), ties, wide], 2)
    d81 = div.reshape(8, 8, 1)
    _eq(tdct.quantize_float_t(_t(vals), _t(d81)),
        jdct.quantize_float_t(jnp.asarray(vals), jnp.asarray(d81)))
    _eq(tdct.rescale_float_t(_t(vals)),
        jdct.rescale_float_t(jnp.asarray(vals)))


@pytest.mark.parametrize("q0", [1, 16])
def test_dering_float_matches_jax(q0):
    zz = _dering_corpus().astype(np.float32)
    _eq(tdering.dering_float_t(_t(zz), q0),
        jdering.dering_float_t(jnp.asarray(zz), jnp.int32(q0)))


@pytest.mark.parametrize("ri", [1, 7, 37, 500])
def test_ac_first_histogram_restart_segments(ri):
    """ri = 1, ri not dividing N, ri = N and ri > N; a batch of two images
    segments each image on its own."""
    rng = np.random.default_rng(ri)
    n = 37
    zz = rng.integers(-3, 4, (64, 2 * n)).astype(np.int16)
    zz[rng.random(zz.shape) < 0.8] = 0
    zz[1:, 10:20] = 0                                  # all-zero blocks
    zz[:, 30] = 5                                      # no trailing zeros
    jhist = jax.jit(jsymbols.ac_first_histogram_t, static_argnums=(1, 2, 3))
    got = tsymbols.ac_first_histograms_t(_t(zz), 2, ri)
    for i in range(2):
        _eq(got[i], jhist(jnp.asarray(zz[:, i * n:(i + 1) * n]), 1, 63, ri))
    _eq(tsymbols.ac_first_histogram_t(_t(zz[:, :n]), 9, 63, ri),
        jhist(jnp.asarray(zz[:, :n]), 9, 63, ri))


def test_eob_block_dp_matches_jax():
    """Tie-heavy rows (integer costs from a handful of values, equal EOB
    code lengths), rows of all-zero blocks, rows with no all-zero block,
    and one-block rows."""
    rng = np.random.default_rng(3)
    for r, l in ((12, 9), (5, 1), (4, 40)):
        czero = rng.integers(0, 6, (r, l)).astype(np.float32)
        skip = rng.integers(0, 6, (r, l)).astype(np.float32)
        has_eob = rng.integers(0, 3, (r, l)).astype(np.int32)
        has_eob[0] = 2                                   # all-zero row
        has_eob[1] = rng.integers(0, 2, l)               # no zero block
        skip[2] = czero[2]                               # ties
        si = np.stack([_rand_ac_si(rng) for _ in range(r)])
        si[:, 0:256:16] = 4                              # equal EOBn lengths
        si[1, 0:256:16] = rng.integers(2, 12, 16)
        si_f = si.astype(np.float32)
        got = ttr.eob_block_dp(_t(czero), _t(skip), _t(has_eob),
                               _t(si_f[:, ::16]))
        _eq(got, jtr._eob_block_dp(jnp.asarray(czero), jnp.asarray(skip),
                                   jnp.asarray(has_eob), jnp.asarray(si_f)))


@pytest.mark.parametrize("delta_w", [0.25, 1.0])
def test_dc_trellis_delta_weight_matches_jax(delta_w):
    rng = np.random.default_rng(int(delta_w * 8))
    r, l = 6, 30
    raw = rng.integers(-8000, 8000, (r, l)).astype(np.int32)
    above = rng.integers(-8000, 8000, (r, l)).astype(np.int32)
    above_dc = rng.integers(-100, 100, (r, l)).astype(np.int32)
    lam = (rng.random((r, l)) * 0.01).astype(np.float32)
    last = rng.integers(-50, 50, r).astype(np.int32)
    dc_si = np.zeros(256, np.int32)
    dc_si[:12] = rng.integers(2, 10, 12)
    for q0 in (8, 2):
        nc = ttr.get_num_dc_candidates(q0)
        got, fin = ttr.trellis_dc_rows(_t(raw), _t(last), q0, _t(dc_si),
                                       _t(lam), nc, delta_w, _t(above),
                                       _t(above_dc))
        want, wfin = jtr._trellis_dc_t(
            jnp.asarray(raw), jnp.asarray(last), jnp.int32(q0),
            jnp.asarray(dc_si), jnp.asarray(lam), nc, 1023, delta_w,
            jnp.asarray(above), jnp.asarray(above_dc))
        _eq(got, want)
        _eq(fin, wfin)


def test_band_hists_match_make_band_hist_t():
    rng = np.random.default_rng(9)
    b = 2
    qs = [rng.integers(-4, 5, (64, b * n)).astype(np.int16)
          for n in (30, 12)]
    for q in qs:
        q[rng.random(q.shape) < 0.7] = 0
    for band, ris in (((1, 8), None), ((9, 63), (4, 7)), ((1, 63), (5, 5))):
        want = jtr.make_band_hist_t(*band, batch=b, ris=ris)(
            tuple(jnp.asarray(q) for q in qs))
        got = ttr.band_hists([_t(q) for q in qs], *band, b, ris)
        for g_, w_ in zip(got, want):
            _eq(g_, w_)


def _img(h, w, c, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h,
                     128 + 90 * np.sin(xx / 3.0), 255 - xx * 2.0][:c], -1)
    base[h // 4:h // 2, w // 4:w // 2] = 255               # clipped white
    return np.clip(base + r.normal(0, 12, base.shape), 0, 255) \
        .astype(np.uint8)


@pytest.mark.parametrize("cs,c,samp,smooth,dctm", [
    ("ycbcr", 3, (1, 2), 30, "ifast"),
    ("ycbcr", 3, (4, 2), 0, "float"),
    ("grayscale", 0, None, 0, "ifast"),
    ("ycck", 4, (2, 2), 20, "islow"),
])
def test_device_prep_p1_matches_run_p1_batch(cs, c, samp, smooth, dctm):
    """The device-prep p1 (colour, smoothing, every downsampling kind,
    each DCT, restart-segmented histograms) against
    pipeline_t.run_p1_batch on an unaligned B=2 batch."""
    h, w = 27, 42
    imgs = np.stack([_img(h, w, max(c, 1), s) for s in (1, 2)])
    if c == 0:
        imgs = imgs[..., 0]
    samps = {"ycbcr": [samp, (1, 1), (1, 1)], "grayscale": [(1, 1)],
             "rgb": [(1, 1)] * 3, "ycck": [samp, (1, 1), (1, 1), samp]}[cs]
    slots = {"ycbcr": (0, 1, 1), "grayscale": (0,), "rgb": (0, 0, 0),
             "ycck": (0, 1, 1, 0)}[cs]
    qt = make_qtables(JCfg(quality=[70, 50]).resolved())
    _, _, comps = jgeometry(w, h, samps)
    ris = tuple(2 * g.bw for g in comps)
    geom_j, merged_j, small_j = jpt.run_p1_batch(
        imgs, samps, qt, True, 8, ris, smooth, dctm, cs, slots)
    geom = jgeometry(w, h, samps)
    merged, small, _ = tpt.p1_batch(_t(imgs), geom, cs, qt, slots, True,
                                    dctm, ris, smooth)
    for (q, r), (qj, rj) in zip(merged, merged_j):
        _eq(q, qj)
        _eq(r, rj)
    _eq(small, small_j)


@pytest.mark.parametrize("eob_opt,delta_w,bands", [
    (True, 0.0, ((1, 63),)), (True, 0.5, ((9, 63),))])
def test_trellis_all_options_match_make_trellis_all_t(eob_opt, delta_w,
                                                      bands):
    """The trellis program with the EOB-run DP, the DC delta weight and
    split bands, on a B=2 4:2:0 batch with an odd block-row count,
    against the JAX program with the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(12)
    b = 2
    _, _, geoms = jgeometry(40, 40, [(2, 2), (1, 1), (1, 1)])
    raws, qs, lams, ac_sis, dc_sis, qzs, ncands = [], [], [], [], [], [], []
    for g in geoms:
        n = b * g.bh * g.bw
        raw = rng.integers(-6000, 6000, (64, n)).astype(np.int32)
        raw[rng.random(raw.shape) < 0.8] = 0
        raw[1:, ::3] = 0                               # all-zero AC blocks
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
    run = jtr.make_trellis_all_t(tuple(geoms), None, bands, True,
                                 tuple(ncands), batch=b, eob_opt=eob_opt,
                                 delta_w=delta_w, use_pallas=True,
                                 interpret=True)
    packed = jnp.asarray(jtr.pack_trellis_inputs(lams, ac_sis, dc_sis, qzs))
    want = run(tuple(jnp.asarray(r) for r in raws),
               tuple(jnp.asarray(q) for q in qs), packed)
    got = ttr.trellis_all(tuple(geoms), [_t(r) for r in raws],
                          [_t(q) for q in qs], [_t(x) for x in lams],
                          [_t(a) for a in ac_sis], dc_sis, qzs, ncands,
                          batch=b, bands=bands, eob_opt=eob_opt,
                          delta_w=delta_w)
    for g_, w_ in zip(got, want):
        _eq(g_, w_)
