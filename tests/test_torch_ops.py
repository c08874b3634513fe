"""The PyTorch port's p1 ops, each held bit-exact against its JAX function
on the CPU with seeded numpy inputs (no tolerance: the JAX package is
bit-exact to mozjpeg, so any difference is a fault)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mozjpeg_tpu.codec import pipeline_t as jpt
from mozjpeg_tpu.ops import dct as jdct
from mozjpeg_tpu.ops import dering as jdering
from mozjpeg_tpu.ops import layout as jlayout
from mozjpeg_tpu.ops import quant as jquant
from mozjpeg_tpu.ops import symbols as jsymbols
from mozjpeg_tpu_torch.codec import pipeline_t as tpt
from mozjpeg_tpu_torch.ops import dct as tdct
from mozjpeg_tpu_torch.ops import dering as tdering
from mozjpeg_tpu_torch.ops import layout as tlayout
from mozjpeg_tpu_torch.ops import quant as tquant
from mozjpeg_tpu_torch.ops import symbols as tsymbols


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_blockify_zigzag_round_trip():
    rng = np.random.default_rng(1)
    plane = rng.integers(-128, 128, (40, 56)).astype(np.int32)
    blocks = tlayout.blockify_t(_t(plane))
    _eq(blocks, jlayout.blockify_t(jnp.asarray(plane)))
    zz = tlayout.to_zigzag_t(blocks)
    _eq(zz, jlayout.to_zigzag_t(jnp.asarray(blocks.numpy())))
    _eq(tlayout.from_zigzag_t(zz), jlayout.from_zigzag_t(jnp.asarray(
        zz.numpy())))
    _eq(tlayout.from_zigzag_t(zz), blocks)
    # a batch axis gives image-major block order
    two = rng.integers(-128, 128, (2, 16, 24)).astype(np.int32)
    _eq(tlayout.blockify_t(_t(two)), np.concatenate(
        [np.asarray(jlayout.blockify_t(jnp.asarray(p))) for p in two], 2))


def _dering_corpus():
    """(64, N) centered zigzag samples: no clip, all clipped, runs at
    either end, several runs, and headrooms below the 31 / 2*q0 caps."""
    rng = np.random.default_rng(5)
    cols = []
    cols += [rng.integers(-128, 127, 64) for _ in range(6)]   # none clipped
    cols += [np.full(64, 127)] * 2                             # all clipped
    for k in (1, 5, 20, 63):
        c = rng.integers(-128, 127, 64)
        c[:k] = 127                                            # run at start
        cols.append(c)
        c = rng.integers(-128, 127, 64)
        c[64 - k:] = 127                                       # run at end
        cols.append(c)
    for _ in range(20):                                        # mixed runs
        c = rng.integers(-128, 128, 64)
        m = rng.random(64) < rng.uniform(0.2, 0.8)
        c[m] = 127
        cols.append(c)
    for hi in (110, 118, 122, 125, 126):                       # small headroom
        c = np.full(64, hi)
        c[rng.random(64) < 0.5] = 127
        c[0] = 120
        cols.append(c)
    return np.stack(cols, 1).astype(np.int32)


@pytest.mark.parametrize("q0", [1, 4, 12, 16, 40])
def test_dering_t_matches_jax(q0):
    zz = _dering_corpus()
    _eq(tdering.dering_t(_t(zz), q0),
        jdering.dering_t(jnp.asarray(zz), jnp.int32(q0)))


def test_fdct_quantize_norm_match_jax():
    rng = np.random.default_rng(2)
    blocks = rng.integers(-128, 128, (8, 8, 300)).astype(np.int32)
    blocks[:, :, :10] = 127                         # extreme blocks
    blocks[:, :, 10:20] = -128
    coeffs = tdct.fdct_islow_t(_t(blocks))
    want = jdct.fdct_islow_t(jnp.asarray(blocks), 2)
    _eq(coeffs, want)
    qtbl = rng.integers(1, 256, (8, 8, 1)).astype(np.int32)
    qtbl[0, 0, 0] = 1
    _eq(tquant.quantize_islow_t(coeffs, _t(qtbl)),
        jquant.quantize_islow_t(want, jnp.asarray(qtbl)))
    raw_zz = rng.integers(-8192, 8193, (64, 500)).astype(np.int32)
    raw_zz[:, :5] = 0
    _eq(tpt.norm_seq(_t(raw_zz)), jpt._norm_seq(jnp.asarray(raw_zz)))


def _hist_corpus():
    rng = np.random.default_rng(3)
    n = 700
    zz = rng.integers(-40, 41, (64, n)).astype(np.int16)
    zz[rng.random((64, n)) < 0.85] = 0
    zz[:, 50:400] = 0                  # a long all-zero stretch: EOB runs
    zz[63, 10:20] = 7                  # blocks ending on a nonzero
    zz[1:, 600:] = 0                   # trailing zero blocks (DC only)
    zz[17, 450] = 1023
    return zz


@pytest.mark.parametrize("band", [(1, 63), (1, 8), (9, 63), (5, 40)])
def test_ac_first_histogram_matches_jax(band):
    zz = _hist_corpus()
    got = tsymbols.ac_first_histogram_t(_t(zz), band[0], band[1])
    _eq(got, jsymbols.ac_first_histogram_t(jnp.asarray(zz), band[0],
                                            band[1]))


def test_ac_first_histogram_all_zero_and_huge_runs():
    zero = np.zeros((64, 40000), np.int16)     # one EOB run > 0x7FFF
    _eq(tsymbols.ac_first_histogram_t(_t(zero)),
        jsymbols.ac_first_histogram_t(jnp.asarray(zero)))
    zz = _hist_corpus()
    two = np.concatenate([zz, zero[:, :300]], 1)
    got = tsymbols.ac_first_histograms_t(_t(two), 2)
    for i in range(2):
        _eq(got[i], jsymbols.ac_first_histogram_t(
            jnp.asarray(two[:, i * 500:(i + 1) * 500])))


def _photo(h, w, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255.0 / w, yy * 255.0 / h,
                    128 + 60 * np.sin(xx / 3.0)], -1)
    img += r.normal(0, 10, img.shape)
    img[h // 4:h // 2, w // 4:w // 2] = 255
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(48, 64), (29, 37)])
def test_p1_matches_run_p1_batch_pre(h, w):
    """The whole prepped-plane p1 (q_zz, raw_zz and the int32 sidecar)
    against pipeline_t.run_p1_batch_pre, 4:2:0, B=2."""
    from mozjpeg_tpu.codec.config import EncoderConfig as JCfg
    from mozjpeg_tpu.codec.encoder import make_qtables
    imgs = [_photo(h, w, 11), _photo(h, w, 12)]
    samp = [(2, 2), (1, 1), (1, 1)]
    qt = make_qtables(JCfg(quality=75).resolved())
    geom_j, merged_j, small_j = jpt.run_p1_batch_pre(imgs, samp, qt, True)
    geom, bufs = tpt.prep_ycc_batch(imgs, samp)
    assert geom == geom_j
    merged, small, _ = tpt.p1_batch_pre(_t(bufs), tuple(geom[2]), qt, True)
    for (q, r), (qj, rj) in zip(merged, merged_j):
        _eq(q, qj)
        _eq(r, rj)
    _eq(small, small_j)
