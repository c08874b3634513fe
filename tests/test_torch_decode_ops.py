"""The port's decode ops equal their JAX functions exactly on the CPU:
the islow dequant + IDCT (8- and 12-bit, int16 extremes where int32
products wrap), the four upsamplers on degenerate and odd planes, YCbCr ->
RGB, the zigzag and block layouts, and the batched render of a group
against the JAX package's _render_ycc_batch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mozjpeg_tpu.codec import decoder as jdec
from mozjpeg_tpu.ops import color as jcolor
from mozjpeg_tpu.ops import dct as jdct
from mozjpeg_tpu.ops import layout as jlayout
from mozjpeg_tpu.ops import sample as jsample
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.ops import color as tcolor
from mozjpeg_tpu_torch.ops import dct as tdct
from mozjpeg_tpu_torch.ops import layout as tlayout
from mozjpeg_tpu_torch.ops import sample as tsample


def _coeffs(rng, shape, extreme):
    """Coefficients as real streams carry them (sparse, mostly small), or
    spread over the whole int16 range with its two extremes planted."""
    if extreme:
        c = rng.integers(-32768, 32768, shape)
        c.reshape(-1)[:4] = [-32768, 32767, -32768, 32767]
        return c.astype(np.int16)
    c = np.round(rng.laplace(0, 40, shape)).clip(-2047, 2047)
    c[rng.random(shape) < 0.6] = 0
    return c.astype(np.int16)


@pytest.mark.parametrize("precision,pass1_bits", [(8, 2), (12, 1)])
@pytest.mark.parametrize("extreme", [False, True])
def test_idct_islow_exact(precision, pass1_bits, extreme):
    rng = np.random.default_rng(precision * 10 + extreme)
    coef = _coeffs(rng, (3, 7, 8, 8), extreme)
    qt = rng.integers(1, 256, (3, 1, 8, 8)).astype(np.int32)
    want = np.asarray(jdct.idct_islow(jnp.asarray(coef), jnp.asarray(qt),
                                      pass1_bits, precision))
    got = tdct.idct_islow(torch.from_numpy(coef), torch.from_numpy(qt),
                          pass1_bits, precision).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    assert int(got.max()) <= (1 << precision) - 1 and int(got.min()) >= 0


PLANE_SHAPES = [(1, 1), (1, 9), (9, 1), (5, 7), (6, 8), (2, 2)]


@pytest.mark.parametrize("name", ["upsample_h2v1_fancy",
                                  "upsample_h2v2_fancy",
                                  "upsample_h1v2_fancy"])
def test_fancy_upsamplers_exact(name):
    rng = np.random.default_rng(3)
    for shape in PLANE_SHAPES:
        plane = rng.integers(0, 256, shape).astype(np.uint8)
        plane.reshape(-1)[-1] = 255
        want = np.asarray(getattr(jsample, name)(jnp.asarray(plane)))
        got = getattr(tsample, name)(torch.from_numpy(plane)).numpy()
        assert got.dtype == np.uint8 and got.shape == want.shape, shape
        np.testing.assert_array_equal(got, want, err_msg=str(shape))


@pytest.mark.parametrize("h,v", [(2, 2), (2, 1), (1, 2), (4, 1), (3, 3)])
def test_upsample_replicate_exact(h, v):
    rng = np.random.default_rng(h * 7 + v)
    for shape in PLANE_SHAPES:
        plane = rng.integers(0, 256, shape).astype(np.uint8)
        want = np.asarray(jsample.upsample_replicate(jnp.asarray(plane), h, v))
        got = tsample.upsample_replicate(torch.from_numpy(plane), h, v)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fancy_upsamplers_batched_equal_per_plane():
    """The batched render upsamples (B, H, W) at once; each image must
    come out as the JAX function gives it on its own 2-D plane."""
    rng = np.random.default_rng(4)
    planes = rng.integers(0, 256, (3, 5, 7)).astype(np.uint8)
    for name in ("upsample_h2v1_fancy", "upsample_h2v2_fancy",
                 "upsample_h1v2_fancy"):
        got = getattr(tsample, name)(torch.from_numpy(planes)).numpy()
        for b in range(3):
            want = np.asarray(getattr(jsample, name)(jnp.asarray(planes[b])))
            np.testing.assert_array_equal(got[b], want, err_msg=name)


def test_ycc_to_rgb_exact():
    rng = np.random.default_rng(5)
    ycc = rng.integers(0, 256, (100_000, 3)).astype(np.uint8)
    corners = np.array([[a, b, c] for a in (0, 255) for b in (0, 255)
                        for c in (0, 255)], np.uint8)
    ycc = np.concatenate([ycc, corners])
    want = np.asarray(jcolor.ycc_to_rgb(jnp.asarray(ycc)))
    got = tcolor.ycc_to_rgb(torch.from_numpy(ycc)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_from_zigzag_and_unblockify_exact():
    rng = np.random.default_rng(6)
    zz = rng.integers(-2048, 2048, (2, 3, 5, 64)).astype(np.int16)
    want = np.asarray(jlayout.from_zigzag(jnp.asarray(zz)))
    got = tlayout.from_zigzag(torch.from_numpy(zz)).numpy()
    np.testing.assert_array_equal(got, want)
    want_p = np.asarray(jlayout.unblockify(jnp.asarray(want)))
    got_p = tlayout.unblockify(torch.from_numpy(got)).numpy()
    assert got_p.shape == (2, 24, 40)
    np.testing.assert_array_equal(got_p, want_p)


# (mode, hexp, vexp, gray) with the luma/chroma dims of a 37x29 image
RENDER_CASES = {
    "h2v2": ("h2v2", 2, 2, False, ((4, 5, 29, 37), (2, 3, 15, 19))),
    "h2v1": ("h2v1", 2, 1, False, ((4, 5, 29, 37), (4, 3, 29, 19))),
    "none": ("none", 1, 1, False, ((4, 5, 29, 37), (4, 5, 29, 37))),
    "gray": (None, 1, 1, True, ((4, 5, 29, 37), (0, 0, 0, 0))),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_batched_render_equals_render_ycc_batch(case):
    """B = 3 images with a distinct pair of quant tables each."""
    mode, hexp, vexp, gray, dims = RENDER_CASES[case]
    (lbh, lbw, _, _), (cbh, cbw, _, _) = dims
    rng = np.random.default_rng(7)
    b, h, w = 3, 29, 37
    y = _coeffs(rng, (b, lbh, lbw, 64), False)
    y[..., 0] = rng.integers(-1000, 1000, (b, lbh, lbw))
    qty = rng.integers(1, 256, (b, 8, 8)).astype(np.int32)
    cb = cr = qtc = None
    if not gray:
        cb = _coeffs(rng, (b, cbh, cbw, 64), False)
        cr = _coeffs(rng, (b, cbh, cbw, 64), False)
        qtc = rng.integers(1, 256, (b, 8, 8)).astype(np.int32)
    want = np.asarray(jdec._render_ycc_batch(
        jnp.asarray(y), None if gray else jnp.asarray(cb),
        None if gray else jnp.asarray(cr), jnp.asarray(qty),
        None if gray else jnp.asarray(qtc), dims, mode, h, w, 8, hexp,
        vexp, gray))
    key = tdec.GroupKey(w, h, gray, mode, hexp, vexp, dims, ())
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = tdec.render_ycc_batch(t(y), t(cb), t(cr), t(qty), t(qtc),
                                key).numpy()
    assert got.dtype == np.uint8
    assert got.shape == ((b, h, w) if gray else (b, h, w, 3))
    np.testing.assert_array_equal(got, want)
