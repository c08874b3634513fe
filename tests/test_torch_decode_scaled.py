"""The port's scaled decode on the CPU equals the JAX package's exactly:
the five scaled IDCT entry points (ops/idct_scaled.py) at all 16 sizes on
seeded blocks and on int16 extremes with 16-bit tables (the int32 wrap),
and decode_scaled at every M/8, M = 1..16, with fancy upsampling on and
off, on 4:2:0, h2v1, h1v2, 4:4:4, gray, RGB, CMYK, YCCK and arithmetic
streams, a truncated progressive stream (block smoothing), an odd-sized
4:2:0 stream (partial blocks) and an 8x6 h2v1 one (fancy h2 upsampling
off on planes 2 samples wide); the ValueError above 2/1 and the
NotImplementedError of fractional upsampling.

The streams come from the port's encoder on the CPU (no JAX compile). The
JAX oracle compiles one render per plane geometry and IDCT size, so the
streams share the 64x48 geometry where they can."""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import decoder as jdec
from mozjpeg_tpu.ops import dct as jdct
from mozjpeg_tpu.ops import idct_scaled as jscaled
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import marker as tmarker
from mozjpeg_tpu_torch.ops import dct as tdct
from mozjpeg_tpu_torch.ops import idct_scaled as tscaled
from test_torch_decode import _photo, _truncate

ALL_M = tuple(range(1, 17))


def _enc(im, **kw):
    kw.setdefault("quality", 80)
    return mjt.encode(im, mjt.EncoderConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def streams():
    img, odd = _photo(48, 64, 81), _photo(29, 37, 82)
    k_img = np.concatenate([img, _photo(48, 64, 83)[..., :1]], -1)
    s = {
        "ycc_420": _enc(img),
        "ycc_2x1": _enc(img, subsampling=(2, 1)),
        "ycc_1x2": _enc(img, subsampling=(1, 2), progressive=False),
        "ycc_444": _enc(img, subsampling=(1, 1)),
        "gray": _enc(img[..., 0]),
        "rgb": _enc(img, colorspace="rgb"),
        "cmyk": _enc(k_img),
        "ycck_420": _enc(k_img, colorspace="ycck"),
        "arith_420": _enc(img, arithmetic=True),
        "ycc_420_odd": _enc(odd),
        "ycc_2x1_8x6": _enc(_photo(6, 8, 84), subsampling=(2, 1)),
    }
    s["ycc_truncated"] = _truncate(s["ycc_420"], 0.6)
    return s


# (stream, the M it is decoded at): every M for each stream kind; fewer
# for the geometries and the int32 (smoothed) planes that only they give
CASES = {name: ALL_M for name in (
    "ycc_420", "ycc_2x1", "ycc_1x2", "ycc_444", "gray", "rgb", "cmyk",
    "ycck_420", "arith_420")}
CASES.update({"ycc_truncated": (1, 3, 8, 16),
              "ycc_420_odd": (1, 2, 3, 5, 8, 11, 16),
              "ycc_2x1_8x6": (1, 2, 4, 5)})


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_inputs_cover_the_paths(streams):
    jp = tmarker.parse(streams["ycc_truncated"])
    tdec._entropy(jp, streams["ycc_truncated"])
    assert tdec._smoothing_active(jp, True)
    assert tmarker.parse(streams["arith_420"]).arithmetic
    assert [(c.h, c.v) for c in tmarker.parse(
        streams["ycc_1x2"]).components] == [(1, 2), (1, 1), (1, 1)]
    assert tdec._jpeg_colorspace(tmarker.parse(streams["ycck_420"])) \
        == "ycck"
    # at 2/8 the 8x6 h2v1 image's chroma is 1 sample wide: replicated,
    # not fancy (jdsample.c's h2 rule); at 5/8 it is 3 wide and fancy
    jp = tmarker.parse(streams["ycc_2x1_8x6"])
    assert tdec._scaled_upsampler(jp, jp.components[1], 2, 2, True, 1) \
        == ("int", 2, 1)
    assert tdec._scaled_upsampler(jp, jp.components[1], 5, 5, True, 3) \
        == ("fancy_h2v1", 2, 1)


def _jax_op(size):
    if size == 8:
        return jax.jit(jdct.idct_islow)
    if size == 4:
        return jax.jit(jscaled.idct_4x4)
    if size == 2:
        return jax.jit(jscaled.idct_2x2)
    if size == 1:
        return jax.jit(jscaled.idct_1x1)
    fn = (jscaled.idct_reduced if size in jscaled._REDUCED
          else jscaled.idct_expanded)
    return jax.jit(lambda c, q: fn(c, q, size))


def _port_op(size):
    if size == 8:
        return tdct.idct_islow
    if size == 4:
        return tscaled.idct_4x4
    if size == 2:
        return tscaled.idct_2x2
    if size == 1:
        return tscaled.idct_1x1
    if size in tscaled._REDUCED:
        return lambda c, q: tscaled.idct_reduced(c, q, size)
    return lambda c, q: tscaled.idct_expanded(c, q, size)


@pytest.mark.parametrize("size", ALL_M)
def test_scaled_idct_equals_jax(size):
    """Seeded blocks with 8-bit tables, and int16 extremes with 16-bit
    tables, whose int32 products wrap: one call each way."""
    rng = np.random.default_rng(90 + size)
    seeded = rng.integers(-600, 600, (48, 8, 8)).astype(np.int16)
    extremes = rng.integers(-32768, 32768, (48, 8, 8)).astype(np.int16)
    extremes[:8] = np.array([-32768, 32767], np.int16)[
        rng.integers(0, 2, (8, 8, 8))]
    coef = np.concatenate([seeded, extremes])
    q = np.concatenate([rng.integers(1, 256, (48, 8, 8)),
                        rng.integers(1, 65536, (48, 8, 8))]).astype(np.int32)
    want = np.asarray(_jax_op(size)(jnp.asarray(coef), jnp.asarray(q)))
    got = _port_op(size)(torch.as_tensor(coef), torch.as_tensor(q)).numpy()
    assert got.shape == (96, size, size)
    _equal(got, want)


@pytest.mark.parametrize("fancy", [True, False], ids=["fancy", "nosmooth"])
@pytest.mark.parametrize("name", list(CASES))
def test_decode_scaled_equals_jax(streams, name, fancy):
    data = streams[name]
    for m in CASES[name]:
        want = jdec.decode_scaled(data, m, 8, fancy)
        got = mjt.decode_scaled(data, m, 8, fancy, device="cpu")
        _equal(got, want)


def test_decode_scaled_options_equal_jax(streams):
    """Other fractions than M/8, block smoothing off, a colorspace
    override and decode's size at 8/8."""
    data, trunc = streams["ycc_420"], streams["ycc_truncated"]
    for num, den in ((1, 3), (3, 4), (5, 4), (2, 1)):
        _equal(mjt.decode_scaled(data, num, den, device="cpu"),
               jdec.decode_scaled(data, num, den))
    _equal(mjt.decode_scaled(trunc, 1, 8, True, False, device="cpu"),
           jdec.decode_scaled(trunc, 1, 8, True, False))
    for m in (1, 16):
        _equal(mjt.decode_scaled(data, m, 8, colorspace="grayscale",
                                 device="cpu"),
               jdec.decode_scaled(data, m, 8, colorspace="grayscale"))
    _equal(mjt.decode_scaled(data, 8, 8, device="cpu"),
           mjt.decode(data, device="cpu"))


def test_scale_above_two_raises(streams):
    with pytest.raises(ValueError) as want:
        jdec.decode_scaled(streams["ycc_420"], 17, 8)
    with pytest.raises(ValueError) as got:
        mjt.decode_scaled(streams["ycc_420"], 17, 8, device="cpu")
    assert str(got.value) == str(want.value)


def _with_sampling(data: bytes, factors) -> bytes:
    """The stream with its SOF's sampling factors rewritten (the scan
    data then decodes to other coefficients, which is all this needs)."""
    pos = next(i for i in range(2, len(data) - 1)
               if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2))
    ln = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    seg = bytearray(data[pos:pos + 2 + ln])
    for i, (h, v) in enumerate(factors):
        seg[4 + 6 + 3 * i + 1] = (h << 4) | v
    return data[:pos] + bytes(seg) + data[pos + 2 + ln:]


def test_fractional_upsampling_raises(streams):
    """Y at 3x1 beside Cb at 2x1: 3 is no multiple of 2."""
    data = _with_sampling(streams["ycc_1x2"], [(3, 1), (2, 1), (1, 1)])
    with pytest.raises(NotImplementedError, match="fractional") as want:
        jdec.decode_scaled(data, 8, 8)
    with pytest.raises(NotImplementedError) as got:
        mjt.decode_scaled(data, 8, 8, device="cpu")
    assert str(got.value) == str(want.value)
