"""The port's other decode entry points on the CPU equal the JAX
package's exactly: decode_grayscale (YCbCr, gray, RGB and arithmetic
sources, block smoothing; CMYK and YCCK raise the same ValueError),
decode_cropped (full width, aligned and unaligned x, odd and narrow
crops, 4:2:0, 2x1, 1x2, 4:4:4, gray, RGB, CMYK, YCCK, arithmetic,
replicating upsampling, a truncated progressive stream), BufferedImage
(every render_pass and __iter__, Huffman and arithmetic, sequential and
progressive, a truncated progressive stream, the float IDCT), and
decode's positional order (the JAX package's). Lossless and 12-bit
streams still raise NotImplementedError from each of them. The port's
calls that reach render() run under torch_render(), on its PyTorch
render (the card's route)."""
import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import decoder as jdec
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import marker as tmarker
from test_torch_decode import (_photo, _truncate, _with_sof,
                               on_torch_render, torch_render)


@pytest.fixture(scope="module")
def streams():
    img, odd = _photo(48, 64, 71), _photo(29, 37, 72)
    k_img = np.concatenate([img, _photo(48, 64, 73)[..., :1]], -1)

    def enc(im, **kw):
        kw.setdefault("quality", 80)
        return mjt.encode(im, mjt.EncoderConfig(**kw), device="cpu")

    s = {
        "ycc_420": enc(img),
        "ycc_odd_2x1": enc(odd, subsampling=(2, 1)),
        "ycc_odd_1x2": enc(odd, subsampling=(1, 2), progressive=False),
        "ycc_odd_444": enc(odd, subsampling=(1, 1)),
        "gray_odd": enc(odd[..., 0]),
        "rgb": enc(img, colorspace="rgb"),
        "cmyk": enc(k_img),
        "ycck_420": enc(k_img, colorspace="ycck"),
        "arith_420": enc(img, arithmetic=True),
        "arith_odd_seq": enc(odd, arithmetic=True, progressive=False),
    }
    s["ycc_truncated"] = _truncate(s["ycc_420"], 0.6)
    s["arith_truncated"] = _truncate(s["arith_420"], 0.6)
    return s


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_inputs_cover_the_paths(streams):
    for name in ("ycc_truncated", "arith_truncated"):
        jp = tmarker.parse(streams[name])
        tdec._entropy(jp, streams[name])
        assert tdec._smoothing_active(jp, True)
    assert tmarker.parse(streams["arith_420"]).arithmetic
    assert len(tmarker.parse(streams["ycc_420"]).scans) > 2


GRAY_NAMES = ["ycc_420", "ycc_odd_2x1", "gray_odd", "rgb", "arith_420",
              "ycc_truncated", "arith_truncated"]


@pytest.mark.parametrize("name", GRAY_NAMES)
def test_decode_grayscale_equals_jax(streams, name):
    data = streams[name]
    for fancy, smooth in ((True, True), (False, False)):
        _equal(mjt.decode_grayscale(data, fancy, smooth, device="cpu"),
               jdec.decode_grayscale(data, fancy, smooth))


@pytest.mark.parametrize("name", ["cmyk", "ycck_420"])
def test_decode_grayscale_refuses_like_jax(streams, name):
    with pytest.raises(ValueError) as want:
        jdec.decode_grayscale(streams[name])
    with pytest.raises(ValueError) as got:
        mjt.decode_grayscale(streams[name], device="cpu")
    assert str(got.value) == str(want.value)


CROP_NAMES = ["ycc_420", "ycc_odd_2x1", "ycc_odd_1x2", "ycc_odd_444",
              "gray_odd", "rgb", "cmyk", "ycck_420", "arith_odd_seq",
              "ycc_truncated"]


def _crops(width):
    """(x, w): full width; aligned; unaligned; odd and narrow regions
    (w2 < 8 after alignment); the right edge."""
    return [(0, width), (16, 16), (5, 13), (17, 3), (3, 4),
            (width - 5, 5), (1, width - 1)]


@pytest.mark.parametrize("name", CROP_NAMES)
def test_decode_cropped_equals_jax(streams, name):
    data = streams[name]
    width = tmarker.parse(data).width
    for x, w in _crops(width):
        want = jdec.decode_cropped(data, x, w)
        got = on_torch_render(mjt.decode_cropped, data, x, w, device="cpu")
        assert got[1:] == want[1:]
        _equal(got[0], want[0])
    for fancy, smooth in ((False, True), (True, False)):
        want = jdec.decode_cropped(data, 5, 13, fancy, smooth)
        got = mjt.decode_cropped(data, 5, 13, fancy, smooth, device="cpu")
        assert got[1:] == want[1:]
        _equal(got[0], want[0])


def test_decode_cropped_bad_width_raises(streams):
    data = streams["ycc_420"]
    for x, w in ((0, 0), (60, 5)):
        for fn in (jdec.decode_cropped,
                   lambda *a: mjt.decode_cropped(*a, device="cpu")):
            with pytest.raises(ValueError, match="bad crop width"):
                fn(data, x, w)


BUFFERED = [("ycc_420", "islow"), ("ycc_odd_444", "float"),
            ("arith_420", "islow"), ("arith_odd_seq", "islow"),
            ("ycc_odd_1x2", "islow"), ("ycc_truncated", "islow")]


@pytest.mark.parametrize("name,method", BUFFERED)
def test_buffered_image_equals_jax(streams, name, method):
    data = streams[name]
    want = jdec.BufferedImage(data, dct_method=method)
    got = mjt.BufferedImage(data, dct_method=method, device="cpu")
    assert got.num_scans == want.num_scans
    assert got.progressive == want.progressive
    passes_w = list(want)
    passes_g = on_torch_render(list, got)
    assert len(passes_g) == len(passes_w) == want.num_scans
    for g, w in zip(passes_g, passes_w):
        _equal(g, w)
    for k in range(1, want.num_scans + 1):
        _equal(on_torch_render(got.render_pass, k), want.render_pass(k))
    for k in (0, want.num_scans + 1):
        with pytest.raises(ValueError, match="pass out of range"):
            got.render_pass(k)


def test_decode_positional_order_is_jax(streams):
    """decode(data, fancy_upsample, dct_method, block_smoothing)."""
    for name in ("ycc_truncated", "ycc_odd_2x1"):
        data = streams[name]
        _equal(mjt.decode(data, True, "ifast", device="cpu"),
               mj.decode(data, True, "ifast"))
        _equal(mjt.decode(data, False, "float", False, "cpu"),
               mj.decode(data, False, "float", False))
        with torch_render():
            assert not np.array_equal(mjt.decode(data, True, "ifast", True,
                                                 "cpu"),
                                      mjt.decode(data, True, "islow", True,
                                                 "cpu"))


@pytest.mark.parametrize("case,item", [("lossless", "6.10"),
                                       ("12-bit", "6.2")])
def test_out_of_slice_streams_raise_from_every_entry(streams, case, item):
    """The lossless (item 6.10) and 12-bit (6.2) cases, ported since,
    equal the JAX package from every entry point: a stream whose SOF says
    lossless fails the lossless scan checks with the same ValueError, and
    one whose SOF says 12 bits renders at 12 bits."""
    base = streams["ycc_420"]
    data = (_with_sof(base, code=0xC3) if case == "lossless"
            else _with_sof(base, precision=12))
    for port, jax in (
            (lambda: mjt.decode_grayscale(data, device="cpu"),
             lambda: jdec.decode_grayscale(data)),
            (lambda: mjt.decode_cropped(data, 0, 16, device="cpu"),
             lambda: jdec.decode_cropped(data, 0, 16)),
            (lambda: list(mjt.BufferedImage(data, device="cpu")),
             lambda: list(jdec.BufferedImage(data)))):
        try:
            want = jax()
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                port()
            assert str(got.value) == str(e)
            continue
        got = port()
        if isinstance(want, tuple):                # decode_cropped
            assert got[1:] == want[1:]
            got, want = [got[0]], [want[0]]
        elif not isinstance(want, list):
            got, want = [got], [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
