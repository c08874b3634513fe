"""Lossless JPEG (SOF3) of the port against the JAX package on the CPU:
encode_lossless at 8, 12 and 16 bits with every predictor, point
transforms and restart intervals, gray and RGB, byte for byte; decode,
decode_grayscale, decode_many and djpeg of those streams equal to the JAX
package's and (without a point transform) to the input; the same
ValueErrors on bad predictors and point transforms, arithmetic-coded
SOF11 frames and subsampled components. Lossless runs on the host in
both packages (the shared C++ coder), so nothing here compiles."""
import struct

import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import decoder as jdec
from mozjpeg_tpu.codec import lossless as jll
from mozjpeg_tpu.codec import marker as jmarker
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import lossless as tll
from test_torch_cli_djpeg import _run_both


def _image(prec, c, seed, h=19, w=23):
    """Smooth seeded samples with noise at `prec` bits (the predictors'
    residuals stay small, as in photos), the extremes in one corner."""
    r = np.random.default_rng(seed)
    top = (1 << prec) - 1
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (0.5 + 0.4 * np.sin(xx / 4.0 + yy / 7.0))[..., None] * top
    img = base + r.normal(0, top / 50, (h, w, c))
    img[0, 0], img[0, 1] = 0, top
    img = np.clip(img, 0, top).astype(np.uint8 if prec <= 8 else np.uint16)
    return img[..., 0] if c == 1 else img


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("prec", [8, 12, 16])
def test_encode_lossless_equals_jax_and_round_trips(prec, c, predictor):
    img = _image(prec, c, 10 * prec + c + predictor)
    data = tll.encode_lossless(img, predictor, 0, prec)
    assert data == jll.encode_lossless(img, predictor, 0, prec)
    assert data[:2] == b"\xff\xd8" and b"\xff\xc3" in data
    got = mjt.decode(data, device="cpu")
    _same(got, mj.decode(data))
    _same(got, img)


@pytest.mark.parametrize("prec,pt,ri,rows", [
    (8, 3, 0, 0), (12, 5, 23, 0), (16, 9, 0, 2), (12, 0, 0, 3000),
    (16, 15, 46, 0)])
def test_point_transforms_and_restarts_equal_jax(prec, pt, ri, rows):
    """Point transforms drop the low bits (decode shifts them back), and
    restart intervals in MCUs or rows reset the predictor at row starts.
    Rows convert at width MCUs a row, capped at 65535, which is no whole
    number of 23-sample rows: both decoders refuse that stream alike."""
    for c in (1, 3):
        img = _image(prec, c, prec + pt)
        data = tll.encode_lossless(img, 4, pt, prec, ri, rows)
        assert data == jll.encode_lossless(img, 4, pt, prec, ri, rows)
        if rows * img.shape[1] > 65535:
            with pytest.raises(ValueError) as want:
                mj.decode(data)
            with pytest.raises(ValueError) as got:
                mjt.decode(data, device="cpu")
            assert str(got.value) == str(want.value)
            continue
        got = mjt.decode(data, device="cpu")
        _same(got, mj.decode(data))
        _same(got, ((img >> pt) << pt).astype(img.dtype))
        assert (b"\xff\xdd" in data) == bool(ri or rows)


def test_lossless_through_every_decode_entry_point(tmp_path):
    """decode_grayscale gives the first component, decode_many decodes
    lossless streams beside lossy ones (and refuses YUV output of them),
    and djpeg writes the JAX package's PPM (maxval 65535 at 16 bits)."""
    rgb16 = _image(16, 3, 1)
    gray12 = _image(12, 1, 2)
    d16 = tll.encode_lossless(rgb16, 6, 0, 16)
    d12 = tll.encode_lossless(gray12, 2, 0, 12, 0, 1)
    lossy = mjt.encode(_image(8, 3, 3), mjt.EncoderConfig(quality=75),
                       device="cpu")
    for d in (d16, d12):
        _same(tdec.decode_grayscale(d, device="cpu"),
              jdec.decode_grayscale(d))
    datas = [d16, lossy, d12]
    got = mjt.decode_many(datas, device="cpu")
    for g, w in zip(got, mj.decode_many(datas)):
        _same(g, w)
    _same(got[0], rgb16)
    with pytest.raises(ValueError, match="lossy"):
        mjt.decode_many(datas, output="yuv", device="cpu")
    with pytest.raises(ValueError, match="lossy"):
        mj.decode_many(datas, output="yuv")
    src = tmp_path / "in.jpg"
    src.write_bytes(d16)
    (rj, oj), (rp, op) = _run_both(["-outfile", "@.out", str(src)],
                                   tmp_path)
    assert rj == rp == 0 and op["out"] == oj["out"]
    assert op["out"].startswith(b"P6\n23 19\n65535\n")


def _rewrite_sof(data: bytes, code=None, samp=None) -> bytes:
    """The stream with its SOF3's marker code or first component's
    sampling byte replaced."""
    pos = data.index(b"\xff\xc3")
    out = bytearray(data)
    if code is not None:
        out[pos + 1] = code
    if samp is not None:
        out[pos + 11] = samp
    return bytes(out)


@pytest.mark.parametrize("case", ["predictor0", "predictor8", "pt",
                                  "sof11", "subsampled"])
def test_same_value_errors_as_jax(case):
    img = _image(12, 3, 4)
    if case in ("predictor0", "predictor8", "pt"):
        args = {"predictor0": (0, 0), "predictor8": (8, 0),
                "pt": (1, 12)}[case]
        with pytest.raises(ValueError) as want:
            jll.encode_lossless(img, *args, 12)
        with pytest.raises(ValueError) as got:
            tll.encode_lossless(img, *args, 12)
        assert str(got.value) == str(want.value)
        return
    data = tll.encode_lossless(img, 1, 0, 12)
    assert struct.unpack(">H", data[data.index(b"\xff\xc3") + 2:][:2])[0] \
        == 8 + 3 * 3
    bad = (_rewrite_sof(data, code=0xCB) if case == "sof11"
           else _rewrite_sof(data, samp=0x22))
    jp = jmarker.parse(bad)
    with pytest.raises(ValueError) as want:
        jll.decode_lossless(jp, bad)
    for port in (lambda: mjt.decode(bad, device="cpu"),
                 lambda: mjt.decode_many([bad], device="cpu"),
                 lambda: tdec.decode_grayscale(bad, device="cpu")):
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(want.value)
