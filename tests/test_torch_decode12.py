"""Decode of the port's own 12-bit streams on the CPU against the JAX
package, pixel for pixel and dtype for dtype (uint16 out): decode with
each IDCT, decode_many (RGB, YUV and a mixed 8/12-bit list),
decode_grayscale, decode_cropped, BufferedImage, RGB565 and the djpeg
command line's 12-bit PPM. decode_scaled at 12 bits runs the scaled IDCTs
at the stream's precision, as jidctint.c and jidctred.c do, where the JAX
package keeps the 8-bit constants (ROADMAP.md §3): its tests hold the
port to decode at 8/8, to flat DC-only blocks at every M/8, and to the
DC level DESCALE(DC*q, 3) + 2048 at 1/8. (At 8 bits decode_scaled stays
held to the JAX package at every M/8 by tests/test_torch_decode_scaled.)
The streams come from the port's encoder, no JAX compile; the JAX decode
compiles once per plane geometry."""
import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import decoder as jdec
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import marker as tmarker
from test_torch_cli_djpeg import _run_both
from test_torch_encode12 import photo12


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, (
            got.dtype, got.shape, want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _enc(im, **kw):
    kw.setdefault("quality", 75)
    return mjt.encode(im, mjt.EncoderConfig(precision=12, **kw),
                      device="cpu")


def _blocky(h, w, seed):
    """A gray 12-bit image of flat 8x8 blocks: every block codes its DC
    alone."""
    r = np.random.default_rng(seed)
    lv = r.integers(200, 3900, (h // 8, w // 8))
    return np.kron(lv, np.ones((8, 8), np.int64)).astype(np.uint16)


@pytest.fixture(scope="module")
def streams():
    """The 12-bit default, and streams of other kinds made without the
    trellis, whose plain version is most of an encode's time on the CPU
    and changes nothing the decoder sees."""
    img = photo12(48, 64, 11)
    return {
        "default": _enc(img),                           # progressive 4:2:0
        "sequential": _enc(img, progressive=False,      # SOF1
                           trellis_quant=False),
        "rgb": _enc(img, colorspace="rgb", trellis_quant=False),
        "gray": _enc(img[..., 0], trellis_quant=False),
        "blocky": _enc(_blocky(48, 64, 12), trellis_quant=False),
    }


def test_streams_are_12_bit(streams):
    for name, data in streams.items():
        jp = tmarker.parse(data)
        assert jp.precision == 12, name
    assert b"\xff\xc1" in streams["sequential"]


@pytest.mark.parametrize("dct", ["islow", "ifast", "float"])
@pytest.mark.parametrize("name", ["default", "sequential", "rgb", "gray"])
def test_decode_equals_jax(streams, name, dct):
    got = mjt.decode(streams[name], dct_method=dct, device="cpu")
    assert got.dtype == np.uint16 and got.max() > 255
    _same(got, mj.decode(streams[name], dct_method=dct))


def test_decode_many_equals_jax(streams):
    """RGB and YUV output of the 12-bit streams mixed with an 8-bit one;
    the 12-bit images render one at a time."""
    eight = mjt.encode((photo12(48, 64, 11) >> 4).astype(np.uint8),
                       mjt.EncoderConfig(quality=75), device="cpu")
    datas = [streams["default"], eight, streams["gray"], streams["rgb"],
             streams["sequential"]]
    _same(mjt.decode_many(datas, device="cpu"), mj.decode_many(datas))
    _same(mjt.decode_many(datas, output="yuv", device="cpu"),
          mj.decode_many(datas, output="yuv"))


@pytest.mark.parametrize("name", ["default", "rgb", "gray"])
def test_decode_grayscale_and_rgb565_equal_jax(streams, name):
    """decode_grayscale (RGB streams give the low 8 bits of their luma, as
    the JAX package's rgb_to_gray casts), RGB565 with and without the
    dither and through decode_many, or the same ValueError."""
    data = streams[name]
    _same(tdec.decode_grayscale(data, device="cpu"),
          jdec.decode_grayscale(data))
    for dither in (True, False):
        try:
            want = jdec.decode_rgb565(data, dither=dither)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tdec.decode_rgb565(data, dither=dither, device="cpu")
            continue
        _same(tdec.decode_rgb565(data, dither=dither, device="cpu"), want)
    if name != "rgb":
        _same(mjt.decode_many([data], output="rgb565", device="cpu"),
              mj.decode_many([data], output="rgb565"))


@pytest.mark.parametrize("name", ["default", "gray"])
def test_decode_cropped_and_buffered_image_equal_jax(streams, name):
    data = streams[name]
    for x, w in ((0, 64), (3, 20), (17, 40)):
        got, want = (tdec.decode_cropped(data, x, w, device="cpu"),
                     jdec.decode_cropped(data, x, w))
        assert got[1:] == want[1:]
        _same(got[0], want[0])
    _same(list(tdec.BufferedImage(data, device="cpu")),
          list(jdec.BufferedImage(data)))
    _same(tdec.BufferedImage(data, device="cpu").render_pass(2),
          jdec.BufferedImage(data).render_pass(2))
    _same(tdec.decode_raw_planes(data, device="cpu"),
          jdec.decode_raw_planes(data))


@pytest.mark.parametrize("flags", [
    [], ["-grayscale"], ["-dct", "fast"], ["-rgb565", "-bmp"], ["-bmp"],
    ["-gif"], ["-targa"], ["-colors", "64"], ["-crop", "20x20+3+4"]])
def test_djpeg_12_bit_ppm_equals_jax(streams, tmp_path, flags):
    """The port's djpeg writes the JAX package's file: a 16-bit PPM with
    maxval 4095 (2-byte samples), or whatever the JAX command line makes
    of 12-bit samples in its other formats."""
    src = tmp_path / "in.jpg"
    src.write_bytes(streams["default"])
    (rj, oj), (rp, op) = _run_both(flags + ["-outfile", "@.out", str(src)],
                                   tmp_path)
    assert rj == rp == 0
    assert op["out"] == oj["out"]
    if not flags or flags[0] == "-dct":
        assert op["out"].startswith(b"P6\n64 48\n4095\n")


def test_jpegyuv_12_bit_equals_jax(streams, tmp_path):
    from mozjpeg_tpu.cli import jpegyuv as jjpegyuv
    from mozjpeg_tpu_torch.cli import jpegyuv as tjpegyuv
    src = tmp_path / "in.jpg"
    src.write_bytes(streams["default"])
    assert jjpegyuv.main([str(src), str(tmp_path / "j.yuv")]) == 0
    assert tjpegyuv.main([str(src), str(tmp_path / "t.yuv")],
                         device="cpu") == 0
    assert (tmp_path / "t.yuv").read_bytes() \
        == (tmp_path / "j.yuv").read_bytes()


def test_decode_scaled_8_8_equals_decode(streams):
    """At 8/8 decode_scaled is decode (held to the JAX package above)."""
    for name in ("default", "rgb", "gray"):
        _same(tdec.decode_scaled(streams[name], 8, 8, device="cpu"),
              mjt.decode(streams[name], device="cpu"))


@pytest.mark.parametrize("m", range(1, 17))
def test_decode_scaled_dc_only_blocks_stay_flat(streams, m):
    """A block that codes its DC alone renders flat at every M/8, at the
    level decode gives it (every scaled IDCT at 12 bits sees the DC
    through the stream's PASS1_BITS and range limit)."""
    data = streams["blocky"]
    full = mjt.decode(data, device="cpu")
    levels = full[::8, ::8]
    assert (full == np.kron(levels, np.ones((8, 8), np.uint16))).all()
    got = tdec.decode_scaled(data, m, 8, device="cpu")
    assert got.dtype == np.uint16 and got.shape == (6 * m, 8 * m)
    _same(got, np.kron(levels, np.ones((m, m), np.uint16)))


def test_decode_scaled_1_8_is_the_dc_level(streams):
    """At 1/8 each sample of a gray stream is its block's DC level:
    DESCALE(DC * q, 3) + 2048 through the 12-bit range limit
    (jidctred.c's 1x1), on a photo whose blocks carry AC too."""
    data = streams["gray"]
    jp = tmarker.parse(data)
    planes = tdec.decode_coefficients(jp, data)
    q0 = int(tdec._comp_qtable(jp, 0).reshape(64)[0])
    dc = planes[0][:6, :8, 0].astype(np.int64) * q0
    want = np.clip(((dc + 4) >> 3) + 2048, 0, 4095).astype(np.uint16)
    _same(tdec.decode_scaled(data, 1, 8, device="cpu"), want)
    assert len(np.unique(want)) > 10
