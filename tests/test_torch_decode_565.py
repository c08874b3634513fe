"""The port's RGB565 output, colour quantizers and image writers on the
CPU equal the JAX package's exactly: decode_rgb565 with the ordered
dither on and off on gray, 4:2:0, h2v1 and 4:4:4 streams (fancy and
replicating upsampling, a truncated progressive stream) and the
ValueError on CMYK; decode_many(output="rgb565"); quantize_colors, two-
and one-pass with none, ordered and FS dithering, on gray and RGB input,
and the ValueError below 8 colours; read_color_map on GIF, P3 and P6
files and on bad ones; quantize_to_map; and the ppm, bmp, gif and targa
writers, byte for byte, with their readers reading back what they
wrote."""
import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import decoder as jdec
from mozjpeg_tpu.utils import bmp as jbmp
from mozjpeg_tpu.utils import gif as jgif
from mozjpeg_tpu.utils import ppm as jppm
from mozjpeg_tpu.utils import targa as jtarga
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.utils import bmp as tbmp
from mozjpeg_tpu_torch.utils import gif as tgif
from mozjpeg_tpu_torch.utils import ppm as tppm
from mozjpeg_tpu_torch.utils import targa as ttarga
from test_torch_decode import _photo, _truncate


def _enc(im, **kw):
    kw.setdefault("quality", 80)
    return mjt.encode(im, mjt.EncoderConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def streams():
    img, odd = _photo(48, 64, 91), _photo(29, 37, 92)
    k_img = np.concatenate([img, _photo(48, 64, 93)[..., :1]], -1)
    s = {
        "gray_odd": _enc(odd[..., 0]),
        "ycc_420": _enc(img),
        "ycc_odd_420": _enc(odd),
        "ycc_odd_2x1": _enc(odd, subsampling=(2, 1)),
        "ycc_444": _enc(img, subsampling=(1, 1)),
        "arith_420": _enc(img, arithmetic=True),
        "cmyk": _enc(k_img),
    }
    s["ycc_truncated"] = _truncate(s["ycc_420"], 0.6)
    return s


@pytest.fixture(scope="module")
def pictures():
    """Decoded RGB and gray images to quantize and write."""
    rgb = _photo(29, 37, 94)
    return {"rgb": rgb, "gray": rgb[..., 1].copy()}


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["gray_odd", "ycc_420", "ycc_odd_420",
                                  "ycc_odd_2x1", "ycc_444", "arith_420",
                                  "ycc_truncated"])
def test_decode_rgb565_equals_jax(streams, name):
    data = streams[name]
    for fancy in (True, False):
        for dither in (True, False):
            want = jdec.decode_rgb565(data, fancy, dither)
            assert want.dtype == np.uint16
            _equal(mjt.decode_rgb565(data, fancy, dither, device="cpu"),
                   want)


def test_decode_rgb565_refuses_cmyk_like_jax(streams):
    with pytest.raises(ValueError) as want:
        jdec.decode_rgb565(streams["cmyk"])
    with pytest.raises(ValueError) as got:
        mjt.decode_rgb565(streams["cmyk"], device="cpu")
    assert str(got.value) == str(want.value)


def test_decode_many_rgb565_equals_jax(streams):
    datas = [streams[n] for n in ("ycc_420", "gray_odd", "ycc_odd_2x1",
                                  "arith_420")]
    for fancy in (True, False):
        want = mj.decode_many(datas, fancy, output="rgb565")
        got = mjt.decode_many(datas, fancy, output="rgb565", device="cpu")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)


@pytest.mark.parametrize("kind", ["rgb", "gray"])
@pytest.mark.parametrize("two_pass,dither", [
    (True, "fs"), (True, "none"), (True, "ordered"),
    (False, "none"), (False, "ordered"), (False, "fs")])
def test_quantize_colors_equals_jax(pictures, kind, two_pass, dither):
    img = pictures[kind]
    for n in (8, 27, 256):
        want = jdec.quantize_colors(img, n, dither, two_pass)
        got = tdec.quantize_colors(img, n, dither, two_pass)
        for g, w in zip(got, want):
            _equal(g, w)


def test_quantize_colors_refuses_like_jax(pictures):
    for args in ((pictures["rgb"], 7), (pictures["rgb"], 300, "fs", False)):
        with pytest.raises(ValueError) as want:
            jdec.quantize_colors(*args)
        with pytest.raises(ValueError) as got:
            tdec.quantize_colors(*args)
        assert str(got.value) == str(want.value)


def _map_files(pictures):
    """A GIF (the port's writer), a P6 and a P3 file of a quantized
    palette, and bad files."""
    idx, cmap = jdec.quantize_colors(pictures["rgb"], 32)
    pal = cmap[idx]
    p6 = b"P6\n# palette\n%d %d\n255\n" % (pal.shape[1], pal.shape[0]) \
        + pal.tobytes()
    p3 = (b"P3 %d %d 255\n" % (pal.shape[1], pal.shape[0])
          + b" ".join(b"%d" % v for v in pal.reshape(-1)) + b"\n")
    many = np.arange(300 * 3, dtype=np.uint32).reshape(1, 300, 3)
    many = np.stack([many[..., 0] % 256, many[..., 0] // 256,
                     many[..., 1] % 7], -1).astype(np.uint8)
    good = {"gif": tgif.write_gif(idx, cmap, len(cmap)), "p6": p6, "p3": p3}
    bad = {"empty": b"", "bmp": b"BM" + bytes(40),
           "gif_no_map": b"GIF87a" + bytes(7),
           "short_gif": b"GIF8", "ppm_maxval": b"P6 1 1 15\n\x01\x02\x03",
           "ppm_header": b"P6 x",
           "too_many": b"P6 300 1 255\n" + many.tobytes()}
    return good, bad


def test_read_color_map_equals_jax(pictures):
    good, bad = _map_files(pictures)
    for name, data in good.items():
        _equal(tdec.read_color_map(data), jdec.read_color_map(data))
    for name, data in bad.items():
        with pytest.raises(ValueError) as want:
            jdec.read_color_map(data)
        with pytest.raises(ValueError) as got:
            tdec.read_color_map(data)
        assert str(got.value) == str(want.value), name


@pytest.mark.parametrize("kind", ["rgb", "gray"])
def test_quantize_to_map_equals_jax(pictures, kind):
    good, _ = _map_files(pictures)
    cmap = jdec.read_color_map(good["p6"])
    for dither in ("fs", "none", "ordered"):
        want = jdec.quantize_to_map(pictures[kind], cmap, dither)
        got = tdec.quantize_to_map(pictures[kind], cmap, dither)
        for g, w in zip(got, want):
            _equal(g, w)


def test_ppm_writer_and_reader_equal_jax(pictures, tmp_path):
    rgb, gray = pictures["rgb"], pictures["gray"]
    wide = (rgb.astype(np.uint16) * 257)
    for i, (img, maxval) in enumerate(((rgb, None), (gray, None),
                                       (wide, None), (rgb, 255))):
        want, got = tmp_path / ("j%d.ppm" % i), tmp_path / ("t%d.ppm" % i)
        jppm.write(str(want), img, maxval)
        tppm.write(str(got), img, maxval)
        assert got.read_bytes() == want.read_bytes()
        _equal(tppm.read(str(got)), jppm.read(str(want)))
        _equal(tppm.read(str(got)), img)
    odd = tmp_path / "maxval.pgm"          # maxval 100: rescaled on read
    odd.write_bytes(b"P5\n# c\n3 2\n100\n" + bytes([0, 50, 100, 1, 99, 7]))
    _equal(tppm.read(str(odd)), jppm.read(str(odd)))


def test_bmp_writer_and_reader_equal_jax(pictures):
    rgb, gray = pictures["rgb"], pictures["gray"]
    idx, cmap = jdec.quantize_colors(rgb, 64)
    for os2 in (False, True):
        for args, kw in (((rgb,), {}), ((gray,), {}),
                         ((idx,), {"colormap": cmap}),
                         ((idx,), {"colormap": cmap[:, 0]}),
                         ((rgb,), {"density": (2, 28, 30)})):
            want = jbmp.write_bmp(*args, os2=os2, **kw)
            got = tbmp.write_bmp(*args, os2=os2, **kw)
            assert got == want
            back, dens = tbmp.read_bmp(got)
            want_back, want_dens = jbmp.read_bmp(want)
            _equal(back, want_back)
            assert dens == want_dens
    _equal(tbmp.read_bmp(tbmp.write_bmp(rgb))[0], rgb)
    for data in (b"BX" + bytes(40), b"BM" + bytes(10)):
        with pytest.raises(ValueError) as want:
            jbmp.read_bmp(data)
        with pytest.raises(ValueError) as got:
            tbmp.read_bmp(data)
        assert str(got.value) == str(want.value)


def test_gif_writer_and_reader_equal_jax(pictures):
    rgb, gray = pictures["rgb"], pictures["gray"]
    idx, cmap = jdec.quantize_colors(rgb, 200)
    for lzw in (True, False):
        for args in ((idx, cmap, len(cmap)), (gray, None, 256),
                     (idx, cmap[:, 0], len(cmap)), (idx[:1, :1], None, 1)):
            want = jgif.write_gif(*args, lzw=lzw)
            got = tgif.write_gif(*args, lzw=lzw)
            assert got == want
            back, back_gray = tgif.read_gif(got)
            want_back, want_gray = jgif.read_gif(want)
            _equal(back, want_back)
            assert back_gray == want_gray
    _equal(tgif.read_gif(tgif.write_gif(idx, cmap, len(cmap)))[0],
           cmap[idx])
    for data in (b"GIX", b"GIF87a" + bytes([1, 0, 1, 0, 0, 0, 0, 0x3B])):
        with pytest.raises(ValueError) as want:
            jgif.read_gif(data)
        with pytest.raises(ValueError) as got:
            tgif.read_gif(data)
        assert str(got.value) == str(want.value)


def _tga_rle(img_bgr: np.ndarray, h: int, w: int) -> bytes:
    """A type-10 (RLE RGB) Targa, top-down, with runs and raw packets."""
    px = img_bgr.reshape(-1, 3)
    out = bytearray(18)
    out[2], out[16], out[17] = 10, 24, 0x20
    out[12], out[13], out[14], out[15] = w & 0xFF, w >> 8, h & 0xFF, h >> 8
    i = 0
    while i < len(px):
        run = 1
        while i + run < len(px) and run < 128 and \
                np.array_equal(px[i + run], px[i]):
            run += 1
        if run > 1:
            out += bytes([0x80 | (run - 1)]) + px[i].tobytes()
        else:
            out += bytes([0]) + px[i].tobytes()
        i += run
    return bytes(out)


def test_targa_writer_and_reader_equal_jax(pictures):
    rgb, gray = pictures["rgb"], pictures["gray"]
    idx, cmap = jdec.quantize_colors(rgb, 64)
    for args, kw in (((rgb,), {}), ((gray,), {}),
                     ((idx,), {"colormap": cmap, "num_colors": len(cmap)}),
                     ((idx,), {"colormap": cmap[:, 0],
                               "num_colors": len(cmap)})):
        want = jtarga.write_targa(*args, **kw)
        got = ttarga.write_targa(*args, **kw)
        assert got == want
        back, back_gray = ttarga.read_targa(got)
        want_back, want_gray = jtarga.read_targa(want)
        _equal(back, want_back)
        assert back_gray == want_gray
    _equal(ttarga.read_targa(ttarga.write_targa(rgb))[0], rgb)
    flat = np.repeat(rgb[:, :4], 3, axis=1)           # runs for the RLE
    rle = _tga_rle(flat[..., ::-1].copy(), *flat.shape[:2])
    _equal(ttarga.read_targa(rle)[0], jtarga.read_targa(rle)[0])
    _equal(ttarga.read_targa(rle)[0], flat)
    for data in (bytes(10), rle[:40]):
        with pytest.raises(ValueError) as want:
            jtarga.read_targa(data)
        with pytest.raises(ValueError) as got:
            ttarga.read_targa(data)
        assert str(got.value) == str(want.value)
