"""The port's TurboJPEG API (turbojpeg.py, TJ(device="cpu")) against the
JAX package's TJ on a seeded 48x64 image: compress at every pixel format
and subsampling and bottom-up, decompress_header, decompress at every
pixel format, scaled, cropped and bottom-up, transform with its options,
encode_yuv / decode_yuv (4:4:0 and the 4:1 ratios included) with
padding, compress_from_yuv, decompress_to_yuv, lossless, and the buffer
size functions; outputs byte- or array-equal, refusals the same error
type. TJ() without CUDA raises RuntimeError."""
import numpy as np
import pytest
import torch

from mozjpeg_tpu import turbojpeg as jtj
from mozjpeg_tpu_torch import turbojpeg as ttj
from test_torch_decode import _photo, on_torch_render


@pytest.fixture(scope="module")
def rgb():
    return _photo(48, 64, 61)


def _pair(**params):
    a, b = jtj.TJ(), ttj.TJ(device="cpu")
    for k, v in params.items():
        a.set(getattr(jtj, k), v)
        b.set(getattr(ttj, k), v)
    return a, b


def _pf_src(rgb, pf):
    """The RGB image in pixel format pf (seeded pad/alpha bytes)."""
    nch, (r, g, b) = jtj._PF_INFO[pf]
    if pf == jtj.TJPF_GRAY:
        return rgb[..., 1]
    out = np.random.default_rng(pf).integers(
        0, 256, rgb.shape[:2] + (nch,), dtype=np.uint8)
    if pf != jtj.TJPF_CMYK:
        out[..., r], out[..., g], out[..., b] = (rgb[..., i] for i in
                                                 range(3))
    return out


PFS = list(range(12))
SAMPS = [jtj.TJSAMP_444, jtj.TJSAMP_422, jtj.TJSAMP_420, jtj.TJSAMP_GRAY,
         jtj.TJSAMP_440, jtj.TJSAMP_411, jtj.TJSAMP_441]


@pytest.mark.parametrize("pf", PFS)
def test_compress_pixel_formats_equal_jax(rgb, pf):
    a, b = _pair()
    src = _pf_src(rgb, pf)
    assert a.compress(src, pf) == b.compress(src, pf)


@pytest.mark.parametrize("samp", SAMPS)
def test_compress_subsamplings_equal_jax(rgb, samp):
    a, b = _pair(TJPARAM_SUBSAMP=samp, TJPARAM_QUALITY=85)
    assert a.compress(rgb) == b.compress(rgb)


def test_compress_options_equal_jax(rgb):
    for params in ({"TJPARAM_BOTTOMUP": 1},
                   {"TJPARAM_PROGRESSIVE": 1},
                   {"TJPARAM_OPTIMIZE": 1, "TJPARAM_RESTARTBLOCKS": 4},
                   {"TJPARAM_ARITHMETIC": 1}):
        a, b = _pair(**params)
        assert a.compress(rgb) == b.compress(rgb), params


@pytest.fixture(scope="module")
def jpegs(rgb):
    _, b = _pair()
    out = {"420": b.compress(rgb)}
    _, b = _pair(TJPARAM_SUBSAMP=jtj.TJSAMP_GRAY)
    out["gray"] = b.compress(rgb)
    _, b = _pair(TJPARAM_SUBSAMP=jtj.TJSAMP_444, TJPARAM_PROGRESSIVE=1)
    out["444p"] = b.compress(rgb)
    _, b = _pair()
    out["cmyk"] = b.compress(_pf_src(rgb, jtj.TJPF_CMYK), jtj.TJPF_CMYK)
    return out


def _same_or_raise(fa, fb):
    try:
        want = fa()
    except (ValueError, jtj.TJError) as e:
        with pytest.raises((ValueError, ttj.TJError)):
            fb()
        return type(e)
    got = fb()
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want
    return got


@pytest.mark.parametrize("name", ["420", "gray", "444p", "cmyk"])
def test_decompress_header_equals_jax(jpegs, name):
    a, b = _pair()
    assert a.decompress_header(jpegs[name]) == \
        b.decompress_header(jpegs[name])
    assert a._params == b._params


@pytest.mark.parametrize("name", ["420", "gray", "cmyk"])
def test_decompress_pixel_formats_equal_jax(jpegs, name):
    a, b = _pair()
    for pf in PFS:
        _same_or_raise(lambda: a.decompress(jpegs[name], pf),
                       lambda: on_torch_render(b.decompress, jpegs[name],
                                               pf))


def test_decompress_scaled_cropped_bottomup_equal_jax(jpegs):
    for scale, crop, bu in (((1, 2), None, 0), ((3, 8), None, 1),
                            ((2, 1), (8, 4, 20, 30), 0),
                            ((1, 1), (3, 5, 40, 9), 1)):
        a, b = _pair(TJPARAM_BOTTOMUP=bu)
        for t in (a, b):
            t.set_scaling_factor(*scale)
            if crop:
                t.set_cropping_region(*crop)
        _same_or_raise(lambda: a.decompress(jpegs["420"], jtj.TJPF_BGRX),
                       lambda: on_torch_render(b.decompress, jpegs["420"],
                                               ttj.TJPF_BGRX))
    with pytest.raises(ttj.TJError):
        ttj.TJ(device="cpu").set_scaling_factor(3, 7)


@pytest.mark.parametrize("op", range(8))
def test_transform_ops_equal_jax(jpegs, op):
    a, b = _pair()
    assert a.transform(jpegs["420"], op) == b.transform(jpegs["420"], op)


def test_transform_options_equal_jax(jpegs):
    for opts, crop in ((jtj.TJXOPT_GRAY, None),
                       (jtj.TJXOPT_PROGRESSIVE, None),
                       (jtj.TJXOPT_OPTIMIZE | jtj.TJXOPT_TRIM, None),
                       (jtj.TJXOPT_ARITHMETIC, None),
                       (jtj.TJXOPT_CROP, (16, 16, 32, 16)),
                       (jtj.TJXOPT_NOOUTPUT, None)):
        a, b = _pair()
        assert a.transform(jpegs["444p"], jtj.TJXOP_ROT270, opts, crop) \
            == b.transform(jpegs["444p"], ttj.TJXOP_ROT270, opts, crop)


@pytest.mark.parametrize("samp", SAMPS)
@pytest.mark.parametrize("dims", [(48, 64), (29, 37)])
def test_yuv_round_trip_equals_jax(rgb, samp, dims):
    h, w = dims
    src = np.ascontiguousarray(rgb[:h, :w])
    a, b = _pair(TJPARAM_SUBSAMP=samp)
    ya = a.encode_yuv(src, jtj.TJPF_RGB, align=4)
    yb = b.encode_yuv(src, ttj.TJPF_RGB, align=4)
    assert ya == yb
    assert len(yb) == ttj.yuv_buf_size(w, 4, h, samp)
    da = a.decode_yuv(ya, w, h, jtj.TJPF_XRGB, align=4)
    db = b.decode_yuv(yb, w, h, ttj.TJPF_XRGB, align=4)
    assert db.dtype == da.dtype and np.array_equal(da, db)


def test_compress_from_yuv_and_decompress_to_yuv_equal_jax(rgb, jpegs):
    a, b = _pair()
    yuv = b.encode_yuv(rgb)
    assert a.compress_from_yuv(yuv, 64, 48) == b.compress_from_yuv(yuv, 64,
                                                                   48)
    for name in ("420", "gray", "444p"):
        assert a.decompress_to_yuv(jpegs[name], align=8) == \
            b.decompress_to_yuv(jpegs[name], align=8)


def test_lossless_equals_jax(rgb):
    a, b = _pair(TJPARAM_LOSSLESS=1, TJPARAM_LOSSLESSPSV=6,
                 TJPARAM_LOSSLESSPT=1)
    ja, jb = a.compress(rgb), b.compress(rgb)
    assert ja == jb
    assert np.array_equal(a.decompress(ja), b.decompress(jb))
    a, b = _pair(TJPARAM_LOSSLESS=1, TJPARAM_PRECISION=12)
    deep = rgb.astype(np.uint16) << 4
    assert a.compress(deep) == b.compress(deep)


def test_buffer_sizes_equal_jax():
    for w, h in ((64, 48), (37, 29), (1, 1)):
        for s in SAMPS:
            assert ttj.jpeg_buf_size(w, h, s) == jtj.jpeg_buf_size(w, h, s)
            for al in (1, 4, 16):
                assert ttj.yuv_buf_size(w, al, h, s) == \
                    jtj.yuv_buf_size(w, al, h, s)
            for c in range(3):
                assert ttj.yuv_plane_dims(c, w, h, s) == \
                    jtj.yuv_plane_dims(c, w, h, s)
    assert ttj.scaling_factors() == jtj.scaling_factors()
    assert ttj.tjscaled(37, 3, 8) == jtj.tjscaled(37, 3, 8)
    a, b = _pair()
    with pytest.raises(ttj.TJError):
        b.set(99, 1)
    assert b.get(ttj.TJPARAM_QUALITY) == a.get(jtj.TJPARAM_QUALITY)


def test_tj_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttj.TJ(device=device)
