"""The port's decode entry points on the CPU equal the JAX package's:
decode_coefficients (planes, progression status, warnings), decode
(against both JAX renders: the native host one and the device one),
decode_many on a mixed list (against the JAX default route and its
local-attachment merged route), replicating upsampling, YUV output, the
arithmetic, RGB, CMYK and YCCK streams and the other decode entry
points against the JAX package, and NotImplementedError for every
stream and option outside the slice.

The streams come from the JAX package's host encoder (mozjpeg_tpu.encode),
which needs no device compile."""
import struct

import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import decoder as jdec
from mozjpeg_tpu.codec import marker as jmarker
from mozjpeg_tpu.utils import attachment
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import marker as tmarker
from mozjpeg_tpu_torch.codec import smooth as tsmooth


def _photo(h, w, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * xx / max(w, 1), 255 * yy / max(h, 1),
                    128 + 90 * np.sin((xx + 2 * yy) / 5.0)], -1)
    img[: h // 2, w // 2:] = r.uniform(0, 255, 3)
    img += r.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _truncate(data: bytes, frac: float) -> bytes:
    return data[:int(len(data) * frac)] + b"\xff\xd9"


def _corrupt(data: bytes) -> bytes:
    """Flip bytes inside the entropy-coded data of the middle scans."""
    jp = jmarker.parse(data)
    b = bytearray(data)
    for scan in jp.scans[1:-1]:
        mid = (scan.data_start + scan.data_end) // 2
        if b[mid] not in (0xFF, 0x00) and b[mid - 1] != 0xFF:
            b[mid] ^= 0x5A
    return bytes(b)


def _dqt_before_second_scan(data: bytes) -> bytes:
    """Redefine quant table 0 (all ones) just before the second SOS. Every
    component was latched at the first scan, so the pixels must not
    change."""
    pos = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    return data[:pos] + b"\xff\xdb\x00\x43\x00" + bytes([1] * 64) \
        + data[pos:]


def _enc(img, **kw):
    return mj.encode(img, mj.EncoderConfig(**kw))


@pytest.fixture(scope="module")
def streams():
    s = {
        "q75_420_64x48": _enc(_photo(48, 64, 1), quality=75),
        "q75_420_64x48_b": _enc(_photo(48, 64, 2), quality=75),
        "q85_2x1_37x29": _enc(_photo(29, 37, 3), quality=85,
                              subsampling=(2, 1)),
        "q92_1x1_17x31": _enc(_photo(31, 17, 4), quality=92,
                              subsampling=(1, 1)),
        "q75_420_1x1": _enc(_photo(1, 1, 5), quality=75),
        "q80_1x2_37x29": _enc(_photo(29, 37, 9), quality=80,
                              subsampling=(1, 2)),
        "q80_4x1_37x29": _enc(_photo(29, 37, 10), quality=80,
                              subsampling=(4, 1)),
        # 12 MCUs, a restart every 2: 6 segments take the parallel path
        "baseline_restart": _enc(_photo(48, 64, 6), quality=75,
                                 progressive=False, restart_interval=2),
        # 4 MCUs, a restart every 2: 2 segments take the serial path
        "baseline_restart_serial": _enc(_photo(31, 17, 11), quality=75,
                                        progressive=False,
                                        restart_interval=2),
        "gray_64x48": _enc(_photo(48, 64, 7)[..., 1], quality=75),
    }
    s["truncated"] = _truncate(s["q75_420_64x48"], 2 / 3)
    s["corrupt"] = _corrupt(s["q85_2x1_37x29"])
    s["dqt_between_scans"] = _dqt_before_second_scan(s["q75_420_64x48"])
    return s


def test_inputs_cover_the_paths(streams):
    jp = tmarker.parse(streams["truncated"])
    tdec.decode_coefficients(jp, streams["truncated"])
    assert tsmooth.smoothing_ok(jp, jp.coef_bits)
    jp = tmarker.parse(streams["baseline_restart"])
    assert not jp.progressive and jp.restart_interval == 2
    jp = tmarker.parse(streams["baseline_restart_serial"])
    assert jp.restart_interval == 2 and jp.width == 17 and jp.height == 31
    modes = {n: tdec._upsample_mode(tmarker.parse(streams[n]))[0]
             for n in ("q75_420_64x48", "q85_2x1_37x29", "q92_1x1_17x31",
                       "q80_1x2_37x29", "q80_4x1_37x29")}
    assert modes == {"q75_420_64x48": "h2v2", "q85_2x1_37x29": "h2v1",
                     "q92_1x1_17x31": "none", "q80_1x2_37x29": "h1v2",
                     "q80_4x1_37x29": "int"}
    jp = tmarker.parse(streams["dqt_between_scans"])
    assert not np.array_equal(jp.scan_qtables[1][0], jp.scan_qtables[0][0])
    np.testing.assert_array_equal(
        mjt.decode(streams["dqt_between_scans"], device="cpu"),
        mjt.decode(streams["q75_420_64x48"], device="cpu"))


def _equal_outputs(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal_outputs(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


NAMES = ["q75_420_64x48", "q85_2x1_37x29", "q92_1x1_17x31", "q75_420_1x1",
         "q80_1x2_37x29", "q80_4x1_37x29", "baseline_restart",
         "baseline_restart_serial", "gray_64x48", "truncated", "corrupt",
         "dqt_between_scans"]


@pytest.mark.parametrize("name", NAMES)
def test_decode_coefficients_equal(streams, name):
    data = streams[name]
    jp_j, jp_t = jmarker.parse(data), tmarker.parse(data)
    try:
        want = jdec.decode_coefficients(jp_j, data)
    except ValueError:
        with pytest.raises(ValueError):
            tdec.decode_coefficients(jp_t, data)
        return
    got = tdec.decode_coefficients(jp_t, data)
    _equal_outputs(got, want)
    for attr in ("coef_bits", "coef_bits_prev"):
        a, b = getattr(jp_t, attr), getattr(jp_j, attr)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert jp_t.last_good_imcu_row == jp_j.last_good_imcu_row
    assert jp_t.warnings == jp_j.warnings
    assert tdec.last_warnings() == jp_j.warnings
    if name in ("truncated", "corrupt"):
        assert jp_t.warnings > 0


@pytest.mark.parametrize("host_engine", ["1", "0"])
def test_decode_equals_jax(streams, monkeypatch, host_engine):
    """MJ_HOST_ENGINE=1 is the JAX package's native host render, 0 its
    device render; both are pinned to djpeg."""
    monkeypatch.setenv("MJ_HOST_ENGINE", host_engine)
    for name in NAMES:
        data = streams[name]
        try:
            want = mj.decode(data)
        except ValueError:
            with pytest.raises(ValueError):
                mjt.decode(data, device="cpu")
            continue
        _equal_outputs(mjt.decode(data, device="cpu"), want)


def test_decode_garbage_raises():
    for data in (b"", b"\x00garbage bytes", b"\xff\xd8\xff\xd9"):
        with pytest.raises(ValueError):
            mj.decode(data)
        with pytest.raises(ValueError):
            mjt.decode(data, device="cpu")


def _mixed(streams):
    """More than GROUP streams of one geometry (two images, repeated),
    plus every other geometry, gray, truncated and corrupt."""
    a, b = streams["q75_420_64x48"], streams["q75_420_64x48_b"]
    return ([a, b] * 5
            + [streams[n] for n in NAMES if n != "q75_420_64x48"] + [a])


@pytest.mark.parametrize("merged", [False, True])
def test_decode_many_equals_jax(streams, monkeypatch, merged):
    """merged=True patches the JAX package's attachment probe so that its
    decode_many takes the local-attachment route (_render_ycc_batch),
    the route the port carries."""
    if merged:
        monkeypatch.setattr(attachment, "is_local_tpu", lambda: True)
    datas = _mixed(streams)
    assert len(datas) > 2 * tdec.GROUP
    want = mj.decode_many(datas)
    got = mjt.decode_many(datas, device="cpu")
    _equal_outputs(got, want)


def test_no_fancy_upsample_equals_jax(streams):
    names = ["q75_420_64x48", "q85_2x1_37x29", "q80_1x2_37x29", "gray_64x48",
             "truncated"]
    for name in names:
        want = mj.decode(streams[name], fancy_upsample=False,
                         block_smoothing=False)
        got = mjt.decode(streams[name], fancy_upsample=False,
                         block_smoothing=False, device="cpu")
        _equal_outputs(got, want)
    datas = [streams[n] for n in names]
    _equal_outputs(mjt.decode_many(datas, fancy_upsample=False,
                                   device="cpu"),
                   mj.decode_many(datas, fancy_upsample=False))


def test_yuv_equals_jax(streams):
    datas = _mixed(streams)
    want = mj.decode_many(datas, output="yuv")
    got = mjt.decode_many(datas, output="yuv", device="cpu")
    assert all(len(g) == (1 if d is streams["gray_64x48"] else 3)
               for g, d in zip(got, datas))
    _equal_outputs(got, want)


def _with_sof(data: bytes, code=None, precision=None, extra_comp=False,
              adobe=None) -> bytes:
    """Rewrite the SOF segment (its code, precision, or a fourth
    component) and optionally add an Adobe APP14 marker."""
    jp = jmarker.parse(data)
    pos = next(i for i in range(2, len(data) - 1)
               if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2))
    ln = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    seg = bytearray(data[pos + 4:pos + 2 + ln])
    if precision is not None:
        seg[0] = precision
    if extra_comp:
        seg[5] += 1
        seg += bytes([4, 0x11, jp.components[0].quant_tbl])
    sof = bytes([0xFF, code or data[pos + 1]]) \
        + struct.pack(">H", len(seg) + 2) + bytes(seg)
    out = data[:pos] + sof + data[pos + 2 + ln:]
    if adobe is not None:
        app14 = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)
        out = out[:2] + b"\xff\xee" + struct.pack(">H", len(app14) + 2) \
            + app14 + out[2:]
    return out


def _same_result(port, jax):
    """The port's call gives the JAX package's output, or raises the same
    ValueError (the same message) where it raises one."""
    try:
        want = jax()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(e)
        return
    _equal_outputs(port(), want)


PORTED = ("arithmetic", "rgb", "cmyk", "ycck")


@pytest.mark.parametrize("case", ["arithmetic", "lossless", "12-bit",
                                  "16-bit", "rgb", "cmyk", "ycck"])
def test_out_of_slice_streams_raise(streams, case):
    """Lossless, 12-bit and 16-bit streams raise NotImplementedError
    naming their ROADMAP.md item. The arithmetic, RGB, CMYK and YCCK
    streams, now ported, equal the JAX package instead: the RGB
    and CMYK streams here carry subsampled chroma, which the JAX
    package's null conversion refuses with a ValueError, and so does the
    port; their YUV output and the YCCK stream decode."""
    base = streams["q75_420_64x48"]
    data = {
        "arithmetic": lambda: _enc(_photo(16, 16, 8), arithmetic=True),
        "lossless": lambda: _with_sof(base, code=0xC3),
        "12-bit": lambda: _with_sof(base, precision=12),
        "16-bit": lambda: _with_sof(base, precision=16),
        "rgb": lambda: _with_sof(base, adobe=0),
        "cmyk": lambda: _with_sof(base, extra_comp=True, adobe=0),
        "ycck": lambda: _with_sof(base, extra_comp=True, adobe=2),
    }[case]()
    want_cs = {"rgb": "rgb", "cmyk": "cmyk", "ycck": "ycck"}.get(case)
    if want_cs:
        assert jdec._jpeg_colorspace(jmarker.parse(data)) == want_cs
    for port, jax in (
            (lambda: mjt.decode(data, device="cpu"),
             lambda: mj.decode(data)),
            (lambda: mjt.decode_many([base, data], device="cpu"),
             lambda: mj.decode_many([base, data])),
            (lambda: mjt.decode_many([data], output="yuv", device="cpu"),
             lambda: mj.decode_many([data], output="yuv"))):
        if case in PORTED:
            _same_result(port, jax)
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                port()


def test_out_of_slice_options_raise(streams):
    """Every decode option the earlier slices refused is ported now and
    equals the JAX package on the same stream: the ifast IDCT,
    RGB565 output, decode_scaled, decode_grayscale, decode_cropped and
    BufferedImage; an unknown output still raises ValueError."""
    data = streams["q75_420_64x48"]
    _equal_outputs(mjt.decode(data, device="cpu", dct_method="ifast"),
                   mj.decode(data, dct_method="ifast"))
    _equal_outputs(mjt.decode_many([data], output="rgb565", device="cpu"),
                   mj.decode_many([data], output="rgb565"))
    with pytest.raises(ValueError):
        mjt.decode_many([data], output="bgr", device="cpu")
    _equal_outputs(tdec.decode_scaled(data, 1, 2, device="cpu"),
                   jdec.decode_scaled(data, 1, 2))
    _equal_outputs(tdec.decode_grayscale(data, device="cpu"),
                   jdec.decode_grayscale(data))
    got, want = (tdec.decode_cropped(data, 0, 16, device="cpu"),
                 jdec.decode_cropped(data, 0, 16))
    assert got[1:] == want[1:]
    _equal_outputs(got[0], want[0])
    _equal_outputs(list(tdec.BufferedImage(data, device="cpu")),
                   list(jdec.BufferedImage(data)))
