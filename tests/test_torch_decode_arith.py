"""The port's arithmetic decode (codec/arith.py decode_coefficients_arith)
on the CPU equals mozjpeg_tpu.codec.arith.decode_coefficients_arith:
the coefficient planes, the progression status (coef_bits and
coef_bits_prev) and last_good_imcu_row, exactly, on sequential and
progressive, gray and 4:2:0 streams, with restart intervals, with DAC
conditioning other than the default, and truncated; bogus DAC values
raise the same ValueError on both sides. Whole decodes of the same
streams equal mozjpeg_tpu.decode pixel for pixel.

The streams come from the port's own encoder (device="cpu", no JAX
compile); the non-default conditioning is written by the same encoder
with its module's L, U and Kx swapped for the stream's duration, so the
stream is valid and decodes close to its source."""
import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import arith as jarith
from mozjpeg_tpu.codec import marker as jmarker
from mozjpeg_tpu_torch.codec import arith as tarith
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import marker as tmarker
from test_torch_decode import _photo, _truncate, on_torch_render

IMG = _photo(48, 64, 31)
IMG_ODD = _photo(29, 37, 32)


def _enc(img, **kw):
    return mjt.encode(img, mjt.EncoderConfig(quality=75, **kw),
                      device="cpu")


def _enc_conditioned(img, **kw):
    """Encoded with L = 2, U = 5 for DC table 0, L = 1, U = 3 for table 1
    and Kx = 9 / 2 for AC tables 0 / 1, written in the DAC segments."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tarith, "DC_L", np.array([2, 1, 0, 0], np.uint8))
        mp.setattr(tarith, "DC_U", np.array([5, 3, 1, 1], np.uint8))
        mp.setattr(tarith, "AC_K", np.array([9, 2, 5, 5], np.uint8))
        return _enc(img, **kw)


def _dac_offsets(data: bytes):
    """[(offset of the value byte, its (cls, idx))] of every DAC entry."""
    out, pos = [], 2
    while pos < len(data) - 3:
        if data[pos] == 0xFF and data[pos + 1] == 0xCC:
            ln = (data[pos + 2] << 8) | data[pos + 3]
            for i in range(pos + 4, pos + 2 + ln, 2):
                out.append((i + 1, (data[i] >> 4, data[i] & 15)))
            pos += 2 + ln
        else:
            pos += 1
    return out


def _with_dac(data: bytes, cls: int, value: int) -> bytes:
    """Every DAC entry of class cls set to value."""
    b = bytearray(data)
    for off, (tc, _) in _dac_offsets(data):
        if tc == cls:
            b[off] = value
    return bytes(b)


@pytest.fixture(scope="module")
def streams():
    s = {
        "seq_420": _enc(IMG, arithmetic=True, progressive=False),
        "seq_gray_restart": _enc(IMG_ODD[..., 0], arithmetic=True,
                                 progressive=False, restart_interval=3),
        "seq_420_restart": _enc(IMG_ODD, arithmetic=True, progressive=False,
                                restart_interval=2),
        "prog_420": _enc(IMG, arithmetic=True),
        "prog_gray": _enc(IMG[..., 1], arithmetic=True),
        "prog_420_restart": _enc(IMG_ODD, arithmetic=True,
                                 restart_interval=2, trellis_quant=False),
        "prog_simple_script": _enc(IMG_ODD, arithmetic=True,
                                   optimize_scans=False,
                                   trellis_quant=False),
        "seq_conditioned": _enc_conditioned(IMG, arithmetic=True,
                                            progressive=False,
                                            trellis_quant=False),
        "prog_conditioned": _enc_conditioned(IMG_ODD, arithmetic=True,
                                             trellis_quant=False),
    }
    s["prog_truncated"] = _truncate(s["prog_420"], 0.6)
    return s


NAMES = ["seq_420", "seq_gray_restart", "seq_420_restart", "prog_420",
         "prog_gray", "prog_420_restart", "prog_simple_script",
         "seq_conditioned", "prog_conditioned", "prog_truncated"]


def test_inputs_cover_the_paths(streams):
    for name in NAMES:
        jp = tmarker.parse(streams[name])
        assert jp.arithmetic
        assert jp.progressive == name.startswith("prog")
        assert len(jp.scan_arith_cond) == len(jp.scans)
    assert tmarker.parse(streams["seq_420_restart"]).restart_interval == 2
    assert tmarker.parse(streams["prog_420_restart"]).restart_interval == 2
    # the conditioning really is other than the default, and honoured
    for name in ("seq_conditioned", "prog_conditioned"):
        cond = {}
        for c in tmarker.parse(streams[name]).scan_arith_cond:
            cond.update(c)
        assert cond[(0, 0)] == (5 << 4) | 2 and cond[(1, 0)] == 9
        img = IMG if name == "seq_conditioned" else IMG_ODD
        got = on_torch_render(mjt.decode, streams[name],
                              device="cpu").astype(np.float64)
        mse = np.mean((got - img) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 25.0
    # the truncated stream is one that block smoothing acts on
    jp = tmarker.parse(streams["prog_truncated"])
    tarith.decode_coefficients_arith(jp, streams["prog_truncated"])
    assert tdec._smoothing_active(jp, True)


@pytest.mark.parametrize("name", NAMES)
def test_decode_coefficients_arith_equal(streams, name):
    data = streams[name]
    jp_j, jp_t = jmarker.parse(data), tmarker.parse(data)
    assert jp_t.scan_arith_cond == jp_j.scan_arith_cond
    want = jarith.decode_coefficients_arith(jp_j, data)
    got = tarith.decode_coefficients_arith(jp_t, data)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for attr in ("coef_bits", "coef_bits_prev"):
        a, b = getattr(jp_t, attr), getattr(jp_j, attr)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert jp_t.last_good_imcu_row == jp_j.last_good_imcu_row


@pytest.mark.parametrize("name", NAMES)
def test_decode_arith_equals_jax(streams, name):
    """Pixels equal mozjpeg_tpu.decode, with block smoothing (the default)
    and without."""
    data = streams[name]
    for smooth in (True, False):
        want = mj.decode(data, block_smoothing=smooth)
        got = on_torch_render(mjt.decode, data, block_smoothing=smooth,
                              device="cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cls,value", [(0, 0x0F), (0, 0x34), (1, 0),
                                       (1, 64), (1, 255)])
def test_bogus_dac_raises_on_both_sides(streams, cls, value):
    """L > U for DC, Kx outside 1..63 for AC (jdarith.c
    JERR_DAC_VALUE)."""
    data = _with_dac(streams["prog_420"], cls, value)
    with pytest.raises(ValueError) as want:
        jarith.decode_coefficients_arith(jmarker.parse(data), data)
    with pytest.raises(ValueError) as got:
        tarith.decode_coefficients_arith(tmarker.parse(data), data)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        mjt.decode(data, device="cpu")


def test_bogus_dac_index_raises_on_both_sides(streams):
    data = streams["seq_420"]
    off, _ = _dac_offsets(data)[0]
    bad = data[:off - 1] + bytes([0x24]) + data[off:]    # class 2
    for parse in (jmarker.parse, tmarker.parse):
        with pytest.raises(ValueError, match="bogus DAC index"):
            parse(bad)
