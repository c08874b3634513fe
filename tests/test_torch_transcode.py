"""The port's codec/transcode.py (jpegtran's lossless transcode, host-only)
on the CPU against the JAX package's, byte for byte: transform() over
every operation with trim on and off, crop specs with f/r suffixes,
wipe, drop (requantized with trim and GCD-dequantized without), to
grayscale, the five -copy modes, an ICC profile, the perfect refusal and
an arithmetic source and output, on 4:2:0, 4:2:2, gray and 37x29
streams written by the port; read_coefficients against the JAX reader;
and pipeline_t.add_dummy_blocks_host against the JAX add_dummy_blocks_t."""
import jax.numpy as jnp
import numpy as np
import pytest

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import transcode as jtc
from mozjpeg_tpu.codec.config import EncoderConfig as JConfig
from mozjpeg_tpu.codec.config import Profile as JProfile
from mozjpeg_tpu.ops import layout as jlayout
from mozjpeg_tpu_torch.cli import wrjpgcom
from mozjpeg_tpu_torch.codec import pipeline, pipeline_t
from mozjpeg_tpu_torch.codec import transcode as ttc
from test_torch_decode import _photo

ICC = bytes(range(256)) * 2


def _enc(im, **kw):
    kw.setdefault("quality", 80)
    return mjt.encode(im, mjt.EncoderConfig(**kw), device="cpu")


def _with_markers(data: bytes) -> bytes:
    """An APP1 (Exif-like), an APP12 and a COM after SOI, and a second
    COM (wrjpgcom)."""
    segs = b""
    for code, payload in ((0xE1, b"Exif\x00\x00tiny"),
                          (0xEC, b"Ducky\x00\x01"), (0xFE, b"first note")):
        segs += bytes([0xFF, code, (len(payload) + 2) >> 8,
                       (len(payload) + 2) & 0xFF]) + payload
    return wrjpgcom.insert_comment(data[:2] + segs + data[2:],
                                   b"second note", False)


@pytest.fixture(scope="module")
def streams():
    img, odd = _photo(48, 64, 51), _photo(29, 37, 52)
    return {
        "420": _with_markers(_enc(img, quality=75, icc=ICC)),
        "422": _enc(img, subsampling=(2, 1), progressive=False),
        "gray": _enc(img[..., 0]),
        "odd": _enc(odd, quality=75),
        "arith": _enc(img, quality=75, arithmetic=True),
        "drop_src": _enc(_photo(16, 24, 53), quality=60),
    }


def _same(streams, name, *args, **kw):
    a = jtc.transform(streams[name], *args, **kw)
    b = ttc.transform(streams[name], *args, **kw)
    assert a == b
    return b


OPS = ["none", "flip_h", "flip_v", "transpose", "transverse", "rot90",
       "rot180", "rot270"]


@pytest.mark.parametrize("name", ["420", "odd", "gray"])
@pytest.mark.parametrize("trim", [True, False], ids=["trim", "notrim"])
def test_every_op_equals_jax(streams, name, trim):
    outs = {op: _same(streams, name, op, trim=trim) for op in OPS}
    assert len(set(outs.values())) == len(OPS)


@pytest.mark.parametrize("crop", ["32x16+16+8", "20x10+3+5", "40fx60f+8+0",
                                  "80rx48+8+0", "40x20-0-0", "16x16"])
def test_crop_specs_equal_jax(streams, crop):
    _same(streams, "odd" if crop.startswith("20") else "420", crop=crop)


@pytest.mark.parametrize("spec", ["16x16+16+16", "24fx48+16+0",
                                  "32rx48+0+0", "32rx48+32+0"])
def test_wipe_equals_jax(streams, spec):
    _same(streams, "420", "wipe", crop=spec)


@pytest.mark.parametrize("trim", [True, False], ids=["requant", "gcd"])
def test_drop_equals_jax(streams, trim):
    _same(streams, "420", trim=trim, drop=("+16+16", streams["drop_src"]))


@pytest.mark.parametrize("mode", ["none", "comments", "icc", "all",
                                  "all_except_icc"])
def test_copy_modes_equal_jax(streams, mode):
    a = jtc.write_coefficients(jtc.read_coefficients(streams["420"]),
                               copy_markers=mode)
    b = ttc.write_coefficients(ttc.read_coefficients(streams["420"]),
                               copy_markers=mode)
    assert a == b


def test_icc_after_copied_markers_equals_jax(streams):
    icc2 = bytes(range(200, 0, -1)) * 5
    a = jtc.write_coefficients(jtc.read_coefficients(streams["420"]),
                               copy_markers="all_except_icc", icc=icc2)
    b = ttc.write_coefficients(ttc.read_coefficients(streams["420"]),
                               copy_markers="all_except_icc", icc=icc2)
    assert a == b and icc2[:40] in b


@pytest.mark.parametrize("name", ["420", "422", "odd"])
def test_grayscale_equals_jax(streams, name):
    a = jtc.write_coefficients(jtc.to_grayscale(jtc.read_coefficients(
        streams[name])))
    b = ttc.write_coefficients(ttc.to_grayscale(ttc.read_coefficients(
        streams[name])))
    assert a == b


def test_perfect_refusal_like_jax(streams):
    for op in OPS:
        ok = jtc.perfect_possible(jtc.read_coefficients(streams["odd"]).jp,
                                  op)
        assert ttc.perfect_possible(ttc.read_coefficients(
            streams["odd"]).jp, op) == ok
        if not ok:
            with pytest.raises(ValueError, match="not perfect"):
                ttc.transform(streams["odd"], op, perfect=True)
    _same(streams, "420", "rot90", perfect=True)


@pytest.mark.parametrize("cfg", [
    pytest.param({}, id="jpegrescan"),
    pytest.param({"profile": "FASTEST", "progressive": False}, id="revert"),
    pytest.param({"arithmetic": True}, id="arith"),
    pytest.param({"progressive": False, "optimize_coding": True,
                  "restart_interval": 2}, id="seq-restart")])
@pytest.mark.parametrize("name", ["arith", "422"])
def test_configs_and_arith_source_equal_jax(streams, name, cfg):
    kw = dict(cfg)
    prof = kw.pop("profile", None)
    jcfg = JConfig(**kw, **({"profile": JProfile[prof]} if prof else {}))
    tcfg = mjt.EncoderConfig(
        **kw, **({"profile": mjt.Profile[prof]} if prof else {}))
    a = jtc.transform(streams[name], "rot180", config=jcfg)
    b = ttc.transform(streams[name], "rot180", config=tcfg)
    assert a == b


def test_read_coefficients_equal_jax(streams):
    for name in ("420", "arith", "odd"):
        a = jtc.read_coefficients(streams[name])
        b = ttc.read_coefficients(streams[name])
        assert len(a.planes) == len(b.planes)
        for pa, pb in zip(a.planes, b.planes):
            assert pa.dtype == pb.dtype and np.array_equal(pa, pb)
        assert a.jp.markers == b.jp.markers


@pytest.mark.parametrize("w,h,samp", [(37, 29, (2, 2)), (64, 48, (2, 2)),
                                      (33, 17, (2, 1)), (9, 40, (1, 2))])
def test_add_dummy_blocks_host_equals_jax(w, h, samp):
    rng = np.random.default_rng(54)
    for g in pipeline.geometry(w, h, [samp, (1, 1), (1, 1)])[2]:
        p = rng.integers(-900, 900, (g.bh, g.bw, 64)).astype(np.int16)
        want = np.asarray(jlayout.add_dummy_blocks_t(
            jnp.asarray(np.ascontiguousarray(p.reshape(-1, 64).T)),
            g.bw, g.bh, g.bw_pad, g.bh_pad, g.h, g.v)).T.reshape(
                g.bh_pad, g.bw_pad, 64)
        got = pipeline_t.add_dummy_blocks_host(p, g)
        assert np.array_equal(got, want)
